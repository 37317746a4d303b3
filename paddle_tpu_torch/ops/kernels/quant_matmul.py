"""Weight-only int8 matmul with the dequant scale in the epilogue: the
CUDA kernel's wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/quant_matmul.py (kernel ``_qmm_kernel``,
plain version ``_quant_matmul_xla``): y = (x @ W) * s with x [..., K]
bf16 or fp32, W [K, N] int8, s [1, N] or [N]; y is fp32 [..., N].

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches ``csrc/quant_matmul.cu`` or raises. ``qmm_plan`` picks the
kernel variant and its tile from (M, K, N): bf16 x with K % 8 == 0 and
N % 16 == 0 takes the TMA + wgmma kernel (``launches_wgmma``), other
bf16 shapes the mma.sync kernel (``launches_mma``), fp32 x the CUDA-core
kernel (``launches_fma``); ``launches`` counts them all.
``quant_matmul`` is the registered operator
``paddle_tpu_torch::quant_matmul`` with a shape-only fake
implementation, so that the fusion compiler's trace of LLaMA's int8
prefill records it as one node instead of reaching the launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quant_matmul", "quant_matmul_plain", "qmm_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}

QMM_BK = 64              # K a stage
QMM_SMS = 132            # SMs of an H100 SXM
QMM_MAX_STAGES = 8       # kWgMaxStages in the source
QMM_SMEM = 232448        # shared memory a block may take (227 KB)
QMM_MIN_SPLIT_STEPS = 8  # K steps a split keeps at least


def qmm_plan(M: int, K: int, N: int,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """The kernel variant and tile for y[M, N] = x[M, K] @ W[K, N].

    ``variant``: "wgmma" for bf16 x where TMA can take the rows (K % 8
    == 0, N % 16 == 0), "mma" for other bf16 shapes, "fma" for fp32 x.
    For "wgmma": ``bm`` rows a block (256; 128, 64 or 32 for small M)
    by ``bn`` columns (128; 256 for bm <= 64, where the block's W tile is
    all its work), the ``tiles`` of bn x bm, ``splits`` of K (doubled while
    the blocks fill at most half of the SMs and each split keeps 8 K
    steps of 64) and ``stages`` of the TMA ring (as many as 227 KB holds,
    up to 8) with its ``smem`` bytes, as the source lays them out."""
    if dtype == torch.float32:
        return {"variant": "fma"}
    if K % 8 or N % 16:
        return {"variant": "mma"}
    bm = next(b for b in (32, 64, 128, 256) if M <= b or b == 256)
    bn = 256 if bm <= 64 else 128    # 2 or 1 64-row A slices a warpgroup
    tiles = -(-M // bm) * -(-N // bn)
    k_steps = -(-K // QMM_BK)
    splits = 1
    while (tiles * splits <= QMM_SMS // 2
           and k_steps // (2 * splits) >= QMM_MIN_SPLIT_STEPS):
        splits *= 2
    stage = bm * 128 + QMM_BK * bn
    fixed = 1024 + 16 * QMM_MAX_STAGES
    stages = min(QMM_MAX_STAGES, (QMM_SMEM - fixed) // stage)
    return {"variant": "wgmma", "bm": bm, "bn": bn, "tiles": tiles,
            "splits": splits, "stages": stages,
            "smem": fixed + stages * stage}


def quant_matmul_plain(x, wq, scale) -> torch.Tensor:
    """fp32 contraction of x with the exactly converted int8 weights (the
    products of bf16 values are exact in fp32), then one scale multiply."""
    y = torch.matmul(x.float(), wq.float())
    return y * scale.reshape(-1).float()


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("quant_matmul"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P, P, P, P, I, I, I, I, P] if name == "qmm_forward"
                       else [P] * 5 + [I] * 6 + [P])
        fn.restype = I
        _fns[name] = fn
    return fn


def quant_matmul(x, wq, scale) -> torch.Tensor:
    """y = (x @ wq) * scale in fp32. Counts its CUDA launches in
    ``quant_matmul.launches`` and, by variant, in ``launches_wgmma``,
    ``launches_mma`` and ``launches_fma``."""
    return _qmm_op(x, wq, scale)


def _qmm(x, wq, scale) -> torch.Tensor:
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    K, N = wq.shape
    if x.dtype not in _DTYPE_CODE or wq.dtype != torch.int8:
        raise TypeError(f"x {x.dtype} / w {wq.dtype}: the kernel takes "
                        "float32 or bfloat16 x and int8 w")
    if x.shape[-1] != K or scale.numel() != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)} do not agree")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError(f"all operands must be on {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    w = wq.contiguous()
    s = scale.reshape(N).float().contiguous()
    # the kernels read 16-byte vectors: a view at an odd offset is copied
    x2, w, s = (t.clone() if t.data_ptr() % 16 else t for t in (x2, w, s))
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = qmm_plan(M, K, N, x.dtype)
    if plan["variant"] == "wgmma":
        part = (torch.empty((plan["splits"], M, N), dtype=torch.float32,
                            device=x.device) if plan["splits"] > 1 else None)
        err = _kernel_fn("qmm_forward_wgmma")(
            x2.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), M, K, N, plan["bm"],
            plan["splits"], plan["stages"], stream)
        _build.check(err, "qmm_forward_wgmma")
    else:
        err = _kernel_fn("qmm_forward")(x2.data_ptr(), w.data_ptr(),
                                        s.data_ptr(), y.data_ptr(), M, K, N,
                                        _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "qmm_forward")
    counter = "launches_" + plan["variant"]
    setattr(quant_matmul, counter, getattr(quant_matmul, counter) + 1)
    quant_matmul.launches += 1
    return y.reshape(*lead, N)


quant_matmul.launches = 0
quant_matmul.launches_wgmma = 0
quant_matmul.launches_mma = 0
quant_matmul.launches_fma = 0


@torch.library.custom_op("paddle_tpu_torch::quant_matmul", mutates_args=())
def _qmm_op(x: torch.Tensor, wq: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    return _qmm(x, wq, scale)


@_qmm_op.register_fake
def _(x, wq, scale):
    return x.new_empty((*x.shape[:-1], wq.shape[1]), dtype=torch.float32)
