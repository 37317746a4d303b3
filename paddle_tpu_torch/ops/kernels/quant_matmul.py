"""Weight-only int8 matmul with the dequant scale in the epilogue: the
CUDA kernel's wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/quant_matmul.py (kernel ``_qmm_kernel``,
plain version ``_quant_matmul_xla``): y = (x @ W) * s with x [..., K]
bf16 or fp32, W [K, N] int8, s [1, N] or [N]; y is fp32 [..., N].

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches ``csrc/quant_matmul.cu`` or raises. ``quant_matmul`` is the
registered operator ``paddle_tpu_torch::quant_matmul`` with a shape-only
fake implementation, so that the fusion compiler's trace of LLaMA's
int8 prefill records it as one node instead of reaching the launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quant_matmul", "quant_matmul_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def quant_matmul_plain(x, wq, scale) -> torch.Tensor:
    """fp32 contraction of x with the exactly converted int8 weights (the
    products of bf16 values are exact in fp32), then one scale multiply."""
    y = torch.matmul(x.float(), wq.float())
    return y * scale.reshape(-1).float()


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.library("quant_matmul").qmm_forward
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def quant_matmul(x, wq, scale) -> torch.Tensor:
    """y = (x @ wq) * scale in fp32. Counts its CUDA launches in
    ``quant_matmul.launches``."""
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
    # the kernel reads 16-byte vectors: a view at an odd offset is copied
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    if w.data_ptr() % 16:
        w = w.clone()
    s = scale.reshape(N).float().contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = _kernel_fn()(x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                       y.data_ptr(), M, K, N, _DTYPE_CODE[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qmm_forward")
    quant_matmul.launches += 1
    return y.reshape(*lead, N)


quant_matmul.launches = 0


@torch.library.custom_op("paddle_tpu_torch::quant_matmul", mutates_args=())
def _qmm_op(x: torch.Tensor, wq: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    return _qmm(x, wq, scale)


@_qmm_op.register_fake
def _(x, wq, scale):
    return x.new_empty((*x.shape[:-1], wq.shape[1]), dtype=torch.float32)
