"""Fused FFN activations: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd functions.

Port of paddle_tpu/ops/pallas/fused_bias_act.py:

- K7, ``_bias_gelu_kernel``: ``y = gelu_tanh(x + bias)`` over x [..., F]
  with bias [F] broadcast over the rows (GPT's FFN, between the two
  matmuls). Rounding is the port's eager composition ``F.gelu(x +
  bias.to(x.dtype), approximate="tanh")``: the bias and the add round to
  x's dtype, and the gelu runs in fp32 and rounds once (aten.gelu on
  bf16).
- K12, ``_swiglu_kernel``: ``y = silu(gate.float()).to(dtype) * up`` over
  gate and up [..., F] (LLaMA's FFN, between the gate/up and the down
  projections): silu in fp32, rounded back, the product in the input
  dtype.

The backwards are composed, as the reference's: each autograd function
saves its inputs and pulls dy back through the plain composition.

The compiler's ``bias_gelu`` and ``swiglu`` templates place these
functions; nothing calls them by hand. On a CPU tensor a wrapper runs the
plain version; on a CUDA tensor it launches ``csrc/fused_bias_act.cu`` or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_bias_gelu", "fused_swiglu", "fused_bias_act_supported",
           "bias_gelu_fwd", "bias_gelu_plain", "swiglu_fwd", "swiglu_plain",
           "bias_gelu_plan", "bias_gelu_plan_c"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}
# K7's walk (csrc/fused_bias_act.cu, bias_gelu_kernel)
THREADS = 256               # threads a block
UNROLL = 4                  # 16-byte loads in flight a thread
WAVES = 8                   # blocks a launch, in units of the card's fill


def bias_gelu_plan(n: int, f: int, itemsize: int, resident: int) -> dict:
    """K7's 2-D walk over x [n, f] of ``itemsize``-byte elements, on a
    card that holds ``resident`` blocks at once (``bias_gelu_plan_c``
    reports the card's). A 16-byte ``vec`` of a row is one thread's
    column; a block covers ``cols`` of them (up to 256) on ``rows`` rows
    (256 // cols); ``grid[0]`` blocks span a row and ``grid[1]`` walk the
    rows:
    thread (tr, tc) of block (bx, by) owns column vector bx cols + tc of
    rows by rows + tr + j grid[1] rows (threads past the row or past
    rows x cols idle), ``unroll`` rows' loads in flight at a time.
    ``grid[1]`` is ``WAVES`` times what the card holds, spread over the
    row's column blocks, up to one pass of ``unroll`` rows a thread."""
    vec = 16 // itemsize
    vecs = f // vec
    cols = min(vecs, THREADS)
    rows = THREADS // cols
    gx = -(-vecs // cols)
    gy = max(1, min(WAVES * resident // gx, -(-n // (rows * UNROLL))))
    return {"vec": vec, "cols": cols, "rows": rows, "grid": (gx, gy),
            "unroll": UNROLL, "resident": resident}


def bias_gelu_plan_c(n: int, f: int, dtype=torch.bfloat16,
                     bias_dtype=torch.float32) -> dict:
    """The walk the C launcher takes (``bias_gelu_plan_c`` in the
    library) in bias_gelu_plan's form: for holding it to the source on
    the card."""
    fn = _fns.get("bias_gelu_plan_c")
    if fn is None:
        fn = _build.library("fused_bias_act").bias_gelu_plan_c
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["bias_gelu_plan_c"] = fn
    out = (ctypes.c_int * 6)()
    _build.check(fn(n, f, _DTYPE_CODE[dtype], _DTYPE_CODE[bias_dtype],
                    ctypes.addressof(out)), "bias_gelu_plan_c")
    cols, rows, gx, gy, unroll, resident = out
    return {"vec": 16 // torch.empty((), dtype=dtype).element_size(),
            "cols": cols, "rows": rows, "grid": (gx, gy), "unroll": unroll,
            "resident": resident}


def fused_bias_act_supported(n: int, f: int, dtype) -> bool:
    """The reference's gate on rows, lanes and dtypes (f % 128 == 0,
    n % 256 == 0, fp32 or bf16). Its VMEM term is a TPU limit the
    grid-stride kernel does not have, and its single-device term guards
    GSPMD partitioning, which the one-device port does not do: both are
    dropped, so the port fuses wide FFNs the reference leaves unfused
    (LLaMA's f 5504 and 14336 in bf16, which the VMEM term refuses)."""
    return (dtype in _DTYPE_CODE and n > 0 and n % 256 == 0
            and f > 0 and f % 128 == 0)


def bias_gelu_plain(x, bias):
    """The eager composition."""
    return F.gelu(x + bias.to(x.dtype), approximate="tanh")


def swiglu_plain(gate, up):
    """The eager composition."""
    return F.silu(gate.float()).to(gate.dtype) * up


def _kernel_fn(name: str = "bias_gelu"):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("fused_bias_act"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P, P, I, P, I, I, I, P] if name == "bias_gelu"
                       else [P, P, P, I, I, I, P])
        fn.restype = I
        _fns[name] = fn
    return fn


def _vectors(t):
    """t as a contiguous, 16-byte aligned tensor (the kernels read 16-byte
    vectors of one row)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def bias_gelu_fwd(x, bias):
    """K7: y. Counts its CUDA launches in ``bias_gelu_fwd.launches``."""
    if x.device.type == "cpu":
        return bias_gelu_plain(x, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    f = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"x {x.dtype} / bias {bias.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if bias.shape != (f,) or bias.device != x.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    if f % 8:
        raise ValueError(f"width {f}: the kernel reads 16-byte vectors of "
                         "one row (f % 8 == 0)")
    x = _vectors(x)
    bias = bias.contiguous()
    y = torch.empty_like(x)
    err = _kernel_fn()(x.data_ptr(), bias.data_ptr(), _DTYPE_CODE[bias.dtype],
                       y.data_ptr(), x.numel() // f, f, _DTYPE_CODE[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bias_gelu")
    bias_gelu_fwd.launches += 1
    return y


bias_gelu_fwd.launches = 0


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_gelu_fwd(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            bb = bias.detach().requires_grad_(True)
            dx, db = torch.autograd.grad(bias_gelu_plain(xx, bb), (xx, bb),
                                         dy)
        return dx, db


def fused_bias_gelu(x, bias):
    """Differentiable ``gelu_tanh(x + bias)`` over arbitrary leading dims."""
    if bias.shape != (x.shape[-1],):
        raise ValueError(f"bias must be [{x.shape[-1]}], got "
                         f"{tuple(bias.shape)}")
    return _BiasGelu.apply(x, bias)


def swiglu_fwd(gate, up):
    """K12: y. Counts its CUDA launches in ``swiglu_fwd.launches``."""
    if gate.device.type == "cpu":
        return swiglu_plain(gate, up)
    if gate.device.type != "cuda":
        raise ValueError(f"unsupported device {gate.device}")
    if gate.dtype not in _DTYPE_CODE or up.dtype != gate.dtype:
        raise TypeError(f"gate {gate.dtype} / up {up.dtype}: the kernel "
                        "takes float32 or bfloat16, both alike")
    if up.shape != gate.shape or up.device != gate.device:
        raise ValueError(f"up {tuple(up.shape)} on {up.device} does not "
                         f"match gate {tuple(gate.shape)} on {gate.device}")
    f = gate.shape[-1]
    if f % 8:
        raise ValueError(f"width {f}: the kernel reads 16-byte vectors of "
                         "one row (f % 8 == 0)")
    gate, up = _vectors(gate), _vectors(up)
    y = torch.empty_like(gate)
    err = _kernel_fn("swiglu")(
        gate.data_ptr(), up.data_ptr(), y.data_ptr(), gate.numel() // f, f,
        _DTYPE_CODE[gate.dtype],
        torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "swiglu")
    swiglu_fwd.launches += 1
    return y


swiglu_fwd.launches = 0


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu_fwd(gate, up)

    @staticmethod
    def backward(ctx, dy):
        gate, up = ctx.saved_tensors
        with torch.enable_grad():
            gg = gate.detach().requires_grad_(True)
            uu = up.detach().requires_grad_(True)
            dg, du = torch.autograd.grad(swiglu_plain(gg, uu), (gg, uu), dy)
        return dg, du


def fused_swiglu(gate, up):
    """Differentiable ``silu(gate.float()).to(dtype) * up`` over arbitrary
    leading dims: K12 forward, the composed backward."""
    if gate.shape != up.shape:
        raise ValueError(f"gate/up shape mismatch: {tuple(gate.shape)} vs "
                         f"{tuple(up.shape)}")
    return _Swiglu.apply(gate, up)
