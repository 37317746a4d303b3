"""Fused bias + tanh gelu: the CUDA kernel's wrapper, its plain PyTorch
version and the autograd function.

Port of paddle_tpu/ops/pallas/fused_bias_act.py, kernel
``_bias_gelu_kernel``: ``y = gelu_tanh(x + bias)`` over x [..., F] with
bias [F] broadcast over the rows (GPT's FFN, between the two matmuls).
Rounding is the port's eager composition ``F.gelu(x +
bias.to(x.dtype), approximate="tanh")``: the bias and the add round to
x's dtype, and the gelu runs in fp32 and rounds once (aten.gelu on bf16).

The backward is composed, as the reference's: the autograd function
saves (x, bias) and pulls dy back through that composition.

``fused_swiglu`` (the reference's K12, LLaMA's FFN) is not ported yet.

The compiler's ``bias_gelu`` template places this function; nothing calls
it by hand. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches ``csrc/fused_bias_act.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_bias_gelu", "fused_swiglu", "fused_bias_act_supported",
           "bias_gelu_fwd", "bias_gelu_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def fused_bias_act_supported(n: int, f: int, dtype) -> bool:
    """The reference's gate on rows, lanes and dtypes (f % 128 == 0,
    n % 256 == 0, fp32 or bf16). Its VMEM term is a TPU limit the
    grid-stride kernel does not have, and its single-device term guards
    GSPMD partitioning, which the one-device port does not do: both are
    dropped, so the port fuses wide FFNs the reference leaves unfused."""
    return (dtype in _DTYPE_CODE and n > 0 and n % 256 == 0
            and f > 0 and f % 128 == 0)


def bias_gelu_plain(x, bias):
    """The eager composition."""
    return F.gelu(x + bias.to(x.dtype), approximate="tanh")


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.library("fused_bias_act").bias_gelu
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, P, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


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
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
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


def fused_swiglu(gate, up):
    """K12, LLaMA's FFN gating: ported with the LLaMA-training slice."""
    raise NotImplementedError("later slice: fused_swiglu (K12)")
