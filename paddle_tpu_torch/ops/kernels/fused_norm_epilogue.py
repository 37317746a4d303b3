"""Fused residual + bias + norm (+ gelu) epilogue: the CUDA kernel's
wrapper, its plain PyTorch version and the autograd function.

Port of paddle_tpu/ops/pallas/fused_norm_epilogue.py, kernel
``_epilogue_kernel``. Over the last axis of x:

    r = x + sub + bias                      (x's dtype)
    y = norm(r) * gain (+ beta) (+ gelu)    (x's dtype)

``norm`` is ``"rms"`` (models/llama.py::rms_norm) or ``"layer"``
(models/gpt.py::_layer_norm, population variance; ``beta`` required);
rms ignores ``beta``, as the reference does. Every operand but x and
gain is optional. Rounding is the port's eager composition: x + sub
rounds to x's dtype, the bias is rounded to x's dtype and added,
rounding again, so r is bit-equal to it; the statistics and the norm run
in fp32 and y rounds once to x's dtype; ``act="gelu"`` applies the tanh
gelu to that y in fp32 and rounds once (aten.gelu on bf16).

The backward is composed, as the reference's: the autograd function
saves only (r, gain, beta), pulls dy back through the plain norm
expression at r, and since the adds are linear, dx = dsub = dr and
dbias = dr summed over the rows, cast to the bias's dtype.

The compiler's ``rms_epilogue`` / ``layer_epilogue`` templates place this
function; nothing calls it by hand. On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches ``csrc/fused_norm_epilogue.cu``
or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_norm_epilogue", "fused_norm_epilogue_supported",
           "norm_epilogue_fwd", "norm_epilogue_plain", "MAX_HIDDEN"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel holds a row in registers: 128 threads of at most eight
# 16-byte vectors
MAX_HIDDEN = {torch.float32: 4096, torch.bfloat16: 8192}
_fn = None


def fused_norm_epilogue_supported(n: int, h: int, dtype) -> bool:
    """The reference's gate on rows, lanes and dtypes (h % 128 == 0,
    n % 256 == 0, fp32 or bf16) with the kernel's own limit on h in
    place of the reference's VMEM term: h up to 8192 in bf16 and 4096 in
    fp32. The reference refuses bf16 rows past h 1024 (and fp32 past
    h 512), so at h 2048, for example, the port fuses where it does not."""
    return (dtype in _DTYPE_CODE and n > 0 and n % 256 == 0
            and h % 128 == 0 and 0 < h <= MAX_HIDDEN[dtype])


def _norm_plain(r, gain, beta, norm: str, eps: float, act):
    """The unfused norm term for term (llama's rms_norm, gpt's
    _layer_norm): the forward's plain version and the backward's
    differentiated expression."""
    r32 = r.float()
    if norm == "rms":
        y = r32 * torch.rsqrt((r32 * r32).mean(-1, keepdim=True) + eps)
        y = y * gain.float()
    else:
        mu = r32.mean(-1, keepdim=True)
        var = r32.var(-1, unbiased=False, keepdim=True)
        y = (r32 - mu) * torch.rsqrt(var + eps)
        y = y * gain.float() + beta.float()
    y = y.to(r.dtype)
    if act == "gelu":
        y = F.gelu(y, approximate="tanh")
    return y


def norm_epilogue_plain(x, sub, bias, gain, beta, norm: str, eps: float,
                        act=None):
    """(r, y) by the eager composition."""
    r = x
    if sub is not None:
        r = r + sub
    if bias is not None:
        r = r + bias.to(x.dtype)
    return r, _norm_plain(r, gain, beta, norm, eps, act)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.library("fused_norm_epilogue").norm_epilogue
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, P, I, P, I, P, P, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def _vector(v, h: int, device, name: str):
    """(tensor kept alive, pointer, dtype code) of an optional [h]
    vector."""
    if v is None:
        return None, 0, 0
    if v.dtype not in _DTYPE_CODE or v.shape != (h,) or v.device != device:
        raise ValueError(f"{name} {tuple(v.shape)} {v.dtype} on {v.device}: "
                         f"expected [{h}] float32 or bfloat16 on {device}")
    v = v.contiguous()
    return v, v.data_ptr(), _DTYPE_CODE[v.dtype]


def _rows(t, like, name: str):
    """t as contiguous, 16-byte aligned rows (the kernel reads 16-byte
    vectors): a strided view or one at an odd offset is copied."""
    if t.dtype != like.dtype or t.shape != like.shape or \
            t.device != like.device:
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match "
                         f"x {tuple(like.shape)} {like.dtype}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_args(x, sub, norm: str, gain, beta, act) -> None:
    if sub is not None and sub.shape != x.shape:
        raise ValueError(f"sub {tuple(sub.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if gain is None:
        raise ValueError("fused_norm_epilogue requires a gain vector")
    if norm not in ("rms", "layer"):
        raise ValueError(f"unknown norm '{norm}'")
    if norm == "layer" and beta is None:
        raise ValueError("layer norm requires beta")
    if act not in (None, "gelu"):
        raise ValueError(f"unknown act '{act}'")


def norm_epilogue_fwd(x, sub, bias, gain, beta, norm: str, eps: float,
                      act=None):
    """K6: (r, y), r being x itself when there is neither sub nor bias.
    Counts its CUDA launches in ``norm_epilogue_fwd.launches``."""
    _check_args(x, sub, norm, gain, beta, act)
    if x.device.type == "cpu":
        return norm_epilogue_plain(x, sub, bias, gain, beta, norm, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x {x.dtype}: the kernel takes float32 or bfloat16")
    h = x.shape[-1]
    n = x.numel() // h
    if h % 128 or h > MAX_HIDDEN[x.dtype]:
        raise ValueError(f"hidden {h}: the kernel takes h % 128 == 0 and h "
                         f"<= {MAX_HIDDEN[x.dtype]} in {x.dtype}")
    x = _rows(x, x, "x")
    if sub is not None:
        sub = _rows(sub, x, "sub")
    bias, pb, cb = _vector(bias, h, x.device, "bias")
    gain, pg, cg = _vector(gain, h, x.device, "gain")
    beta, pbe, cbe = _vector(beta if norm == "layer" else None, h, x.device,
                             "beta")
    has_r = sub is not None or bias is not None
    r = torch.empty_like(x) if has_r else x
    y = torch.empty_like(x)
    err = _kernel_fn()(
        x.data_ptr(), 0 if sub is None else sub.data_ptr(), pb, cb, pg, cg,
        pbe, cbe, r.data_ptr() if has_r else 0, y.data_ptr(), n, h,
        _DTYPE_CODE[x.dtype], int(norm == "layer"), int(act == "gelu"),
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "norm_epilogue")
    norm_epilogue_fwd.launches += 1
    return r, y


norm_epilogue_fwd.launches = 0


class _NormEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sub, bias, gain, beta, norm, eps, act):
        r, y = norm_epilogue_fwd(x, sub, bias, gain, beta, norm, eps, act)
        ctx.save_for_backward(r, gain, beta)
        ctx.cfg = (norm, eps, act)
        ctx.has_r = sub is not None or bias is not None
        ctx.has_sub = sub is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return (r, y) if ctx.has_r else y

    @staticmethod
    def backward(ctx, *grads):
        r, gain, beta = ctx.saved_tensors
        dr_out, dy = grads if ctx.has_r else (None, grads[0])
        with torch.enable_grad():
            rr = r.detach().requires_grad_(True)
            leaves = [rr, gain.detach().requires_grad_(True)]
            if beta is not None:
                leaves.append(beta.detach().requires_grad_(True))
            y = _norm_plain(rr, leaves[1], leaves[2] if beta is not None
                            else None, *ctx.cfg)
            got = torch.autograd.grad(y, leaves, dy, allow_unused=True)
        got = [torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, got)]
        dr = got[0] if dr_out is None else dr_out + got[0]
        dsub = dr if ctx.has_sub else None
        dbias = None
        if ctx.bias_dtype is not None:
            # the broadcast add's own reduction, then the cast's
            dbias = dr.sum(dim=tuple(range(dr.dim() - 1))).to(ctx.bias_dtype)
        dbeta = got[2] if beta is not None else None
        return dr, dsub, dbias, got[1], dbeta, None, None, None


def fused_norm_epilogue(x, sub=None, bias=None, gain=None, beta=None, *,
                        norm: str = "rms", eps: float = 1e-5, act=None):
    """Differentiable ``(r, y) = (x + sub + bias, norm(r) * gain (+ beta)
    [act])`` over arbitrary leading dims; r is x itself when there is
    neither sub nor bias."""
    out = _NormEpilogue.apply(x, sub, bias, gain, beta, norm, float(eps),
                              act)
    if sub is None and bias is None:
        return x, out
    return out
