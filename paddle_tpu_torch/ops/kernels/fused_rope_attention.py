"""Flash attention with RoPE applied inside the tile (K11): the CUDA
kernel's wrapper, its plain PyTorch version and the registered operator.

Port of paddle_tpu/ops/pallas/fused_rope_attention.py (kernel
``_rope_flash_fwd_kernel``). q, k, v are [B, S, h, d] in the native
layout, q and k NOT yet rotated; ``cos``/``sin`` are the half-width angle
tables of positions 0..S-1 (anything reshapable to [S, d/2], as
models/llama.py ``rope_angles`` makes them). ``rope_q``/``rope_k`` say
which side the kernel rotates: LLaMA's GQA prefill passes the repeated,
already rotated k with ``rope_k=False`` (its rotated k escapes into the
cache and through the repeat); an MHA model rotates both.

The kernel rotates with the half-width tables as the eager
``apply_rope`` does, ``[x1 cos - x2 sin, x2 cos + x1 sin]`` with the same
roundings, so the rotated tiles are bit for bit the composition's; the
plain version is that composition: ``apply_rope`` on the chosen sides,
then the plain flash. (The backward's rotation and pullback use the
full-width tables of :func:`rope_tables`.)

The backward is the reference's (``_fused_bwd``): q and k, saved
unrotated, are rotated again in fp32 and cast back, K3 in its separate
mode (``flash_bwd_sep``) runs on the rotated operands with the forward's
saved o and lse, and the rotary pullback ``dx = dy * C - swap(dy) * S``
carries dq and dk back to the unrotated inputs; cos and sin get no
gradient. The compiler's ``rope_attention`` template places this
function. On a CPU tensor the wrappers run the plain versions; on a CUDA
tensor they launch ``csrc/fused_rope_attention.cu`` (and K3) or raise;
the kernel's variant is ``flash_attention.flash_plan``'s.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.flags import GLOBAL_FLAGS
from . import _build
from .flash_attention import (_DTYPE_CODE, _FLAG_DEFAULTS, _check_sep,
                              _count, _launch, flash_bwd_sep,
                              flash_sep_plain, flash_supported,
                              sched_scratch)

__all__ = ["fused_rope_flash_attention", "fused_rope_supported",
           "rope_tables", "rope_flash_fwd", "rope_flash_plain"]

_fn = None


def fused_rope_supported(shape, dtype) -> bool:
    """The reference's gate: the flash flags in their native-kernel
    default state, a flash-supported [B, S, h, d] and d in (128, 256)."""
    if any(GLOBAL_FLAGS.get(name) != default
           for name, default in _FLAG_DEFAULTS):
        return False
    return (len(shape) == 4 and flash_supported(shape, dtype)
            and shape[-1] in (128, 256))


def rope_tables(cos, sin, d: int):
    """Full-width fp32 tables from half-width ones (any shape ending in
    d/2): C = [cos, cos], S = [-sin, sin]."""
    cos, sin = cos.float(), sin.float()
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _apply_rope_ref(x, cos, sin):
    """Textual copy of models/llama.py ``apply_rope`` (split-half form):
    the composition the kernel is held to."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _half_tables(cos, sin, s: int, d: int):
    return (cos.reshape(s, d // 2).float(), sin.reshape(s, d // 2).float())


def rope_flash_plain(q, k, v, cos, sin, causal: bool, sm_scale: float,
                     rope_q: bool, rope_k: bool):
    """The composition: rotate the chosen sides, then the plain flash
    (o, lse)."""
    _, s, _, d = q.shape
    cos, sin = _half_tables(cos, sin, s, d)
    cb, sb = cos[None, :, None, :], sin[None, :, None, :]
    qr = _apply_rope_ref(q, cb, sb) if rope_q else q
    kr = _apply_rope_ref(k, cb, sb) if rope_k else k
    return flash_sep_plain(qr, kr, v, causal, sm_scale)


def _rotate(x, cos_f, sin_f):
    """x * C + swap(x) * S in fp32, cast back: the backward's rotation of
    the saved unrotated q or k (bit for bit apply_rope's)."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    return (x32 * cos_f + torch.cat([x2, x1], dim=-1) * sin_f).to(x.dtype)


def _rope_pullback(dy, cos_f, sin_f):
    """The rotation's VJP (S o swap = -S): dx = dy * C - swap(dy) * S in
    fp32, cast back to dy's dtype."""
    dy32 = dy.float()
    d1, d2 = dy32.chunk(2, dim=-1)
    return (dy32 * cos_f - torch.cat([d2, d1], dim=-1) * sin_f).to(dy.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.library("fused_rope_attention").rope_flash_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * 7 + [I] * 5 + [ctypes.c_float, I, I, I, P, P]
                       + [ctypes.POINTER(I)])
        fn.restype = I
        _fn = fn
    return _fn


def rope_flash_fwd(q, k, v, cos, sin, causal: bool, sm_scale: float,
                   rope_q: bool, rope_k: bool):
    """K11: (o, lse [B, h, S] fp32). Counts its CUDA launches in
    ``rope_flash_fwd.launches`` (by the variant the launcher reports:
    ``launches_wgmma`` for bf16 at head dim 128, ``launches_fma`` else,
    as ``flash_plan`` says)."""
    if q.device.type == "cpu":
        return rope_flash_plain(q, k, v, cos, sin, causal, sm_scale, rope_q,
                                rope_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (rope_q or rope_k):
        raise ValueError("rope_flash_fwd rotates q, k or both")
    B, S, h, d = _check_sep(q, k, v)
    if d not in (128, 256):
        raise ValueError(f"head dim {d}: the kernel takes 128 or 256")
    cos_h, sin_h = (t.contiguous() for t in _half_tables(cos, sin, S, d))
    if cos_h.device != q.device:
        raise ValueError(f"tables on {cos_h.device}, q on {q.device}")
    # the kernel reads the tables as 16-byte vectors
    cos_h, sin_h = (t.clone() if t.data_ptr() % 16 else t
                    for t in (cos_h, sin_h))
    o = torch.empty_like(q)
    lse = torch.empty((B, h, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sched = sched_scratch(q, stream)
    variant = _launch(
        _kernel_fn(), "rope_flash_fwd", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), cos_h.data_ptr(), sin_h.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, h, d, int(causal), float(sm_scale),
        int(rope_q), int(rope_k), _DTYPE_CODE[q.dtype], sched.data_ptr(),
        stream)
    _count(rope_flash_fwd, (B, S, h, d), q.dtype, "fwd", variant)
    return o, lse


rope_flash_fwd.launches = 0
rope_flash_fwd.launches_wgmma = rope_flash_fwd.launches_fma = 0


@torch.library.custom_op("paddle_tpu_torch::rope_flash_fwd", mutates_args=())
def _rope_flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, causal: bool,
                   sm_scale: float, rope_q: bool, rope_k: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    o, lse = rope_flash_fwd(q, k, v, cos, sin, causal, sm_scale, rope_q,
                            rope_k)
    return o.contiguous(), lse.contiguous()


@_rope_flash_op.register_fake
def _(q, k, v, cos, sin, causal, sm_scale, rope_q, rope_k):
    B, S, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, h, S), dtype=torch.float32))


def _rope_flash_setup(ctx, inputs, output):
    q, k, v, cos, sin, causal, sm_scale, rope_q, rope_k = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, cos, sin, o, lse)
    ctx.args = (causal, sm_scale, rope_q, rope_k)
    ctx.mark_non_differentiable(lse)


def _rope_flash_backward(ctx, do, _dlse):
    """Rotate the saved q/k again, K3 on the rotated operands, then the
    rotary pullback on dq/dk (reference ``_fused_bwd``)."""
    q, k, v, cos, sin, o, lse = ctx.saved_tensors
    causal, scale, rope_q, rope_k = ctx.args
    _, S, _, d = q.shape
    cos_f, sin_f = rope_tables(*_half_tables(cos, sin, S, d), d)
    cb, sb = cos_f[None, :, None, :], sin_f[None, :, None, :]
    qr = _rotate(q, cb, sb) if rope_q else q
    kr = _rotate(k, cb, sb) if rope_k else k
    dq, dk, dv = flash_bwd_sep(qr, kr, v, o, lse, do, causal, scale)
    if rope_q:
        dq = _rope_pullback(dq, cb, sb)
    if rope_k:
        dk = _rope_pullback(dk, cb, sb)
    return dq, dk, dv, None, None, None, None, None, None


_rope_flash_op.register_autograd(_rope_flash_backward,
                                 setup_context=_rope_flash_setup)


def fused_rope_flash_attention(q, k, v, cos, sin, causal: bool = True,
                               sm_scale: float | None = None,
                               rope_q: bool = True,
                               rope_k: bool = True) -> torch.Tensor:
    """Flash attention over unrotated q (and k) with RoPE in the tile."""
    if not fused_rope_supported(q.shape, q.dtype):
        raise ValueError(f"fused_rope_flash_attention: shape "
                         f"{tuple(q.shape)} {q.dtype} is not supported")
    scale = sm_scale if sm_scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _rope_flash_op(q.contiguous(), k.contiguous(), v.contiguous(),
                          cos, sin, bool(causal), float(scale), bool(rope_q),
                          bool(rope_k))[0]
