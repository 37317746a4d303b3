"""Causal flash attention: the CUDA kernels' wrappers, their plain
PyTorch versions and the differentiable operators.

Port of paddle_tpu/ops/pallas/flash_attention.py, native layout, two
entries:

- ``flash_attention_qkv_raw`` on the fused qkv projection (GPT): forward
  ``_flash_fwd_kernel_native``, backward ``_flash_bwd_fused_kernel_native``
  (the merged dq + dk/dv kernel that writes one dqkv cotangent);
- ``flash_attention_raw`` on separate q, k, v [B, S, h, d] (LLaMA's
  prefill): the same forward kernel given three base pointers and row
  strides (K1's separate-input mode, ``flash_fwd_sep``). Its backward is
  the LLaMA-training slice's and raises here.

- qkv [B, S, 3*h*d]: q, k and v at lane offsets 0, h*d and 2*h*d, head
  j at j*d inside each; read in place, never split into copies.
- forward: o [B, S, h, d] in qkv's dtype and lse [B, h, S] fp32.
  s = (q k^T) * sm_scale in fp32, causal fill -1e30, p = exp(s - m) with
  l summed over the fp32 p, p cast to the input dtype before p v,
  o = acc / l, lse = m + log(l).
- backward: dqkv [B, S, 3*h*d]. p = exp(s - lse) (masked 0),
  dp = do v^T, ds = p (dp - delta) cast to the input dtype,
  dq = ds k * scale, dk = ds^T q * scale, dv = p^T do with p cast;
  delta = rowsum(do * o) in fp32 is computed here, outside the kernel.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch ``csrc/flash_attention.cu`` or raise. The differentiable
entry ``flash_attention_qkv`` is the registered operator pair
``paddle_tpu_torch::flash_qkv_fwd`` / ``flash_qkv_bwd`` (K2 as the
forward's registered backward), and ``flash_attention_raw`` the
registered operator ``paddle_tpu_torch::flash_fwd_sep``, so that the
fusion compiler's trace records each as one node, with shape-only fake
implementations (the ``rope_attention`` template finds the separate entry
by its operator).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.flags import GLOBAL_FLAGS
from . import _build

__all__ = ["flash_attention_qkv", "flash_qkv_supported", "flash_fwd",
           "flash_bwd", "flash_fwd_plain", "flash_bwd_plain",
           "flash_attention_raw", "flash_supported", "flash_fwd_sep",
           "flash_sep_plain"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLAG_DEFAULTS = (("flash_attention_kernel_bwd", True),
                  ("flash_attention_native_layout", True),
                  ("use_library_flash_attention", False))
_fns = {}


def _check_flags() -> None:
    """The XLA-expression backward, the head-major kernels and a library
    kernel are paths of a later slice: refuse them rather than run this
    one under their names."""
    for name, default in _FLAG_DEFAULTS:
        if GLOBAL_FLAGS.get(name) != default:
            raise NotImplementedError(
                f"later slice: FLAGS_{name}={GLOBAL_FLAGS.get(name)} (only "
                f"{default} is ported)")


def flash_qkv_supported(shape, n_heads: int, dtype) -> bool:
    """The reference's gate for the fused entry: [B, S, 3*h*d] with S a
    multiple of 128, d in (64, 128, 256) and h even for d 64 (its
    128-lane head pairs), and fp32 or bf16, the dtypes the kernels
    take. Raises while a flash flag is off its default."""
    _check_flags()
    if len(shape) != 3 or shape[2] % (3 * n_heads):
        return False
    d = shape[2] // (3 * n_heads)
    hp = max(1, 128 // d)
    return (shape[1] % 128 == 0 and shape[1] >= 128
            and d in SUPPORTED_HEAD_DIMS and n_heads % hp == 0
            and dtype in _DTYPE_CODE)


def flash_supported(shape, dtype) -> bool:
    """The reference's gate for the separate entry (``supported``): [B, S,
    h, d] with S a multiple of 128 and d in (64, 128, 256), and fp32 or
    bf16, the dtypes the kernel takes. Raises while a flash flag is off
    its default."""
    _check_flags()
    return (len(shape) == 4 and shape[1] % 128 == 0 and shape[1] >= 128
            and shape[3] in SUPPORTED_HEAD_DIMS and dtype in _DTYPE_CODE)


def _split(qkv: torch.Tensor, n_heads: int):
    B, S, H3 = qkv.shape
    H = H3 // 3
    d = H // n_heads
    return [qkv[..., i * H:(i + 1) * H].reshape(B, S, n_heads, d).float()
            for i in range(3)]


def _mask(S: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def _fwd_plain(q, k, v, dt, causal: bool, sm_scale: float):
    """(o [B, S, h, d] in ``dt``, lse [B, h, S] fp32) from fp32 q, k, v by
    one masked softmax over the whole sequence, with the kernel's cast
    points."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if causal:
        s = torch.where(_mask(s.shape[-1], s.device), s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                    # [B, h, S]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v)
    o = (acc / l.transpose(1, 2)[..., None]).to(dt)
    return o, m[..., 0] + torch.log(l)


def flash_fwd_plain(qkv, n_heads: int, causal: bool, sm_scale: float):
    """(o [B, S, h, d], lse [B, h, S] fp32) of the fused qkv."""
    return _fwd_plain(*_split(qkv, n_heads), qkv.dtype, causal, sm_scale)


def flash_sep_plain(q, k, v, causal: bool, sm_scale: float):
    """o [B, S, h, d] of separate q, k, v [B, S, h, d]."""
    return _fwd_plain(q.float(), k.float(), v.float(), q.dtype, causal,
                      sm_scale)[0]


def flash_bwd_plain(qkv, o, lse, do, n_heads: int, causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """dqkv [B, S, 3*h*d] in qkv's dtype, from the saved o and lse."""
    dt = qkv.dtype
    B, S, H3 = qkv.shape
    q, k, v = _split(qkv, n_heads)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, h, S]
    do_ = do.to(dt).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_mask(S, p.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_, v)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do_)
    return torch.cat([t.reshape(B, S, H3 // 3) for t in (dq, dk, dv)],
                     dim=-1).to(dt)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        n_ptr = 3 if name == "flash_fwd" else 5
        fn.argtypes = [P] * n_ptr + [I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _check_cuda(qkv, n_heads: int, *others) -> tuple[int, int, int, int]:
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv dtype {qkv.dtype}: the kernels take float32 "
                        "or bfloat16")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * n_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3*h*d] for "
                         f"{n_heads} heads")
    B, S, H3 = qkv.shape
    d = H3 // (3 * n_heads)
    if d not in SUPPORTED_HEAD_DIMS or S % 64:
        raise ValueError(f"head dim {d} / seq {S}: the kernels take d in "
                         f"{SUPPORTED_HEAD_DIMS} and S % 64 == 0")
    for t in (qkv, *others):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{qkv.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return B, S, n_heads, d


def flash_fwd(qkv, n_heads: int, causal: bool, sm_scale: float):
    """K1: (o, lse). Counts its CUDA launches in ``flash_fwd.launches``."""
    if qkv.device.type == "cpu":
        return flash_fwd_plain(qkv, n_heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, h, d = _check_cuda(qkv, n_heads)
    o = torch.empty((B, S, h, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, h, S), dtype=torch.float32, device=qkv.device)
    err = _kernel("flash_fwd")(
        qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, h, d,
        int(causal), float(sm_scale), _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd(qkv, o, lse, do, n_heads: int, causal: bool,
              sm_scale: float) -> torch.Tensor:
    """K2: dqkv, deterministic (no atomics). Counts its CUDA launches in
    ``flash_bwd.launches``."""
    if qkv.device.type == "cpu":
        return flash_bwd_plain(qkv, o, lse, do, n_heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, h, d = _check_cuda(qkv, n_heads, lse)
    if o.shape != (B, S, h, d) or do.shape != (B, S, h, d) or \
            lse.shape != (B, h, S) or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} / lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match qkv "
                         f"{tuple(qkv.shape)}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    do_ = do.to(qkv.dtype).contiguous()
    _check_cuda(qkv, n_heads, do_, delta)
    dqkv = torch.empty_like(qkv)
    err = _kernel("flash_bwd")(
        qkv.data_ptr(), do_.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), B, S, h, d, int(causal), float(sm_scale),
        _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "flash_bwd")
    flash_bwd.launches += 1
    return dqkv


def flash_fwd_sep(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """K1 in its separate-input mode: o of q, k, v [B, S, h, d]. Counts
    its CUDA launches in ``flash_fwd_sep.launches``."""
    if q.device.type == "cpu":
        return flash_sep_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, h, d = _check_sep(q, k, v)
    o = torch.empty_like(q)
    err = _kernel("flash_fwd_sep")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, B, S,
        h, d, int(causal), float(sm_scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_sep")
    flash_fwd_sep.launches += 1
    return o


def _check_sep(q, k, v) -> tuple[int, int, int, int]:
    """The separate-input kernels' operand rules (shared with K11)."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype} / k {k.dtype} / v {v.dtype}: the "
                        "kernels take float32 or bfloat16, all alike")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want three [B, S, h, d]")
    B, S, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS or S % 64:
        raise ValueError(f"head dim {d} / seq {S}: the kernels take d in "
                         f"{SUPPORTED_HEAD_DIMS} and S % 64 == 0")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q, k, v must be contiguous and on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return B, S, h, d


flash_fwd.launches = 0
flash_bwd.launches = 0
flash_fwd_sep.launches = 0


# The fused-qkv entry is a pair of registered operators, so that the
# fusion compiler's trace (torch.fx make_fx) records each as one node on
# any device: the fake implementations give shapes only, the real ones
# are the wrappers above (plain version on the CPU, K1/K2 on CUDA).

@torch.library.custom_op("paddle_tpu_torch::flash_qkv_fwd", mutates_args=())
def _flash_qkv_fwd_op(qkv: torch.Tensor, n_heads: int, causal: bool,
                      sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    # contiguous, as the fake implementation says: a trace turns the
    # caller's reshape of o into a view
    o, lse = flash_fwd(qkv, n_heads, causal, sm_scale)
    return o.contiguous(), lse.contiguous()


@_flash_qkv_fwd_op.register_fake
def _(qkv, n_heads, causal, sm_scale):
    B, S, H3 = qkv.shape
    d = H3 // (3 * n_heads)
    return (qkv.new_empty((B, S, n_heads, d)),
            qkv.new_empty((B, n_heads, S), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_qkv_bwd", mutates_args=())
def _flash_qkv_bwd_op(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor, n_heads: int, causal: bool,
                      sm_scale: float) -> torch.Tensor:
    return flash_bwd(qkv, o, lse, do, n_heads, causal, sm_scale)


@_flash_qkv_bwd_op.register_fake
def _(qkv, o, lse, do, n_heads, causal, sm_scale):
    return torch.empty_like(qkv)


def _flash_qkv_setup(ctx, inputs, output):
    qkv, n_heads, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(qkv, o, lse)
    ctx.args = (n_heads, causal, sm_scale)
    ctx.mark_non_differentiable(lse)


def _flash_qkv_backward(ctx, do, _dlse):
    qkv, o, lse = ctx.saved_tensors
    return _flash_qkv_bwd_op(qkv, o, lse, do, *ctx.args), None, None, None


_flash_qkv_fwd_op.register_autograd(_flash_qkv_backward,
                                    setup_context=_flash_qkv_setup)


def flash_attention_qkv(qkv, n_heads: int, causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Differentiable attention straight from the fused qkv projection:
    [B, S, 3*h*d] -> [B, S, h, d]; K1 forward, K2 backward."""
    if not flash_qkv_supported(qkv.shape, n_heads, qkv.dtype):
        raise ValueError(f"flash_attention_qkv: shape {tuple(qkv.shape)} "
                         f"{qkv.dtype} with {n_heads} heads is not supported")
    d = qkv.shape[-1] // (3 * n_heads)
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    return _flash_qkv_fwd_op(qkv.contiguous(), n_heads, bool(causal),
                             float(scale))[0]


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_sep", mutates_args=())
def _flash_sep_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float) -> torch.Tensor:
    return flash_fwd_sep(q, k, v, causal, sm_scale).contiguous()


@_flash_sep_op.register_fake
def _(q, k, v, causal, sm_scale):
    return torch.empty_like(q)


def _flash_sep_backward(ctx, do):
    raise NotImplementedError("later slice: LLaMA training (the backward "
                              "of flash_attention_raw)")


_flash_sep_op.register_autograd(_flash_sep_backward)


def flash_attention_raw(q, k, v, causal: bool = False,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Attention on separate q, k, v [B, S, h, d] in the native layout:
    K1's separate-input mode on CUDA, its plain version on the CPU. The
    forward only: differentiating it raises (LLaMA training is a later
    slice)."""
    if not flash_supported(q.shape, q.dtype):
        raise ValueError(f"flash_attention_raw: shape {tuple(q.shape)} "
                         f"{q.dtype} is not supported")
    scale = sm_scale if sm_scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _flash_sep_op(q.contiguous(), k.contiguous(), v.contiguous(),
                         bool(causal), float(scale))
