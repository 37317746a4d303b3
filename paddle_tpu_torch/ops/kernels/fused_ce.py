"""Vocab-streaming softmax cross-entropy: the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd function.

Port of paddle_tpu/ops/pallas/fused_ce.py: forward ``_fwd_kernel``,
backward ``_bwd_dx_kernel`` and ``_bwd_dh_kernel``. Per token, the
[N, V] logits of x [N, H] @ head [H, V] never exist in device memory:
vocab tiles stream through the kernel with an online max and sum-exp.

- forward: nll = lse - gold and lse, both fp32 [N].
- backward: dl = (softmax - onehot) * g recomputed from the saved lse
  and cast to x's dtype; dx = dl @ head^T accumulated in fp32 over vocab
  tiles, dhead = x^T @ dl accumulated in fp32 over token tiles, cast to
  x's and head's dtypes. The vocab goes in slabs of SLAB columns, so at
  most an [N, SLAB] block of dl is held in device memory.

The kernels read the head through its transpose w [V, H], one vocab row
per logit column. For GPT's tied head (``wte.T``) that transpose is
``wte`` itself and nothing is copied; another layout is made contiguous
once per call.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch ``csrc/fused_ce.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_softmax_ce", "fused_ce_supported", "fused_ce_fwd",
           "fused_ce_bwd", "fused_ce_fwd_plain", "fused_ce_bwd_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the backward streams the vocab in slabs of this many columns: only an
# [N, SLAB] block of dlogits exists at a time
SLAB = 8192
_fns = {}


def fused_ce_supported(n_tokens: int, hidden: int, vocab: int,
                       dtype=torch.bfloat16) -> bool:
    """The CUDA kernels' conditions: fp32 or bf16, H a multiple of 128
    (whole output tiles of dx and dhead), V a multiple of 8 (16-byte rows
    of the dlogits slab); any N (ragged token tiles are masked)."""
    return (dtype in _DTYPE_CODE and n_tokens > 0 and vocab > 0
            and vocab % 8 == 0 and hidden % 128 == 0)


def _logits(x, head):
    return torch.matmul(x.float(), head.float())


def fused_ce_fwd_plain(x, head, labels):
    """(nll, lse) fp32 [N] from the whole fp32 logit matrix."""
    logits = _logits(x, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - gold, lse


def fused_ce_bwd_plain(x, head, labels, lse, g):
    """(dx, dhead) in x's and head's dtypes, dl cast to x's dtype before
    both products, as the kernels."""
    logits = _logits(x, head)
    dl = torch.exp(logits - lse[:, None])
    del logits
    dl.scatter_add_(1, labels.long()[:, None],
                    torch.full_like(lse[:, None], -1.0))
    dl = (dl * g.float()[:, None]).to(x.dtype).float()
    dx = torch.matmul(dl, head.float().t()).to(x.dtype)
    dh = torch.matmul(x.float().t(), dl).to(head.dtype)
    return dx, dh


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("fused_ce"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "ce_fwd":
            fn.argtypes = [P] * 6 + [I, I, I, I, P]
        else:
            fn.argtypes = [P] * 9 + [I, I, I, I, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _prepare(x, head, labels):
    """Check the operands and return (w [V, H], labels int32)."""
    if x.dtype not in _DTYPE_CODE or head.dtype != x.dtype:
        raise TypeError(f"x {x.dtype} / head {head.dtype}: the kernels take "
                        "float32 or bfloat16, one dtype for both")
    N, H = x.shape
    if head.dim() != 2 or head.shape[0] != H or labels.shape != (N,):
        raise ValueError(f"x {tuple(x.shape)}, head {tuple(head.shape)}, "
                         f"labels {tuple(labels.shape)} do not agree")
    if not fused_ce_supported(N, H, head.shape[1], x.dtype):
        raise ValueError(f"hidden {H} / vocab {head.shape[1]}: the "
                         "kernels take H % 128 == 0 and V % 8 == 0")
    w = head.t()
    if not w.is_contiguous():
        w = w.contiguous()
    lab = labels.to(torch.int32).contiguous()
    for t in (x, w, lab):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{x.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return w, lab


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd(x, head, labels):
    """K4: (nll, lse). Counts its CUDA launches in
    ``fused_ce_fwd.launches``: two, the tiled product with its statistics
    epilogue and the fold."""
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, head, labels)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w, lab = _prepare(x, head, labels)
    N, H = x.shape
    V = w.shape[0]
    nll = torch.empty((N,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    # per 128-column vocab tile and token: (max, sum-exp, gold)
    part = torch.empty((3, -(-V // 128), N), dtype=torch.float32,
                       device=x.device)
    err = _kernel("ce_fwd")(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                            nll.data_ptr(), lse.data_ptr(), part.data_ptr(),
                            N, H, V, _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(err, "ce_fwd")
    fused_ce_fwd.launches += 2
    return nll, lse


def fused_ce_bwd(x, head, labels, lse, g):
    """K5: (dx, dhead), deterministic (no atomics): three tiled products
    per vocab slab of SLAB columns. Counts its CUDA launches, three per
    slab, in ``fused_ce_bwd.launches``."""
    if x.device.type == "cpu":
        return fused_ce_bwd_plain(x, head, labels, lse, g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w, lab = _prepare(x, head, labels)
    N, H = x.shape
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    if lse.shape != (N,) or g.shape != (N,) or lse.device != x.device \
            or g.device != x.device:
        raise ValueError(f"lse {tuple(lse.shape)} / g {tuple(g.shape)} do "
                         f"not match {N} tokens on {x.device}")
    V = w.shape[0]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    slab = min(SLAB, -(-V // 128) * 128)
    dl = torch.empty((N, slab), dtype=x.dtype, device=x.device)
    acc = None
    if V > slab:
        acc = torch.empty((N, H), dtype=torch.float32, device=x.device)
    err = _kernel("ce_bwd")(
        x.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw.data_ptr(), dl.data_ptr(),
        0 if acc is None else acc.data_ptr(), N, H, V, slab,
        _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(err, "ce_bwd")
    fused_ce_bwd.launches += 3 * -(-V // slab)
    return dx, dw.t()


fused_ce_fwd.launches = 0
fused_ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, labels):
        nll, lse = fused_ce_fwd(x, head, labels)
        ctx.save_for_backward(x, head, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, head, labels, lse = ctx.saved_tensors
        dx, dh = fused_ce_bwd(x, head, labels, lse, g)
        return dx, dh, None


def fused_softmax_ce(x, head, labels) -> torch.Tensor:
    """Per-token cross-entropy nll [N] (fp32) of softmax(x @ head) against
    ``labels``, differentiable in x [N, H] and head [H, V]."""
    return _FusedCE.apply(x, head, labels)
