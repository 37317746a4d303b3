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
they launch ``csrc/fused_ce.cu`` or raise. Every launch computes tiled
products (the forward one, the backward three a vocab slab); ``ce_plan``
gives each one's route, tile, ring and order, and ``PRODUCTS`` counts
them by the route the C entry reports it launched: "wgmma" (bf16, a
persistent TMA ring feeding wgmma) or "fma" (fp32, CUDA-core FMAs).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build

__all__ = ["fused_softmax_ce", "fused_ce_supported", "fused_ce_fwd",
           "fused_ce_bwd", "fused_ce_fwd_plain", "fused_ce_bwd_plain",
           "ce_plan", "ce_plan_c", "PRODUCTS"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the backward streams the vocab in slabs of this many columns: only an
# [N, SLAB] block of dlogits exists at a time
SLAB = 8192
_fns = {}

# the bf16 route's geometry (csrc/fused_ce.cu, ce_wg_kernel)
WG_BM = 128                 # rows a tile: two consumer warpgroups of 64
WG_BK = 64                  # contraction a ring stage (a 128-byte row)
WG_MAX_STAGES = 8
CE_SMEM = 232448            # shared memory a block may take (227 KB)
WG_STAGING = 2048           # dl's staging tile a consumer warp
# base alignment, mbarriers, the eight consumer warps' staging
WG_SMEM_FIXED = 1024 + 16 * WG_MAX_STAGES + 8 * WG_STAGING
# the fp32 route's (ce_fma_kernel): 128 x 128 tiles, 32-deep chunks, a
# 3-stage ring of two padded fp32 operand stages
FMA_TILE, FMA_BK, FMA_STAGES = 128, 32, 3
FMA_SMEM = 4 * 2 * FMA_STAGES * FMA_TILE * (FMA_BK + 4)
H100_SMS = 132
_PRODUCTS = ("dl", "dx", "dw", "stats")     # the C entries' product codes
_VARIANTS = ("fma", "wgmma")                # and their *variant codes
# tiled products launched, by (variant the C entry reported, dtype,
# product): "stats" is K4's, "dl", "dx", "dw" K5's (one each a slab)
PRODUCTS: collections.Counter = collections.Counter()


def _slab(V: int) -> int:
    return min(SLAB, -(-V // 128) * 128)


def _shape(N: int, H: int, V: int, product: str, v0: int) -> tuple:
    """(M, Nn, K) of C[M, Nn] = A . B^T over K: the forward's logits
    x . w^T, or the backward's dl (x . w_slab^T), dx (dl . w_slab) and dw
    (dl^T . x) of the slab at vocab v0."""
    if product == "stats":
        return N, V, H
    wc = min(_slab(V), V - v0)
    return {"dl": (N, wc, H), "dx": (N, H, wc), "dw": (wc, H, N)}[product]


def _product_plan(product: str, M: int, Nn: int, K: int, dtype,
                  sms: int) -> dict:
    if dtype != torch.bfloat16:
        tiles = -(-M // FMA_TILE) * -(-Nn // FMA_TILE)
        return {"variant": "fma", "bm": FMA_TILE, "bn": FMA_TILE,
                "bk": FMA_BK, "stages": FMA_STAGES, "smem": FMA_SMEM,
                "tiles": tiles, "grid": tiles, "raster_n": True}
    mt = -(-M // WG_BM)

    def waves(bn):          # time in units of a 128-column tile's
        return -(-mt * -(-Nn // bn) // sms) * bn

    bn = 256
    if product != "stats" and mt * -(-Nn // 256) < sms \
            and waves(128) < waves(256):
        bn = 128
    stage = (WG_BM + bn) * WG_BK * 2
    stages = min(WG_MAX_STAGES, (CE_SMEM - WG_SMEM_FIXED) // stage)
    tiles = mt * -(-Nn // bn)
    return {"variant": "wgmma", "bm": WG_BM, "bn": bn, "bk": WG_BK,
            "stages": stages, "smem": WG_SMEM_FIXED + stages * stage,
            "tiles": tiles, "grid": min(tiles, sms), "raster_n": Nn <= M}


def ce_plan(N: int, H: int, V: int, dtype=torch.bfloat16,
            sms: int = H100_SMS) -> list:
    """Every tiled product of a K4 call and a K5 call at x [N, H],
    w [V, H], in launch order: "stats" (the forward), then per vocab slab
    of ``SLAB`` columns (the last ragged) "dl", "dx" and "dw". Each entry:
    ``product``, ``v0`` (the slab's first vocab row), the product's ``M``,
    ``Nn``, ``K`` and the launch:

    - bf16, ``variant`` "wgmma": 128 x ``bn`` output tiles (256, or 128
      where 256-column tiles fill less than one wave of ``sms`` blocks
      and 128-column ones take fewer waves times their width; "stats"
      keeps 256, the layout of its partials), a TMA ring of ``stages``
      64-deep stages (as many as 227 KB holds, up to 8) in ``smem``
      bytes; ``grid`` persistent blocks (one a SM, up to
      the ``tiles``) take tile b, b + grid, ...; with ``raster_n`` the
      column tiles of a row of tiles run fastest (B, the operand every
      concurrent tile reads, is the smaller one).
    - fp32, ``variant`` "fma": 128 x 128 tiles of 32-deep chunks in a
      3-stage ring, one block a tile, column tiles fastest."""
    out = []
    for product, v0 in [("stats", 0)] + [
            (p, v0) for v0 in range(0, V, _slab(V))
            for p in ("dl", "dx", "dw")]:
        M, Nn, K = _shape(N, H, V, product, v0)
        out.append({"product": product, "v0": v0, "M": M, "Nn": Nn, "K": K,
                    **_product_plan(product, M, Nn, K, dtype, sms)})
    return out


def ce_plan_c(N: int, H: int, V: int, dtype=torch.bfloat16) -> list:
    """The plan the C launchers follow (``ce_plan_c`` in the library, on
    this device's SMs), in ce_plan's form: built on first use, for holding
    ce_plan to the source on the card."""
    fn = _fns.get("ce_plan_c")
    if fn is None:
        fn = _build.library("fused_ce").ce_plan_c
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["ce_plan_c"] = fn
    Vc = _slab(V)
    out = []
    for product, slab in [("stats", 0)] + [
            (p, s) for s in range(-(-V // Vc)) for p in ("dl", "dx", "dw")]:
        res = (ctypes.c_int * 12)()
        _build.check(fn(N, H, V, Vc, _DTYPE_CODE[dtype],
                        _PRODUCTS.index(product), slab,
                        ctypes.addressof(res)), "ce_plan_c")
        wg, bm, bn, bk, stages, smem, tiles, grid, raster, M, Nn, K = res
        out.append({"product": product,
                    "v0": 0 if product == "stats" else slab * Vc,
                    "M": M, "Nn": Nn, "K": K, "variant": _VARIANTS[wg],
                    "bm": bm, "bn": bn, "bk": bk, "stages": stages,
                    "smem": smem, "tiles": tiles, "grid": grid,
                    "raster_n": bool(raster)})
    return out


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
            fn.argtypes = [P] * 6 + [I, I, I, I, P, P]
        else:
            fn.argtypes = [P] * 9 + [I, I, I, I, I, P, P]
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


def _launch(name: str, products: tuple, dtype, *args) -> None:
    """Call C entry ``name`` with ``args`` and its trailing *variant
    out-parameter; raise on a CUDA error, else count ``products`` (names,
    with repeats) under the variant it launched."""
    variant = ctypes.c_int(-1)
    _build.check(_kernel(name)(*args, ctypes.byref(variant)), name)
    v = _VARIANTS[variant.value]
    for p in products:
        PRODUCTS[(v, str(dtype).replace("torch.", ""), p)] += 1


def fused_ce_fwd(x, head, labels):
    """K4: (nll, lse). Counts its CUDA launches in
    ``fused_ce_fwd.launches``: two, the tiled product with its statistics
    epilogue (in ``PRODUCTS`` too) and the fold."""
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, head, labels)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w, lab = _prepare(x, head, labels)
    N, H = x.shape
    V = w.shape[0]
    nll = torch.empty((N,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    # per vocab tile (256 columns in bf16, 128 in fp32) and token: (max,
    # sum-exp, gold)
    bn = 256 if x.dtype == torch.bfloat16 else FMA_TILE
    part = torch.empty((3, -(-V // bn), N), dtype=torch.float32,
                       device=x.device)
    _launch("ce_fwd", ("stats",), x.dtype, x.data_ptr(), w.data_ptr(),
            lab.data_ptr(), nll.data_ptr(), lse.data_ptr(), part.data_ptr(),
            N, H, V, _DTYPE_CODE[x.dtype], _stream(x))
    fused_ce_fwd.launches += 2
    return nll, lse


def fused_ce_bwd(x, head, labels, lse, g):
    """K5: (dx, dhead), deterministic (no atomics): three tiled products
    per vocab slab of SLAB columns. Counts its CUDA launches, three per
    slab, in ``fused_ce_bwd.launches`` and its products in ``PRODUCTS``."""
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
    slab = _slab(V)
    dl = torch.empty((N, slab), dtype=x.dtype, device=x.device)
    acc = None
    if V > slab:
        acc = torch.empty((N, H), dtype=torch.float32, device=x.device)
    slabs = -(-V // slab)
    _launch("ce_bwd", ("dl", "dx", "dw") * slabs, x.dtype,
            x.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dw.data_ptr(), dl.data_ptr(),
            0 if acc is None else acc.data_ptr(), N, H, V, slab,
            _DTYPE_CODE[x.dtype], _stream(x))
    fused_ce_bwd.launches += 3 * slabs
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
