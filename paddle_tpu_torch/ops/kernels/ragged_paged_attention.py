"""Unified ragged paged attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of paddle_tpu/ops/pallas/ragged_paged_attention.py (kernel
``_rpa_kernel``, plain version ``_ragged_paged_xla``), d-major k pages.

- q [C, qb, nH, d]: C chunks of qb query tokens; chunk c holds tokens at
  positions [pos0[c], pos0[c] + n_valid[c]) of one request, rows
  i >= n_valid[c] are padding.
- k_pages [P, nKV, d, bs] (d-major), v_pages [P, nKV, bs, d]; the chunk's
  own k/v are already written (write-before-attend).
- rows [C, max_blocks], pos0 [C], n_valid [C] int32.

- k_scales / v_scales [P, nKV] fp32: int8 pages (``serving_kv_quant``,
  K8q, the reference kernel's ``quant=True``) need both; each page tile
  is dequantized as ``ops/quant.py::dequantize_int8`` does (fp32 multiply
  by its page's scale, cast to q's dtype) before the dots.

Query row i attends keys kpos <= pos0 + min(i, n_valid - 1), so padding
rows repeat the last valid row. Returns o [C, qb, nH, d] in q's dtype.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch ``csrc/ragged_paged_attention.cu`` (``rpa_forward`` for fp pages,
``rpa_forward_int8`` for int8 pages) or raise. ``rpa_plan`` is the launch
a geometry takes, a function of (mb, bs, d, G, qb, dtype, quant) alone:

- "wgmma" (bf16, d 64 or 128, bs a multiple of 64: the engine's route):
  the context of a (chunk, kv head) is cut by key position into splits of
  ``pages_per_split`` pages, one block each, the splits one thread-block
  cluster of at most 8. A block streams its split's 64-key tiles through
  a ring of TMA loads (k and v boxes in the 128-byte swizzle; K8q's int8
  boxes unswizzled, dequantized by the block into one bf16 tile) and
  runs q k^T and p v as ``wgmma`` on its 64 query rows; the active
  splits combine (m, l, acc) in split order through distributed shared
  memory. A split wholly past the chunk's last key loads nothing and adds
  nothing, and a split with no key of a row adds weight exp(-1e30 - M) =
  0, so a row's bits depend only on its own position and keys, not on the
  chunk that carries it (the verify ladder and the sampled streams'
  independence of chunking rely on that).
- "mma" (bf16, d 64 or 128, bs 16, 32 or 48 a page): the mma.sync kernel,
  one block a (chunk, kv head, 64 rows) over all its pages.
- "fma" (fp32; bf16 at d 256): the CUDA-core kernel.

Each C entry reports the variant it launched; the wrappers count it in
``LAUNCHES_BY_PLAN`` by (variant, dtype, d, bs, mb, G, qb, quant), and
``rpa_plan_c`` returns the C launcher's plan.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..quant import dequantize_int8
from . import _build
# an H100 SM's shared memory (kSmSmem), what the card holds back for each
# block (kBlockReserved) and what one block may take (kMaxSmem, 227 KB)
from .decode_attention import (BLOCK_SMEM_MAX, BLOCK_SMEM_RESERVED,
                               SM_SMEM_BYTES)

__all__ = ["ragged_paged_attention", "ragged_paged_attention_int8",
           "ragged_paged_attention_plain", "SUPPORTED_HEAD_DIMS", "rpa_plan",
           "rpa_plan_c", "LAUNCHES_BY_PLAN"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_VARIANTS = ("fma", "mma", "wgmma")   # the C entries' *variant codes
_fns = {}

# launches on CUDA tensors by (variant as the C entry reported it, dtype,
# d, bs, mb, G, qb, quant)
LAUNCHES_BY_PLAN: collections.Counter = collections.Counter()

RPA_ROWS = 64                # kRows: query rows a block (a warpgroup)
RPA_TILE_KEYS = 64           # kTileKeys: keys a ring stage (a TMA box)
RPA_SPLIT_KEYS = 1024        # kSplitKeys: keys a split at the least
RPA_MAX_CLUSTER = 8          # kMaxCluster: a portable cluster
RPA_BLOCKS_PER_SM = 3        # kBlocksPerSm
RPA_MAX_STAGES = 4           # kMaxStages
RPA_SMEM_FIXED = 1024 + 128  # kSmemFixed: base alignment, barriers


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def rpa_plan(mb: int, bs: int, d: int, G: int, qb: int,
             dtype=torch.bfloat16, quant: bool = False) -> dict:
    """The launch of one call, as ``csrc/ragged_paged_attention.cu::
    rpa_plan`` makes it, from the geometry alone (never pos0, n_valid, C
    or the page ids): the variant; keys a tile; pages a split and splits
    (blocks a cluster; the other variants walk every page in one block);
    64-row tiles; ring stages; shared bytes a block; blocks an SM by
    shared memory.

    "wgmma": a split holds at least ``RPA_SPLIT_KEYS`` keys and the splits
    are at most ``RPA_MAX_CLUSTER``; the ring holds as many 64-key stages
    (k and v; int8 for K8q, which adds one bf16 tile) as leave room for
    ``RPA_BLOCKS_PER_SM`` blocks an SM, at most 4 and at most the split's
    tiles; the combine reuses the ring's bytes."""
    if (mb <= 0 or bs <= 0 or bs % 16 or G <= 0 or qb <= 0
            or d not in SUPPORTED_HEAD_DIMS or dtype not in _DTYPE_CODE):
        raise ValueError(f"mb {mb}, bs {bs}, d {d}, G {G}, qb {qb}, {dtype}: "
                         "no K8 variant takes this geometry")
    row_tiles = _ceil(qb * G, RPA_ROWS)
    bf16 = dtype == torch.bfloat16
    if bf16 and d != 256 and bs % RPA_TILE_KEYS == 0:
        pps = max(_ceil(RPA_SPLIT_KEYS, bs), _ceil(mb, RPA_MAX_CLUSTER))
        stage = 2 * RPA_TILE_KEYS * d * (1 if quant else 2)
        extra = 2 * RPA_TILE_KEYS * d * 2 if quant else 0
        budget = (SM_SMEM_BYTES // RPA_BLOCKS_PER_SM - BLOCK_SMEM_RESERVED
                  - RPA_SMEM_FIXED - extra)
        stages = min(RPA_MAX_STAGES, pps * bs // RPA_TILE_KEYS,
                     budget // stage)
        combine = 4 * (RPA_ROWS * (d + 8) + 2 * RPA_ROWS
                       + RPA_MAX_CLUSTER * RPA_ROWS + RPA_ROWS)
        plan = {"variant": "wgmma", "tile_keys": RPA_TILE_KEYS,
                "pages_per_split": pps, "splits": _ceil(mb, pps),
                "stages": stages,
                "smem": RPA_SMEM_FIXED + max(stages * stage + extra,
                                             combine)}
    else:
        kt = 32 if bs % 32 == 0 else 16
        if bf16 and d != 256:
            plan = {"variant": "mma",
                    "smem": 2 * (d * (kt + 8) + kt * (d + 8))}
        else:
            plan = {"variant": "fma",
                    "smem": 4 * (RPA_ROWS * d + 2 * d * kt + RPA_ROWS * kt
                                 + 3 * RPA_ROWS)}
        plan.update(tile_keys=kt, pages_per_split=mb, splits=1, stages=1)
    plan["row_tiles"] = row_tiles
    plan["blocks_per_sm"] = SM_SMEM_BYTES // (plan["smem"]
                                              + BLOCK_SMEM_RESERVED)
    return plan


_PLAN_KEYS = ("variant", "tile_keys", "pages_per_split", "splits",
              "row_tiles", "stages", "smem", "blocks_per_sm")


def rpa_plan_c(mb: int, bs: int, d: int, G: int, qb: int,
               dtype=torch.bfloat16, quant: bool = False) -> dict:
    """The plan K8's C launcher follows (``rpa_plan_c`` in the library),
    to hold ``rpa_plan`` to it on the card; ``clusters`` (wgmma) is the
    number of its clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = (ctypes.c_int * 9)()
    _build.check(_kernel_fn("rpa_plan_c")(
        mb, bs, d, G, qb, _DTYPE_CODE[dtype], int(quant),
        ctypes.addressof(out)), "rpa_plan_c")
    plan = dict(zip(_PLAN_KEYS, out[:8]))
    plan["variant"] = _VARIANTS[plan["variant"]]
    plan["clusters"] = out[8]
    return plan


def ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0, n_valid,
                                 sm_scale: float, k_scales=None,
                                 v_scales=None) -> torch.Tensor:
    """Gather each chunk's pages (dequantizing int8 pages with their
    gathered scales) and run one masked softmax over the flattened
    context; scores in fp32, max-subtracted exp, output
    acc / max(l, 1e-30), as the reference's gather arm."""
    C, qb, nH, d = q.shape
    nkv = k_pages.shape[1]
    G = nH // nkv
    mb = rows.shape[1]
    bs = k_pages.shape[3]
    idx = rows.long()
    kg, vg = k_pages[idx], v_pages[idx]
    if k_scales is not None:
        kg = dequantize_int8(kg, k_scales[idx][..., None, None], q.dtype)
        vg = dequantize_int8(vg, v_scales[idx][..., None, None], q.dtype)
    kg = kg.transpose(3, 4)                         # [C, mb, nkv, bs, d]
    kg = kg.transpose(1, 2).reshape(C, nkv, mb * bs, d)
    vg = vg.transpose(1, 2).reshape(C, nkv, mb * bs, d)
    qg = q.reshape(C, qb, nkv, G, d)
    s = torch.einsum("cqhgd,chsd->chgqs", qg.float(), kg.float()) * sm_scale
    off = torch.arange(qb, dtype=torch.int32, device=q.device)
    qpos = pos0[:, None] + torch.minimum(off[None, :], n_valid[:, None] - 1)
    kpos = torch.arange(mb * bs, dtype=torch.int32, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [C, qb, S]
    s = s + torch.where(mask, 0.0, -1e30)[:, None, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("chgqs,chsd->cqhgd", (p / l).to(vg.dtype), vg)
    return o.reshape(C, qb, nH, d).to(q.dtype)


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("ragged_paged_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "rpa_plan_c":
            fn.argtypes = [I] * 7 + [P]
        else:
            n_ptr = 7 if name == "rpa_forward" else 9
            fn.argtypes = [P] * n_ptr + [I] * 8 + [ctypes.c_float, I, P, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid,
                page_dtype) -> None:
    """Every operand's dtype, shape, device, contiguity and alignment, in
    as few Python operations as the checks allow (the wrapper's host time
    is a visible share of a ~0.05 ms call); the messages are built only
    on failure."""
    C, qb, nH, d = q.shape
    P, nkv, kd, bs = k_pages.shape
    if (q.dtype not in _DTYPE_CODE or k_pages.dtype != page_dtype
            or v_pages.dtype != page_dtype):
        raise TypeError(f"q {q.dtype}, pages {k_pages.dtype} / "
                        f"{v_pages.dtype}: the kernel takes a float32 or "
                        f"bfloat16 q and {page_dtype} pages")
    if v_pages.shape != (P, nkv, bs, d) or kd != d:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {q.shape}")
    if nH % nkv:
        raise ValueError(f"{nH} query heads not a multiple of {nkv} kv heads")
    if d not in SUPPORTED_HEAD_DIMS or bs % 16:
        raise ValueError(f"head dim {d} / page size {bs}: the kernel takes "
                         f"d in {SUPPORTED_HEAD_DIMS} and bs % 16 == 0")
    if (rows.dtype != torch.int32 or pos0.dtype != torch.int32
            or n_valid.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[0] != C or pos0.shape != (C,)
            or n_valid.shape != (C,)):
        raise ValueError(f"rows, pos0, n_valid must be int32 [{C}, mb], "
                         f"[{C}], [{C}]; got {rows.dtype} "
                         f"{tuple(rows.shape)}, {pos0.dtype} "
                         f"{tuple(pos0.shape)}, {n_valid.dtype} "
                         f"{tuple(n_valid.shape)}")
    dev = q.get_device()
    if (k_pages.get_device() != dev or v_pages.get_device() != dev
            or rows.get_device() != dev or pos0.get_device() != dev
            or n_valid.get_device() != dev or not q.is_contiguous()
            or not k_pages.is_contiguous() or not v_pages.is_contiguous()
            or not rows.is_contiguous() or not pos0.is_contiguous()
            or not n_valid.is_contiguous()):
        raise ValueError("all operands must be contiguous and on "
                         f"{q.device}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 or \
            q.data_ptr() % 4:
        raise ValueError("the kernel reads pages as 16-byte boxes and q as "
                         "32-bit words: page arrays must be 16-byte and q "
                         "4-byte aligned")


def _launch(name, q, k_pages, v_pages, scales, rows, pos0, n_valid,
            sm_scale) -> torch.Tensor:
    """One ctypes call, one kernel launch; nothing allocated but the
    output. Counts the launch under the variant the C entry reported."""
    C, qb, nH, d = q.shape
    P, nkv, _, bs = k_pages.shape
    mb = rows.shape[1]
    out = torch.empty_like(q)
    variant = ctypes.c_int(-1)
    _build.check(_kernel_fn(name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() for t in scales), rows.data_ptr(), pos0.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), C, qb, nH, nkv, d, bs, mb, P,
        float(sm_scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.byref(variant)), name)
    LAUNCHES_BY_PLAN[(_VARIANTS[variant.value], _DTYPE_NAME[q.dtype], d, bs,
                      mb, nH // nkv, qb, bool(scales))] += 1
    return out


def ragged_paged_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                rows, pos0, n_valid,
                                sm_scale: float) -> torch.Tensor:
    """K8q: the unified attention over int8 pages with their [P, nKV]
    fp32 scale planes. Counts its CUDA launches in
    ``ragged_paged_attention_int8.launches``."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0,
                                            n_valid, sm_scale, k_scales,
                                            v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid, torch.int8)
    want, dev = k_pages.shape[:2], q.get_device()
    for t in (k_scales, v_scales):
        if (t.dtype != torch.float32 or t.shape != want
                or t.get_device() != dev or not t.is_contiguous()):
            raise ValueError(f"scale planes must be contiguous float32 "
                             f"{tuple(want)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    out = _launch("rpa_forward_int8", q, k_pages, v_pages,
                  (k_scales, v_scales), rows, pos0, n_valid, sm_scale)
    ragged_paged_attention_int8.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, rows, pos0, n_valid,
                           sm_scale: float, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """The unified attention of one engine step (see module docstring):
    int8 pages go to ``ragged_paged_attention_int8``, which needs both
    scale planes. Counts its own (fp page) CUDA launches in
    ``ragged_paged_attention.launches``."""
    if k_pages.dtype == torch.int8:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 KV pages need k_scales and v_scales "
                             "([P, nKV] fp32 per-page scale planes)")
        return ragged_paged_attention_int8(q, k_pages, v_pages, k_scales,
                                           v_scales, rows, pos0, n_valid,
                                           sm_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0,
                                            n_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid, q.dtype)
    out = _launch("rpa_forward", q, k_pages, v_pages, (), rows, pos0,
                  n_valid, sm_scale)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention_int8.launches = 0
