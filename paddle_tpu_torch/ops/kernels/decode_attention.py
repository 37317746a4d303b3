"""One-token GQA attention over a dense KV cache (K10): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/decode_attention.py, kernel
``_decode_kernel`` (the fp cache arm of ``decode_attention``): q [B, nH, d]
(the step's token), cache_k / cache_v [B, nKV, S, d] in the engine's
kv-head-major layout, ``pos`` the last valid cache index; o [B, nH, d].
The G = nH / nKV query heads of a kv head are served together (no
repeated cache) and positions past ``pos`` are never read. One launch a
call and nothing allocated but the output: a thread-block cluster a
(b, kv head) walks the cache in 32-position chunks and combines its
blocks' partial softmax states through distributed shared memory
(``decode_plan``).

K10q is the kernel's int8 arm (``quant=True``): int8 caches with fp32
per-position scales ``k_scale`` / ``v_scale`` [B, nKV, S], dequantized as
``ops/quant.py::dequantize_int8`` does (fp32 multiply, cast to q's dtype)
where a row is read. As in the reference, no engine calls it: it is
reached through ``decode_attention(..., k_scale=, v_scale=)``.

On a CPU tensor the wrappers run the plain version, the masked dense
expression of the reference's ``_decode_block`` fallback (on the
dequantized cache for int8); on a CUDA tensor they launch
``csrc/decode_attention.cu`` or raise.

The paged decode of ``incubate.nn.functional`` (the reference's
``paged_decode_attention_*`` entries, ``csrc/paged_decode_attention.cu``):
q [B, nq, d] in the page dtype, one token per sequence; block_table
[B, mb] int32; seq_lens [B] int32; o [B, nq, d]. Per page, in table
order, the reference's ``_online_softmax_page``: s = (q k^T) * scale in
fp32, -1e30 added at positions >= seq_len, m, l and acc updated online,
o = acc / max(l, 1e-30).

- K15 ``paged_decode_attention_mxu``: d-major k pages [P, nkv, d, bs],
  token-major v pages [P, nkv, bs, d], GQA native; p rounded to the page
  dtype before the value product (l sums the unrounded p). One thread
  streams runs of d-rows (k) and of tokens (v) through a ring of 1-D
  bulk copies that ``paged_mxu_plan`` sizes.
- K14 ``paged_decode_attention_kernel``: token-major k and v pages
  [P, nh, bs, d], nh == nq, fp32 products, p not rounded. One thread
  streams the rows through a ring of 1-D bulk copies that
  ``paged_ring_geometry`` sizes.
- K16 ``paged_decode_attention_dma``: K14's function and order of
  operations (bit-equal to K14) through a warp-specialised kernel: two
  producer warps stream the pages' k and v tiles into two rings that
  ``paged_dma_plan`` sizes, a score warpgroup takes page j + 1's scores
  while a value warpgroup takes page j's p v; raises where
  ``paged_decode_supported`` fails, as the reference's does.

Their gates are the reference's term for term (v5e VMEM caps that decide
which kernel, or the gather expression, runs), so the port takes the
reference's route. A sequence of length 0 attends to every row of its
table's pages with equal weight (every score is -1e30), as the
reference's kernels do. The plain versions walk the pages in the same
order with the same online state, vectorised over sequences and heads.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import dequantize_int8
from . import _build

__all__ = ["decode_attention", "decode_attention_int8",
           "decode_attention_plain", "decode_attention_supported", "BLOCK_S",
           "decode_plan", "decode_plan_c",
           "paged_decode_supported", "paged_decode_mxu_supported",
           "paged_decode_attention_mxu", "paged_decode_attention_kernel",
           "paged_decode_attention_dma", "paged_decode_mxu_plain",
           "paged_decode_plain", "paged_ring_geometry", "paged_mxu_plan",
           "paged_mxu_plan_c", "paged_dma_plan", "paged_dma_plan_c"]

BLOCK_S = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def decode_attention_supported(cache_shape, head_dim: int,
                               num_heads: int | None = None) -> bool:
    """The reference's gate, term for term, so that the port takes the
    same route: d in (64, 128, 256); with ``num_heads``, nH a multiple of
    nKV with G >= 2 (MHA takes the dense expression); S one block (a
    128-multiple up to 512) or a whole number of 512-blocks."""
    _, nKV, S, d = cache_shape
    if d not in (64, 128, 256):
        return False
    if num_heads is not None:
        if num_heads % nKV or num_heads // nKV < 2:
            return False
    return (S % 128 == 0) if S <= BLOCK_S else (S % BLOCK_S == 0)


def decode_attention_plain(q, cache_k, cache_v, pos: int, sm_scale: float,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The masked dense expression: every cache row scored, rows past
    ``pos`` filled with -1e30, softmax in fp32, p cast to q's dtype. An
    int8 cache is dequantized first with its per-position scales."""
    if k_scale is not None:
        cache_k = dequantize_int8(cache_k, k_scale[..., None], q.dtype)
        cache_v = dequantize_int8(cache_v, v_scale[..., None], q.dtype)
    B, nKV, S, d = cache_k.shape
    G = q.shape[1] // nKV
    kf = cache_k.repeat_interleave(G, dim=1).to(q.dtype)   # [B, nH, S, d]
    vf = cache_v.repeat_interleave(G, dim=1).to(q.dtype)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kf.float()) * sm_scale
    mask = torch.arange(S, device=q.device) <= pos
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", p.float(), vf.float()).to(q.dtype)


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("decode_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "decode_plan_c":
            fn.argtypes = [I] * 8 + [P]
        else:
            n_ptr = 4 if name == "decode_attention" else 6
            fn.argtypes = [P] * n_ptr + [I] * 6 + [ctypes.c_float, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


DECODE_CHUNK = 32            # kChunk: cache positions a chunk
DECODE_MAX_CLUSTER = 8       # kMaxCluster: a portable cluster
DECODE_TARGET_BLOCKS = 528   # kTargetBlocks: four blocks on each of 132 SMs
DECODE_MAX_G = 16


def _decode_block_smem(d: int, G: int, cbytes: int, chunk: int,
                       quant: bool) -> int:
    """A K10 block's shared bytes, as the kernel lays them out: two
    stages of k rows (padded so that the rows one shared-memory phase
    reads lie in other banks), v rows and, int8, both scales; then fp32
    q [G][d], s [G][chunk], p [chunk][G rounded up to 4], acc [G][d] and
    m, l, alpha [G]."""
    k_row = d * cbytes + (32 * cbytes) % 128
    stage = chunk * (k_row + d * cbytes) + (8 * chunk if quant else 0)
    g4 = -(-G // 4) * 4
    return 2 * stage + 4 * (2 * G * d + G * chunk + chunk * g4 + 3 * G)


def decode_plan(B: int, nKV: int, G: int, d: int, pos: int,
                dtype=torch.bfloat16, quant: bool = False) -> tuple[
                    int, int, int, int]:
    """K10's launch, as ``csrc/decode_attention.cu::decode_plan`` makes
    it: (positions a chunk, chunks, blocks a cluster, shared bytes a
    block). The cache is cut into chunks of 32 positions (K10q walks
    K10's chunks, so that it gives K10's bits); one cluster serves a (b,
    kv head), with the most blocks, a power of two, at most 8 and at
    most the chunks, that keeps the B x nKV clusters within
    ``DECODE_TARGET_BLOCKS`` (one wave of four ~42 KB blocks an SM at
    llama1b's width). Block r of a cluster of c walks chunks
    [r n / c, (r + 1) n / c) of the n, so its ranks are in chunk
    order."""
    chunk = DECODE_CHUNK
    cbytes = 1 if quant else torch.empty((), dtype=dtype).element_size()
    smem = _decode_block_smem(d, G, cbytes, chunk, quant)
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(f"d {d}, G {G}: no K10 stage fits")
    n_chunks = -(-(pos + 1) // chunk)
    cluster = 1
    while (cluster * 2 <= min(DECODE_MAX_CLUSTER, n_chunks)
           and B * nKV * cluster * 2 <= DECODE_TARGET_BLOCKS):
        cluster *= 2
    return chunk, n_chunks, cluster, smem


def decode_plan_c(B: int, nKV: int, G: int, S: int, d: int, pos: int,
                  dtype=torch.bfloat16, quant: bool = False) -> tuple:
    """The plan K10's C launcher follows (``decode_plan_c`` in the
    library), to hold ``decode_plan`` to it on the card."""
    out = (ctypes.c_int * 4)()
    _build.check(_kernel_fn("decode_plan_c")(
        B, nKV, G, S, d, pos, _DTYPE_CODE[dtype], int(quant),
        ctypes.addressof(out)), "decode_plan_c")
    return tuple(out)


def _check(q, cache_k, cache_v, pos: int, cache_dtype) -> None:
    if q.dtype not in _DTYPE_CODE or cache_k.dtype != cache_dtype or \
            cache_v.dtype != cache_dtype:
        raise TypeError(f"q {q.dtype} / cache {cache_k.dtype}, "
                        f"{cache_v.dtype}: the kernel takes a float32 or "
                        f"bfloat16 q and {cache_dtype} caches")
    B, nKV, S, d = cache_k.shape
    if (q.dim() != 3 or q.shape[0] != B or q.shape[2] != d
            or q.shape[1] % nKV or cache_v.shape != cache_k.shape):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache_k.shape)} "
                         f"/ {tuple(cache_v.shape)}: want [B, nKV*G, d] and "
                         "two [B, nKV, S, d]")
    G = q.shape[1] // nKV
    if d not in (64, 128, 256) or not 1 <= G <= DECODE_MAX_G \
            or not 0 <= pos < S:
        raise ValueError(f"d {d}, G {G}, pos {pos} of S {S}: the kernel "
                         "takes d in (64, 128, 256), G <= 16, 0 <= pos < S")
    for t in (q, cache_k, cache_v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q and the caches must be contiguous and on "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernel copies 16-byte vectors: q and the "
                             "caches must be 16-byte aligned")


def _launch(name, q, cache_k, cache_v, scales, pos: int,
            sm_scale: float) -> torch.Tensor:
    """One ctypes call, one kernel launch; nothing allocated but o."""
    B, nKV, S, d = cache_k.shape
    o = torch.empty_like(q)
    _build.check(_kernel_fn(name)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        *(t.data_ptr() for t in scales), o.data_ptr(), B, nKV,
        q.shape[1] // nKV, S, d, pos, float(sm_scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), name)
    return o


def decode_attention_int8(q, cache_k, cache_v, k_scale, v_scale, pos,
                          sm_scale: float) -> torch.Tensor:
    """K10q: int8 caches with fp32 per-position scales [B, nKV, S].
    Counts its CUDA launches in ``decode_attention_int8.launches``."""
    pos = int(pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos, sm_scale,
                                      k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, cache_k, cache_v, pos, torch.int8)
    want = tuple(cache_k.shape[:3])
    for t in (k_scale, v_scale):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"scales must be contiguous float32 {want} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    o = _launch("decode_attention_int8", q, cache_k, cache_v,
                (k_scale, v_scale), pos, sm_scale)
    decode_attention_int8.launches += 1
    return o


def decode_attention(q, cache_k, cache_v, pos, sm_scale: float,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """K10: o [B, nH, d]. ``pos`` is an int (or a 0-d tensor, read once).
    int8 caches go to ``decode_attention_int8`` and need both scales.
    Counts its own (fp cache) CUDA launches in
    ``decode_attention.launches``."""
    if cache_k.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("decode_attention: int8 caches require "
                             "k_scale and v_scale ([B, nKV, S] fp32)")
        return decode_attention_int8(q, cache_k, cache_v, k_scale, v_scale,
                                     pos, sm_scale)
    pos = int(pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, cache_k, cache_v, pos, q.dtype)
    o = _launch("decode_attention", q, cache_k, cache_v, (), pos, sm_scale)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
decode_attention_int8.launches = 0


# ---- the paged decode (K15, K14, K16) -------------------------------------

_VMEM_CAP = 12 * 2 ** 20


def paged_decode_supported(pages_shape, n_q_heads: int,
                           max_blocks: int | None = None,
                           itemsize: int = 2) -> bool:
    """The reference's gate of the token-major kernels (K14, K16), term
    for term: d in (64, 128, 256), bs % 8 == 0, nh == the q heads, and
    the double-buffered k + v working set of ``k_per`` pages plus one
    page's fp32 temporaries within 12 MiB (a v5e VMEM cap; mirrored so
    that the port takes the reference's route)."""
    _, nh, bs, d = pages_shape
    page_bytes = nh * bs * d * itemsize
    k_per = _paged_pages_per_program(max_blocks if max_blocks is not None
                                     else 4, page_bytes)
    est = 2 * 2 * k_per * page_bytes + 4 * page_bytes
    if est > _VMEM_CAP:
        return False
    return (d in (64, 128, 256) and bs % 8 == 0
            and nh == n_q_heads)


def _paged_pages_per_program(max_blocks: int,
                             page_bytes: int | None = None) -> int:
    """The reference's pages per program: the largest of 4, 2, 1 that
    divides ``max_blocks`` and, given ``page_bytes``, keeps 2 slots x 2
    tensors x k pages within 12 MiB."""
    for k in (4, 2, 1):
        if max_blocks % k:
            continue
        if page_bytes is not None and 4 * k * page_bytes > _VMEM_CAP:
            continue
        return k
    return 1


def paged_decode_mxu_supported(kt_pages_shape, n_q_heads: int,
                               max_blocks: int | None = None,
                               itemsize: int = 2) -> bool:
    """The reference's gate of K15, term for term: d-major k pages
    [P, nkv, d, bs] with d in (128, 256), bs % 128 == 0, nq a multiple
    of nkv, nq >= 8, and the k_per working set plus the block-diagonal q
    within 12 MiB."""
    _, nkv, d, bs = kt_pages_shape
    page_bytes = nkv * bs * d * itemsize
    k_per = _paged_pages_per_program(max_blocks if max_blocks is not None
                                     else 4, page_bytes)
    est = 2 * 2 * k_per * page_bytes + 2 * n_q_heads * nkv * d * itemsize
    if est > _VMEM_CAP:
        return False
    return (d in (128, 256) and bs % 128 == 0 and n_q_heads % nkv == 0
            and n_q_heads >= 8)


def _paged_plain(q, k_pages, v_pages, block_table, seq_lens,
                 sm_scale: float, d_major: bool,
                 round_p: bool) -> torch.Tensor:
    """Page by page in table order, every page of the table (as the
    reference's kernels), vectorised over sequences and heads: fp32
    scores of q against the page, -1e30 past seq_len, the online m, l,
    acc; with ``round_p`` p is rounded to the page dtype before the
    value product."""
    B, nq, d = q.shape
    nkv, bs = v_pages.shape[1], v_pages.shape[2]
    G = nq // nkv
    qf = q.float().reshape(B, nkv, G, d)
    m = torch.full((B, nkv, G), -1e30, device=q.device)
    l = torch.zeros((B, nkv, G), device=q.device)
    acc = torch.zeros((B, nkv, G, d), device=q.device)
    table = block_table.long()
    lens = seq_lens.to(q.device)
    for j in range(table.shape[1]):
        kp = k_pages[table[:, j]].float()
        s = torch.einsum("bkgd,bkdt->bkgt" if d_major else "bkgd,bktd->bkgt",
                         qf, kp) * sm_scale
        pos = j * bs + torch.arange(bs, device=q.device)
        s = s + torch.where(pos[None, :] < lens[:, None], 0.0,
                            -1e30)[:, None, None, :]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        m = m_new
        if round_p:
            p = p.to(v_pages.dtype).float()
        pv = torch.einsum("bkgt,bktd->bkgd", p,
                          v_pages[table[:, j]].float())
        acc = acc * alpha[..., None] + pv
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, nq, d).to(q.dtype)


def paged_decode_mxu_plain(q, kt_pages, v_pages, block_table, seq_lens,
                           sm_scale: float) -> torch.Tensor:
    """K15's function: d-major k pages, GQA, p rounded to the page
    dtype before the value product."""
    return _paged_plain(q, kt_pages, v_pages, block_table, seq_lens,
                        sm_scale, d_major=True, round_p=True)


def paged_decode_plain(q, k_pages, v_pages, block_table, seq_lens,
                       sm_scale: float) -> torch.Tensor:
    """K14's and K16's function: token-major pages, fp32 throughout."""
    return _paged_plain(q, k_pages, v_pages, block_table, seq_lens,
                        sm_scale, d_major=False, round_p=False)


SM_SMEM_BYTES = 233472       # shared memory of an H100 SM (228 KB)
BLOCK_SMEM_MAX = 232448      # what one block may take (227 KB)
BLOCK_SMEM_RESERVED = 1024   # held back by the card for every block
RING_BLOCKS_PER_SM = 2       # nh x B = 256 blocks over 132 SMs: one wave
RING_TILE_BYTES = 16384      # a stage at most
RING_MAX_STAGES = 16         # kMaxStages in the source


def paged_ring_geometry(d: int, bs: int, itemsize: int) -> tuple[int, int,
                                                                int]:
    """K14's ring: (rows a stage, stages, shared bytes a block). A stage
    is the largest of 64, 32, 16, 8 rows that divides the page and fits
    16 KB; as many stages (3 to 16) as leave ``RING_BLOCKS_PER_SM``
    blocks room on an SM beside the fixed part (barriers, q, s, state),
    as the kernel lays it out. A page too long for that (s holds bs
    floats) gets a block's whole shared memory."""
    row = d * itemsize
    tile = next(t for t in (64, 32, 16, 8)
                if bs % t == 0 and t * row <= RING_TILE_BYTES)
    fixed = 256 + 4 * (d + bs + 4)
    for room in (SM_SMEM_BYTES // RING_BLOCKS_PER_SM - BLOCK_SMEM_RESERVED,
                 BLOCK_SMEM_MAX):
        stages = min(RING_MAX_STAGES, (room - fixed) // (tile * row))
        if stages >= 3:
            return tile, stages, fixed + stages * tile * row
    raise ValueError(f"d {d}, bs {bs}: no 3-stage ring fits")


def paged_mxu_plan(d: int, bs: int, G: int, itemsize: int) -> tuple[
        int, int, int, int]:
    """K15's ring, as ``csrc/paged_decode_attention.cu::mxu_plan`` sizes
    it: (d-rows a k stage, tokens a v stage, stages, shared bytes a
    block). A k stage is a run of d-rows of one d-major k page (each bs
    tokens long), the most of 64, 32, .., 1 within 16 KB; a v stage a run
    of tokens of one token-major v page, the most of 64, 32, 16, 8 that
    divides the page within 16 KB; a ring slot holds the larger. As many
    stages (2 to 16) as leave ``RING_BLOCKS_PER_SM`` blocks room on an SM
    beside the fixed part (barriers; fp32 q, pv and acc [G][d], s
    [G][bs], m, l, alpha [G]), else a block's whole shared memory."""
    k_rows = next((r for r in (64, 32, 16, 8, 4, 2)
                   if r * bs * itemsize <= RING_TILE_BYTES), 1)
    v_rows = next((r for r in (64, 32, 16, 8)
                   if bs % r == 0 and r * d * itemsize <= RING_TILE_BYTES),
                  None)
    if v_rows is None or G < 1:
        raise ValueError(f"d {d}, bs {bs}, G {G}: no K15 ring")
    slot = max(k_rows * bs, v_rows * d) * itemsize
    fixed = 256 + 4 * (3 * G * d + G * bs + 3 * G)
    for room in (SM_SMEM_BYTES // RING_BLOCKS_PER_SM - BLOCK_SMEM_RESERVED,
                 BLOCK_SMEM_MAX):
        stages = min(RING_MAX_STAGES, max(room - fixed, 0) // slot)
        if stages >= 2:
            return k_rows, v_rows, stages, fixed + stages * slot
    raise ValueError(f"d {d}, bs {bs}, G {G}: no two-stage K15 ring fits")


def paged_mxu_plan_c(d: int, bs: int, G: int, itemsize: int) -> tuple:
    """The ring K15's C launcher plans (``paged_mxu_plan_c`` in the
    library), to hold ``paged_mxu_plan`` to it on the card."""
    out = (ctypes.c_int * 4)()
    _build.check(_paged_fn("paged_mxu_plan_c")(d, bs, G, itemsize,
                                                ctypes.addressof(out)),
                 "paged_mxu_plan_c")
    return tuple(out)


DMA_THREADS = 320            # kDmaThreads: two warpgroups, two producer warps
DMA_BAR_BYTES = 640          # kDmaBarBytes: the block's mbarriers


def paged_dma_plan(d: int, bs: int, itemsize: int) -> tuple[int, int, int,
                                                            int, int]:
    """K16's rings, as ``csrc/paged_decode_attention.cu::dma_plan`` sizes
    them: (rows a stage, k stages, v stages, threads, shared bytes a
    block). A stage is the largest of 64, 32, 16, 8 rows that divides the
    page and fits 16 KB (K14's tile); the k ring and the v ring share as
    many stages as leave ``RING_BLOCKS_PER_SM`` blocks room on an SM
    beside the fixed part (barriers, fp32 q [d], two score buffers
    [2][bs], m, l, two alphas), half each and the odd one to v, 2 to 16
    each; a page too long for that gets a block's whole shared memory.
    The k producer walks the table's pages in order, each page's k tiles
    in order, stage i of the walk into k slot i % k_stages; the v
    producer likewise into the v ring; a page's k tiles are consumed
    (its scores) before its v tiles (its p v)."""
    row = d * itemsize
    tile = next((t for t in (64, 32, 16, 8)
                 if bs % t == 0 and t * row <= RING_TILE_BYTES), None)
    if tile is None:
        raise ValueError(f"d {d}, bs {bs}: no K16 stage")
    fixed = DMA_BAR_BYTES + 4 * (d + 2 * bs + 4)
    for room in (SM_SMEM_BYTES // RING_BLOCKS_PER_SM - BLOCK_SMEM_RESERVED,
                 BLOCK_SMEM_MAX):
        total = min(2 * RING_MAX_STAGES, max(room - fixed, 0) // (tile * row))
        k_stages = total // 2
        if k_stages >= 2:
            return (tile, k_stages, total - k_stages, DMA_THREADS,
                    fixed + total * tile * row)
    raise ValueError(f"d {d}, bs {bs}: no two-stage K16 rings fit")


def paged_dma_plan_c(d: int, bs: int, itemsize: int) -> tuple:
    """The rings K16's C launcher plans (``paged_dma_plan_c`` in the
    library), to hold ``paged_dma_plan`` to it on the card."""
    out = (ctypes.c_int * 5)()
    _build.check(_paged_fn("paged_dma_plan_c")(d, bs, itemsize,
                                                ctypes.addressof(out)),
                 "paged_dma_plan_c")
    return tuple(out)


def _paged_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("paged_decode_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "paged_mxu_plan_c":
            fn.argtypes = [I] * 4 + [P]
        elif name == "paged_dma_plan_c":
            fn.argtypes = [I] * 3 + [P]
        else:
            n_int = {"paged_decode_mxu": 6, "paged_decode_tok": 7,
                     "paged_decode_dma": 5}[name]
            fn.argtypes = [P] * 6 + [I] * n_int + [ctypes.c_float, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _check_paged(q, k_pages, v_pages, block_table, seq_lens,
                 d_major: bool) -> tuple[int, int, int, int, int]:
    """The paged kernels' operand rules; returns (B, nkv, G, bs, mb)."""
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"q {q.dtype} / pages {k_pages.dtype}, "
                        f"{v_pages.dtype}: the kernels take float32 or "
                        "bfloat16, q in the page dtype")
    B, nq, d = q.shape
    P, nkv, bs, dv = v_pages.shape
    want_k = (P, nkv, d, bs) if d_major else (P, nkv, bs, d)
    mb = block_table.shape[-1]
    if (tuple(k_pages.shape) != want_k or dv != d or nq % nkv
            or tuple(block_table.shape) != (B, mb)
            or tuple(seq_lens.shape) != (B,)):
        raise ValueError(f"q {tuple(q.shape)}, k pages "
                         f"{tuple(k_pages.shape)}, v pages "
                         f"{tuple(v_pages.shape)}, table "
                         f"{tuple(block_table.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)}: want k pages {want_k}")
    if d not in (64, 128, 256) or bs % 8:
        raise ValueError(f"d {d}, bs {bs}: the kernels take d in (64, 128, "
                         "256) and bs % 8 == 0")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_table and seq_lens must be int32")
    for t in (q, k_pages, v_pages, block_table, seq_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"operands must be contiguous and on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels copy 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return B, nkv, nq // nkv, bs, mb


def _launch_paged(name: str, q, k_pages, v_pages, block_table, seq_lens,
                  sm_scale: float, d_major: bool) -> torch.Tensor:
    B, nkv, G, bs, mb = _check_paged(q, k_pages, v_pages, block_table,
                                     seq_lens, d_major)
    d = q.shape[2]
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr())
    if d_major:
        geo = (nkv, G, d, bs, mb)
    elif name == "paged_decode_tok":
        geo = (nkv, d, bs, mb,
               *paged_ring_geometry(d, bs, q.element_size())[:2])
    else:   # K16 sizes its own rings
        geo = (nkv, d, bs, mb)
    err = _paged_fn(name)(*ptrs, B, *geo, float(sm_scale),
                          _DTYPE_CODE[q.dtype],
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    return o


def paged_decode_attention_mxu(q, kt_pages, v_pages, block_table, seq_lens,
                               sm_scale: float) -> torch.Tensor:
    """K15: o [B, nq, d] over d-major k pages, GQA native. Counts its
    CUDA launches in ``paged_decode_attention_mxu.launches``."""
    if q.device.type == "cpu":
        return paged_decode_mxu_plain(q, kt_pages, v_pages, block_table,
                                      seq_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    o = _launch_paged("paged_decode_mxu", q, kt_pages, v_pages,
                      block_table, seq_lens, sm_scale, d_major=True)
    paged_decode_attention_mxu.launches += 1
    return o


def paged_decode_attention_kernel(q, k_pages, v_pages, block_table,
                                  seq_lens, sm_scale: float) -> torch.Tensor:
    """K14: o [B, nh, d] over token-major pages (nh == nq). Counts its
    CUDA launches in ``paged_decode_attention_kernel.launches``."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, seq_lens,
                                  sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[1] != k_pages.shape[1]:
        raise ValueError(f"{q.shape[1]} q heads over {k_pages.shape[1]} "
                         "page heads: the token-major kernels take nh == nq")
    o = _launch_paged("paged_decode_tok", q, k_pages, v_pages,
                      block_table, seq_lens, sm_scale, d_major=False)
    paged_decode_attention_kernel.launches += 1
    return o


def paged_decode_attention_dma(q, k_pages, v_pages, block_table, seq_lens,
                               sm_scale: float) -> torch.Tensor:
    """K16: K14's function through the warp-specialised kernel that
    sizes its own rings (``paged_dma_plan``; bit-equal to K14). Raises
    where ``paged_decode_supported`` fails, on any device, as the
    reference's entry does. Counts its CUDA launches in
    ``paged_decode_attention_dma.launches``."""
    if not paged_decode_supported(k_pages.shape, q.shape[1],
                                  max_blocks=block_table.shape[1],
                                  itemsize=k_pages.element_size()):
        raise ValueError(
            f"paged_decode_attention_dma: pages {tuple(k_pages.shape)} "
            f"with {q.shape[1]} q heads unsupported; gate with "
            "paged_decode_supported()")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, seq_lens,
                                  sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    o = _launch_paged("paged_decode_dma", q, k_pages, v_pages,
                      block_table, seq_lens, sm_scale, d_major=False)
    paged_decode_attention_dma.launches += 1
    return o


paged_decode_attention_mxu.launches = 0
paged_decode_attention_kernel.launches = 0
paged_decode_attention_dma.launches = 0
