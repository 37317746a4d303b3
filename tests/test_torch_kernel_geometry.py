"""Tile and ring choices of the redesigned kernels, held on the CPU.

K9 (``quant_matmul.qmm_plan``): every matmul shape of the llama3-8b
weight-only int8 engine step takes the TMA + wgmma variant with at least
64 tiles or a split K; shapes TMA cannot take (K % 8, N % 16) take the
mma.sync variant, fp32 x the CUDA-core one; the ring fits a block's
shared memory and every split keeps K steps. K14
(``decode_attention.paged_ring_geometry``): for every geometry the
token-major gate admits (d 64, 128, 256; bs a multiple of 8; fp32 and
bf16) the ring fits 227 KB, leaves room for two blocks on an SM, and its
stages tile the page. K15 (``decode_attention.paged_mxu_plan``): at every
d, dtype, page of 16-256 tokens and G the ring fits 227 KB, at
llama2-7b's width with two blocks an SM, and its stages copy every
d-row and token of every page once, in order. K10
(``decode_attention.decode_plan``): every shape the gate admits fits, a
cluster is a power of two up to 8 that fills one wave, and its ranks walk
every chunk once, in order. The flash tile loops (K1, K11, K17 forward; K2,
K3, K17 backward; ``flash_attention.flash_plan``): bf16 at head dim 64
and 128 takes the TMA + wgmma variant at every S the kernels take
(S % 128 == 64 too), fp32 and head dim 256 the FMA one; every plan fits
227 KB; the work order covers every causal tile once, heaviest first
within each L2 chunk; the plan's constants are the source's. The flash
launch counters take the variant the C launcher reports, not the plan's.
The cross-entropy products (K4's "stats", K5's "dl", "dx", "dw" a slab;
``fused_ce.ce_plan``) at gpt3-350m's and gpt3-1.3b's loss shapes and a
ragged case: bf16 takes the TMA + wgmma route and fp32 the FMA one, every
launch fits 227 KB, the persistent blocks' tiles cover every output tile
of each product exactly once, the slabs cover the vocabulary, and the
constants are the source's; the CE product counters take the variant
the C entry reports. K7's 2-D walk (``fused_bias_act.bias_gelu_plan``)
covers every element of [n, f] exactly once for ragged n and every
f % 8 == 0, each thread on one fixed column vector. K8 / K8q
(``ragged_paged_attention.rpa_plan``): for every (mb, bs, d, G, qb) the
wgmma route takes, the splits load pages [0, last // bs] of a chunk
once each, in order, tile by tile, whatever its last key; at most 8
splits (a cluster) of at least 1024 keys; the ring and the combine fit
227 KB with three blocks an SM; the plan takes the geometry alone; other
pages, dtypes and head dims take the mma.sync or FMA kernel; the
constants are the source's, and launches are counted under the variant
the C entry reports. K13 (``lora_matmul.lora_plan``): at r 4, 8, 16, fp32
and bf16, H 128 / 4096 / 14336 and N 128 / 1024 / 4096 the launch fits
227 KB with three blocks an SM, its cluster is a power of two up to 8
that divides H / 128, its blocks' H slices cover every column of H once
and their N slices every column of N once, its stages copy every column
of a block's H slice once a row group, in order; the plan takes (H, N,
r, itemsize) alone and refuses shapes outside the reference's gate;
launches are counted under the variant the C entry reports. K16
(``decode_attention.paged_dma_plan``): at d 64, 128, 256, pages of 8-128
tokens, fp32 and bf16 the rings fit with two blocks an SM, and the k and
v producers stage every tile of every page once, in table order, a
page's k tiles consumed before its v tiles.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
from paddle_tpu_torch.ops.kernels import fused_ce as ce
from paddle_tpu_torch.ops.kernels import lora_matmul as lm
from paddle_tpu_torch.ops.kernels import quant_matmul as qmm
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

# 950 cases that make no garbage cycles: the heap stays frozen, so the
# suite's per-test collection does not walk both frameworks' objects
from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401

ENGINE_SHAPES = [(512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
                 (512, 14336, 4096), (32, 4096, 128256)]


@pytest.mark.parametrize("M,K,N", ENGINE_SHAPES)
def test_engine_shapes_take_wgmma(M, K, N):
    plan = qmm.qmm_plan(M, K, N)
    assert plan["variant"] == "wgmma"
    assert plan["tiles"] >= 64 or plan["splits"] > 1
    assert plan["tiles"] * plan["splits"] >= 64


@pytest.mark.parametrize("M,K,N", [(33, 100, 70), (512, 4096, 1000),
                                   (64, 4100, 1024), (1, 64, 24)])
def test_unaligned_shapes_take_mma(M, K, N):
    assert qmm.qmm_plan(M, K, N)["variant"] == "mma"
    assert qmm.qmm_plan(M, K, N, torch.float32)["variant"] == "fma"


@pytest.mark.parametrize("M,K,N", ENGINE_SHAPES + [
    (1, 4096, 1024), (63, 4096, 1024), (65, 4104, 1024), (511, 200, 4096),
    (2048, 8192, 16), (7, 8, 32)])
def test_wgmma_plan_fits(M, K, N):
    plan = qmm.qmm_plan(M, K, N)
    bm, splits, stages = plan["bm"], plan["splits"], plan["stages"]
    assert bm in (32, 64, 128, 256) and bm >= min(M, 256)
    assert plan["bn"] == (256 if bm <= 64 else 128)
    assert plan["tiles"] == -(-M // bm) * -(-N // plan["bn"])
    assert 3 <= stages <= qmm.QMM_MAX_STAGES
    assert plan["smem"] <= qmm.QMM_SMEM
    k_steps = -(-K // qmm.QMM_BK)
    per = -(-k_steps // splits)
    assert (splits - 1) * per < k_steps        # no split is empty


def test_split_k_only_where_tiles_are_few():
    assert qmm.qmm_plan(512, 4096, 14336)["splits"] == 1
    assert qmm.qmm_plan(32, 4096, 128256)["splits"] == 1
    assert qmm.qmm_plan(512, 4096, 1024)["splits"] > 1


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 24, 40, 64, 128, 256, 512])
def test_paged_ring_fits(itemsize, d, bs):
    tile, stages, smem = da.paged_ring_geometry(d, bs, itemsize)
    assert bs % tile == 0 and tile % 8 == 0
    assert tile * d * itemsize <= da.RING_TILE_BYTES
    assert 3 <= stages <= da.RING_MAX_STAGES
    assert smem == 256 + stages * tile * d * itemsize + 4 * (d + bs + 4)
    assert smem <= da.BLOCK_SMEM_MAX
    assert da.RING_BLOCKS_PER_SM * (smem + da.BLOCK_SMEM_RESERVED) <= \
        da.SM_SMEM_BYTES


def test_paged_ring_at_llama2_7b():
    """bf16, d 128, page 128: 64-row stages (16 KB), two
    blocks an SM."""
    assert da.paged_ring_geometry(128, 128, 2)[:2] == (64, 6)


def test_paged_ring_long_page_takes_one_block():
    tile, stages, smem = da.paged_ring_geometry(256, 40000, 4)
    assert stages >= 3 and smem <= da.BLOCK_SMEM_MAX



MXU_BS = [16, 24, 40, 64, 128, 192, 256]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bs", MXU_BS)
@pytest.mark.parametrize("G", [1, 4, 16])
def test_paged_mxu_plan_fits(itemsize, d, bs, G):
    """K15's ring fits a block's 227 KB at every page of 16-256 tokens:
    a k stage is whole d-rows that tile d, a v stage whole tokens that
    tile the page, each within 16 KB, 2-16 slots of the larger."""
    k_rows, v_rows, stages, smem = da.paged_mxu_plan(d, bs, G, itemsize)
    assert d % k_rows == 0 and bs % v_rows == 0 and v_rows % 8 == 0
    assert k_rows * bs * itemsize <= da.RING_TILE_BYTES
    assert v_rows * d * itemsize <= da.RING_TILE_BYTES
    assert 2 <= stages <= da.RING_MAX_STAGES
    slot = max(k_rows * bs, v_rows * d) * itemsize
    fixed = 256 + 4 * (3 * G * d + G * bs + 3 * G)
    assert smem == fixed + stages * slot <= da.BLOCK_SMEM_MAX


def test_paged_mxu_plan_at_llama2_7b_keeps_two_blocks_an_sm():
    """bf16, d 128, page 128: 64 d-rows (16 KB) a k stage, 64 tokens a v
    stage, 6 slots, and two blocks on an SM; llama3-8b's G 4 too."""
    for G in (1, 4):
        k_rows, v_rows, stages, smem = da.paged_mxu_plan(128, 128, G, 2)
        assert (k_rows, v_rows, stages) == (64, 64, 6)
        assert da.RING_BLOCKS_PER_SM * (smem + da.BLOCK_SMEM_RESERVED) <= \
            da.SM_SMEM_BYTES


def _mxu_stages(d, bs, G, itemsize, n_pages):
    """The stages K15's producer issues, in order: (page, "k", first
    d-row, d-rows) for the page's k stages, then (page, "v", first token,
    tokens) for its v stages (paged_mxu_kernel's walk)."""
    k_rows, v_rows, _, _ = da.paged_mxu_plan(d, bs, G, itemsize)
    out = []
    for j in range(n_pages):
        out += [(j, "k", r * k_rows, k_rows) for r in range(d // k_rows)]
        out += [(j, "v", r * v_rows, v_rows) for r in range(bs // v_rows)]
    return out


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d,bs", [(128, 128), (64, 16), (256, 40),
                                  (128, 256), (256, 128)])
def test_paged_mxu_stages_cover_every_page_once_in_order(itemsize, d, bs):
    """Each page's d-rows and tokens are copied exactly once, in order,
    and the pages in table order: every sum runs in the order of a walk
    over the whole page."""
    stages = _mxu_stages(d, bs, 4, itemsize, 3)
    for j in range(3):
        for kind, n in (("k", d), ("v", bs)):
            rows = [r for page, what, r0, nr in stages
                    if page == j and what == kind
                    for r in range(r0, r0 + nr)]
            assert rows == list(range(n))
    pages = [page for page, _, _, _ in stages]
    assert pages == sorted(pages)
    kinds = [what for page, what, _, _ in stages if page == 0]
    assert kinds == sorted(kinds)                  # k stages, then v


def test_paged_mxu_plan_constants_are_the_source():
    src = (Path(da.__file__).resolve().parents[2] / "csrc"
           / "paged_decode_attention.cu").read_text()
    assert f"constexpr size_t kStageBytes = {da.RING_TILE_BYTES};" in src
    assert f"constexpr int kMaxStages = {da.RING_MAX_STAGES};" in src
    assert f"constexpr size_t kSmSmem = {da.SM_SMEM_BYTES};" in src
    assert f"constexpr size_t kBlockReserved = {da.BLOCK_SMEM_RESERVED};" \
        in src
    assert da.BLOCK_SMEM_MAX == 227 * 1024
    assert "constexpr size_t kMaxSmem = 227 * 1024;" in src


DECODE_SHAPES = [(B, 4, 4, 128, pos) for B in (1, 8, 16)
                 for pos in (0, 63, 64, 100, 511, 639, 2047)] + [
    (3, 2, 16, 256, 511), (2, 2, 8, 64, 255), (64, 8, 4, 128, 4095),
    (200, 4, 1, 64, 1000)]


@pytest.mark.parametrize("B,nKV,G,d,pos", DECODE_SHAPES)
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True),
                                         (torch.float32, True)])
def test_decode_plan_covers_every_chunk_once_in_order(B, nKV, G, d, pos,
                                                      dtype, quant):
    """K10's cluster: a power of two up to 8 and up to the chunks, one
    wave of B x nKV clusters where it can; its ranks walk every chunk
    exactly once, in order, none idle; the block fits 227 KB."""
    chunk, n_chunks, cluster, smem = da.decode_plan(B, nKV, G, d, pos, dtype,
                                                    quant)
    assert chunk == 32 and n_chunks == -(-(pos + 1) // chunk)
    assert cluster in (1, 2, 4, 8) and cluster <= n_chunks
    assert B * nKV * cluster <= da.DECODE_TARGET_BLOCKS or cluster == 1
    if cluster * 2 <= min(8, n_chunks):    # the next power of two overfills
        assert B * nKV * cluster * 2 > da.DECODE_TARGET_BLOCKS
    ranks = [range(r * n_chunks // cluster, (r + 1) * n_chunks // cluster)
             for r in range(cluster)]       # decode_kernel's c_first, c_end
    assert [c for r in ranks for c in r] == list(range(n_chunks))
    assert all(len(r) >= 1 for r in ranks)
    assert smem <= da.BLOCK_SMEM_MAX


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("G", range(1, 17))
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.float32, True)])
def test_decode_plan_fits_every_gate_shape(d, G, dtype, quant):
    """Every shape K10's gate admits (d 64/128/256, G <= 16) has a block
    that fits; chunks of 32 positions, the same for K10q as for
    K10."""
    chunk, _, _, smem = da.decode_plan(1, 1, G, d, 100, dtype, quant)
    assert smem <= da.BLOCK_SMEM_MAX
    # K10q walks K10's chunks (those of the dequantized cache)
    assert chunk == da.DECODE_CHUNK == \
        da.decode_plan(1, 1, G, d, 100, dtype, not quant)[0]


def test_decode_plan_at_llama1b():
    """llama1b's decode (nKV 4, G 4, d 128, bf16) at pos 639: clusters of
    8 at B 1, 8 and 16 (512 blocks of ~42 KB at B 16: one wave of four an
    SM), of 4 at B 32."""
    plans = [da.decode_plan(B, 4, 4, 128, 639) for B in (1, 8, 16, 32)]
    assert [p[2] for p in plans] == [8, 8, 8, 4]
    assert 4 * (plans[0][3] + da.BLOCK_SMEM_RESERVED) <= da.SM_SMEM_BYTES


def test_decode_plan_constants_are_the_source():
    src = (Path(da.__file__).resolve().parents[2] / "csrc"
           / "decode_attention.cu").read_text()
    for name, value in (("kChunk", da.DECODE_CHUNK),
                        ("kMaxCluster", da.DECODE_MAX_CLUSTER),
                        ("kTargetBlocks", da.DECODE_TARGET_BLOCKS),
                        ("kMaxG", da.DECODE_MAX_G)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


@pytest.mark.parametrize("lo", range(-128, 128, 16))
def test_int8_to_bf16_bits_are_exact(lo):
    """K9's conversion (csrc/quant_matmul.cu, i8_at and bf16_pair): the
    byte w xor 0x80 put into the mantissa of 2^23, minus 2^23 + 128 in
    fp32, is w; its upper 16 bits are w's bf16, for every int8."""
    for w in range(lo, lo + 16):
        u = (w & 0xFF) ^ 0x80
        f = torch.tensor([0x4B000000 | u], dtype=torch.int32).view(
            torch.float32) - 8388736.0
        assert f.item() == w
        bits = f.view(torch.int32).item()
        assert bits & 0xFFFF == 0
        upper = torch.tensor([bits >> 16], dtype=torch.int16).view(
            torch.bfloat16)
        assert upper.item() == w


FLASH_S = [512, 1024, 2048, 4096, 8192, 64, 192, 320, 8256]
FLASH_PARTS = ("fwd", "both", "dq", "dkv")


@pytest.mark.parametrize("part", FLASH_PARTS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S", FLASH_S)
def test_flash_plan_bf16_takes_wgmma_and_fits(S, d, part):
    plan = fa.flash_plan(S, d, torch.bfloat16, part)
    assert plan["variant"] == "wgmma"
    assert plan["rows"] == 128
    assert plan["tile"] == (128 if part == "fwd" else 64)
    assert 2 <= plan["stages"] <= fa.FLASH_MAX_STAGES
    assert plan["smem"] <= fa.FLASH_SMEM
    tile = plan["tile"] * d * 2
    own = 128 * d * 2
    if part == "fwd":     # two q buffers, a k ring, a deeper v ring
        assert plan["v_stages"] >= plan["stages"]
        assert plan["smem"] == (fa.FLASH_SMEM_FIXED + 2 * own
                                + (plan["stages"] + plan["v_stages"]) * tile)
    else:
        n_own = 4 if part == "both" else 2
        assert plan["smem"] == (fa.FLASH_SMEM_FIXED + n_own * own
                                + plan["stages"] * (2 * tile + 512))
    # one more stage would not fit (the ring is as deep as 227 KB allows,
    # up to the cap)
    if plan["stages"] < fa.FLASH_MAX_STAGES and part != "fwd":
        assert plan["smem"] + 2 * tile + 512 > fa.FLASH_SMEM


@pytest.mark.parametrize("part", FLASH_PARTS)
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 256)])
def test_flash_plan_fp32_and_d256_take_fma(dtype, d, part):
    plan = fa.flash_plan(1024, d, dtype, part)
    assert plan["variant"] == "fma"
    assert plan["rows"] == fa.FMA_ROWS
    assert plan["order"] == list(range(1024 // fa.FMA_ROWS))


def _items(plan, bh):
    """The work items (row block, (batch, head) pair) of a "wgmma" plan
    over ``bh`` pairs in the kernels' order (csrc/flash_fwd.cuh,
    block_place): the pairs in chunks, within a chunk the row blocks in
    the plan's order, each taken by every pair of the chunk."""
    order, chunk = plan["order"], plan["chunk"]
    items = []
    for c0 in range(0, bh, chunk):
        pairs = range(c0, min(bh, c0 + chunk))
        items += [(rb, p) for rb in order for p in pairs]
    return items


def _item_tiles(part, S, rb, causal):
    """The (query 64-block, key 64-block) pairs a work item of row block
    rb visits, and how many ring tiles that is (its work)."""
    rows = [r for r in (2 * rb, 2 * rb + 1) if r < S // 64]
    pairs, n = [], 0
    if part in ("fwd", "dq", "both"):         # query rows over key tiles
        keys = 2 * rb + 2 if causal else -(-S // 64)
        keys = min(keys, S // 64)
        pairs += [(q, k) for q in rows for k in range(keys)
                  if not causal or k <= q]
        n += -(-keys // 2) if part == "fwd" else keys
    if part in ("dkv", "both"):               # keys over query tiles
        first = 2 * rb if causal else 0
        pairs += [(q, k) for k in rows for q in range(first, S // 64)
                  if not causal or k <= q]
        n += S // 64 - first
    return pairs, n


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("part", FLASH_PARTS)
@pytest.mark.parametrize("S,d,bh", [(512, 128, 256), (1024, 64, 256),
                                    (8192, 128, 16), (2048, 128, 32),
                                    (192, 64, 6), (8256, 128, 3)])
def test_flash_order_covers_every_causal_tile_once(S, d, bh, part, causal):
    plan = fa.flash_plan(S, d, torch.bfloat16, part, causal=causal, bh=bh)
    nrb = -(-S // 128)
    items = _items(plan, bh)
    assert sorted(items) == [(rb, p) for rb in range(nrb) for p in range(bh)]
    assert plan["chunk"] >= 1 and (plan["chunk"] == bh
                                   or plan["chunk"] * 4 * S * d
                                   <= fa.FLASH_L2_CHUNK)
    loops = ("dq", "dkv") if part == "both" else (part,)
    for loop in loops:
        seen = {}
        for rb, p in items:
            for pair in _item_tiles(loop, S, rb, causal)[0]:
                seen[(p, pair)] = seen.get((p, pair), 0) + 1
        want = {(p, (q, k)) for p in range(bh) for q in range(S // 64)
                for k in range(S // 64) if not causal or k <= q}
        assert set(seen) == want and set(seen.values()) == {1}
    # heaviest first within each chunk (equal work for K2 and non-causal)
    per = nrb * plan["chunk"]
    for c0 in range(0, len(items), per):
        work = [_item_tiles(part, S, rb, causal)[1]
                for rb, _ in items[c0:c0 + per]]
        assert work == sorted(work, reverse=True)


def test_flash_plan_constants_are_the_sources():
    src = (Path(fa.__file__).resolve().parents[2] / "csrc"
           / "flash_fwd.cuh").read_text()
    for name, value in (("kWgRows", fa.FLASH_ROWS),
                        ("kFwdKeys", fa.FLASH_FWD_KEYS),
                        ("kBwdTile", fa.FLASH_BWD_TILE),
                        ("kMaxStages", fa.FLASH_MAX_STAGES),
                        ("kSmemMax", fa.FLASH_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kSmemFixed = 1024 + 256;" in src
    assert "constexpr long long kL2Chunk = 16ll << 20;" in src
    assert fa.FLASH_SMEM_FIXED == 1024 + 256
    assert fa.FLASH_L2_CHUNK == 16 << 20


def _reporting_entry(code: int, err: int = 0):
    """A stand-in for a flash C entry: writes ``code`` to its trailing
    *variant out-parameter and returns ``err``."""
    def c_fn(*args):
        args[-1]._obj.value = code
        return err
    return c_fn


def test_flash_counters_take_the_launched_variant():
    """A launch is counted under the variant its launcher reported: a bf16
    d 64 launch reported as the FMA kernel counts as "fma" (which
    chip_smoke's per-phase check then refuses), and an error raises
    before anything is counted."""
    def entry():
        pass

    entry.launches = entry.launches_wgmma = entry.launches_fma = 0
    before = collections.Counter(fa.LAUNCHES_BY_PLAN)
    try:
        for code in (1, 0, 1):
            variant = fa._launch(_reporting_entry(code), "entry", 7, 8)
            fa._count(entry, (2, 512, 4, 64), torch.bfloat16, "fwd", variant)
        with pytest.raises(RuntimeError, match="entry: CUDA error 9"):
            fa._launch(_reporting_entry(1, err=9), "entry", 7)
        diff = fa.LAUNCHES_BY_PLAN - before
    finally:
        fa.LAUNCHES_BY_PLAN.clear()
        fa.LAUNCHES_BY_PLAN.update(before)
    assert (entry.launches, entry.launches_wgmma, entry.launches_fma) == \
        (3, 2, 1)
    assert diff == {("wgmma", "bfloat16", 64, 512, "fwd", 8): 2,
                    ("fma", "bfloat16", 64, 512, "fwd", 8): 1}


CE_SHAPES = [(16384, 1024, 50304), (4096, 2048, 50304),
             (300, 128, ce.SLAB + 1000)]
CE_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", CE_DTYPES)
@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_ce_plan_takes_the_route_and_fits(N, H, V, dtype):
    """bf16 products take the TMA + wgmma route (128 x 256 tiles, or 128
    x 128 under one wave; "stats" always 256 wide), fp32 the FMA one;
    every launch fits 227 KB with a ring of at least 2 stages; the
    persistent grid is one block a SM, up to the tiles."""
    plan = ce.ce_plan(N, H, V, dtype)
    slabs = -(-V // ce.SLAB)
    assert [e["product"] for e in plan] == \
        ["stats"] + ["dl", "dx", "dw"] * slabs
    for e in plan:
        assert e["smem"] <= ce.CE_SMEM
        assert e["stages"] >= 2
        if dtype == torch.bfloat16:
            assert e["variant"] == "wgmma"
            assert (e["bm"], e["bk"]) == (128, 64)
            assert e["bn"] in (128, 256)
            assert e["bn"] == 256 or (e["product"] != "stats"
                                      and e["tiles"] * 2 < 2 * 132)
            assert e["grid"] == min(e["tiles"], ce.H100_SMS)
            assert e["smem"] == ce.WG_SMEM_FIXED + e["stages"] * (
                (128 + e["bn"]) * 64 * 2)
        else:
            assert e["variant"] == "fma"
            assert (e["bm"], e["bn"], e["bk"]) == (128, 128, 32)
            assert e["grid"] == e["tiles"]


def test_ce_plan_at_gpt3_350m():
    """The flagship's products: 256-wide tiles with a 4-stage ring, the
    statistics over the rows fastest (x stays in L2, w streams once),
    the backward's over the columns (w's slab or x stays in L2), and 128
    wide only for the last slab's dw (36 tiles of 256 under a wave)."""
    plan = ce.ce_plan(16384, 1024, 50304)
    assert plan[0]["tiles"] == 128 * 197 and not plan[0]["raster_n"]
    assert all(e["raster_n"] for e in plan[1:])
    assert [e["bn"] for e in plan] == [256] * 21 + [128]
    assert {e["stages"] for e in plan[:-1]} == {4}


def _tile_origin(e, tile):
    """(row, column) of tile ``tile``'s first output element under a
    ce_plan entry, as csrc/fused_ce.cu's wg_place puts it (the fp32
    grid's blockIdx.x is the column tile, raster_n True)."""
    mt, nt = -(-e["M"] // e["bm"]), -(-e["Nn"] // e["bn"])
    mi, ni = ((tile // nt, tile % nt) if e["raster_n"]
              else (tile % mt, tile // mt))
    return mi * e["bm"], ni * e["bn"]


def _cover(e):
    """Each output tile's count over the persistent blocks' walks (block
    b takes tiles b, b + grid, ...; the fp32 grid one tile a block)."""
    counts = collections.Counter()
    for b in range(e["grid"]):
        for tile in range(b, e["tiles"], e["grid"]):
            m0, n0 = _tile_origin(e, tile)
            assert 0 <= m0 < e["M"] and 0 <= n0 < e["Nn"]
            assert m0 % e["bm"] == 0 and n0 % e["bn"] == 0
            counts[m0, n0] += 1
    return counts


@pytest.mark.parametrize("dtype", CE_DTYPES)
@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_ce_plan_covers_every_output_tile_once(N, H, V, dtype):
    """Every output tile of each product is taken by exactly one block,
    once; the products' shapes are the slab's (dl [N, wc] over H, dx
    [N, H] over wc, dw [wc, H] over N) and the slabs cover the vocabulary
    in order."""
    plan = ce.ce_plan(N, H, V, dtype)
    for e in plan:
        counts = _cover(e)
        want = {(m, n) for m in range(0, e["M"], e["bm"])
                for n in range(0, e["Nn"], e["bn"])}
        assert set(counts) == want and set(counts.values()) == {1}
        assert e["tiles"] == len(want)
    assert (plan[0]["M"], plan[0]["Nn"], plan[0]["K"]) == (N, V, H)
    v0 = 0
    for dl, dx, dw in zip(plan[1::3], plan[2::3], plan[3::3]):
        wc = min(ce.SLAB, V - v0)
        assert dl["v0"] == dx["v0"] == dw["v0"] == v0
        assert (dl["M"], dl["Nn"], dl["K"]) == (N, wc, H)
        assert (dx["M"], dx["Nn"], dx["K"]) == (N, H, wc)
        assert (dw["M"], dw["Nn"], dw["K"]) == (wc, H, N)
        v0 += wc
    assert v0 == V


def test_ce_plan_constants_are_the_source():
    src = (Path(ce.__file__).resolve().parents[2] / "csrc"
           / "fused_ce.cu").read_text()
    for name, value in (("kWgBM", ce.WG_BM), ("kWgBK", ce.WG_BK),
                        ("kWgMaxStages", ce.WG_MAX_STAGES),
                        ("kSmemMax", ce.CE_SMEM), ("kGT", ce.FMA_TILE),
                        ("kGK", ce.FMA_BK), ("kGStages", ce.FMA_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"constexpr int kDlStaging = {ce.WG_STAGING};" in src
    assert ("constexpr int kSmemFixed =             // alignment, barriers, "
            "dl staging\n    1024 + 16 * kWgMaxStages + 8 * kDlStaging;") \
        in src
    assert ce.WG_SMEM_FIXED == 1024 + 16 * ce.WG_MAX_STAGES + \
        8 * ce.WG_STAGING
    assert "constexpr int kFmaSmem = 4 * 2 * kGStages * kGStage;" in src
    assert "constexpr int kGStage = kGT * kP;" in src
    assert ce.FMA_SMEM == 4 * 2 * ce.FMA_STAGES * ce.FMA_TILE * (
        ce.FMA_BK + 4)
    assert "enum { EPI_DL = 0, EPI_DX = 1, EPI_DW = 2, EPI_STATS = 3 };" \
        in src
    assert ce._PRODUCTS == ("dl", "dx", "dw", "stats")


def test_ce_products_count_the_launched_variant(monkeypatch):
    """``PRODUCTS`` counts what the C entry reports it launched, one
    product for the forward and three a slab for the backward."""
    def entry(code):
        def fn(*args):
            args[-1]._obj.value = code
            return 0
        return fn

    before = collections.Counter(ce.PRODUCTS)
    monkeypatch.setattr(ce, "_kernel", lambda name: entry(1))
    ce._launch("ce_fwd", ("stats",), torch.bfloat16)
    ce._launch("ce_bwd", ("dl", "dx", "dw") * 2, torch.bfloat16)
    monkeypatch.setattr(ce, "_kernel", lambda name: entry(0))
    ce._launch("ce_fwd", ("stats",), torch.float32)
    diff = ce.PRODUCTS - before
    assert diff == {("wgmma", "bfloat16", "stats"): 1,
                    ("wgmma", "bfloat16", "dl"): 2,
                    ("wgmma", "bfloat16", "dx"): 2,
                    ("wgmma", "bfloat16", "dw"): 2,
                    ("fma", "float32", "stats"): 1}


def _walk(plan, n, f):
    """Every (thread, row, first element) bias_gelu_kernel touches,
    following its loops: thread (tr, tc) of block (bx, by) on column
    vector bx cols + tc, passes r = by rows + tr, + unroll stride, ...
    while r < n, each loading rows r + k stride < n (k < unroll)."""
    vec, cols, rows, unroll = (plan["vec"], plan["cols"], plan["rows"],
                               plan["unroll"])
    gx, gy = plan["grid"]
    bx, by, tid = (a.ravel() for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(fba.THREADS), indexing="ij"))
    tr, c = tid // cols, (bx * cols + tid % cols) * vec
    active = (tr < rows) & (c < f)
    thread = np.flatnonzero(active)
    r0, c = (by * rows + tr)[active], c[active]
    stride = gy * rows
    passes = -(-n // (unroll * stride)) + 1
    j = np.arange(passes)[:, None, None]
    k = np.arange(unroll)[None, :, None]
    r = r0[None, None, :] + j * unroll * stride
    rk = r + k * stride
    ok = (r < n) & (rk < n)
    shape = ok.shape
    return (np.broadcast_to(thread, shape)[ok], rk[ok],
            np.broadcast_to(c, shape)[ok])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("f", [8, 64, 200, 1000, 2056, 4096, 5504])
@pytest.mark.parametrize("n,resident", [(1, 1056), (7, 1056), (300, 1056),
                                        (300, 5), (1027, 64), (2048, 1)])
def test_bias_gelu_walk_covers_every_element_once(itemsize, f, n, resident):
    """K7: every 16-byte vector of [n, f] is read and written by exactly
    one thread, once; each thread stays on one column vector (its bias
    values are read once); the grid is WAVES times what the card holds,
    spread over the row's column blocks, up to one pass a thread."""
    plan = fba.bias_gelu_plan(n, f, itemsize, resident)
    vec = 16 // itemsize
    assert plan["vec"] == vec and plan["cols"] * plan["rows"] <= 256
    gx, gy = plan["grid"]
    assert gx * plan["cols"] * vec >= f > (gx - 1) * plan["cols"] * vec
    assert gy == max(1, min(fba.WAVES * resident // gx,
                            -(-n // (plan["rows"] * plan["unroll"]))))
    thread, row, col = _walk(plan, n, f)
    assert (col % vec == 0).all() and (col < f).all() and (row < n).all()
    counts = np.bincount(row * (f // vec) + col // vec,
                         minlength=n * (f // vec))
    assert (counts == 1).all()
    # one column vector a thread: its bias values are read once
    firsts = {}
    for t, cc in zip(thread.tolist(), col.tolist()):
        assert firsts.setdefault(t, cc) == cc


def test_bias_gelu_walk_at_gpt3_350m():
    """gpt3-350m's FFN [16384, 4096] bf16 on the H100, which holds 4
    blocks of the kernel an SM (60 registers a thread): two blocks of 256
    vectors span a row, 8 x 528 / 2 = 2112 walk the rows, 7-8 rows a
    thread in passes of 4 loads in flight; at 1027 rows the grid stops
    at one pass a thread."""
    plan = fba.bias_gelu_plan(16384, 4096, 2, 4 * 132)
    assert (plan["cols"], plan["rows"], plan["grid"]) == (256, 1, (2, 2112))
    assert plan["unroll"] == 4
    assert fba.bias_gelu_plan(1027, 4096, 2, 4 * 132)["grid"] == (2, 257)


def test_bias_gelu_walk_constants_are_the_source():
    src = (Path(fba.__file__).resolve().parents[2] / "csrc"
           / "fused_bias_act.cu").read_text()
    assert f"constexpr int kThreads = {fba.THREADS};" in src
    assert f"constexpr int kUnroll = {fba.UNROLL};" in src
    assert f"constexpr int kWaves = {fba.WAVES};" in src


# ---- K8 / K8q: the split plan (ragged_paged_attention.rpa_plan) -----------

RPA_MB = [1, 2, 3, 5, 12, 16, 17, 32, 64]
RPA_BS = [64, 128, 256]


def _rpa_tiles(plan, mb, bs, last):
    """The tiles rpa_wg_kernel's blocks load for a chunk whose last valid
    key is ``last``, in split order: (split, page index in rows[c], first
    key of the tile in the page), following its n_act and n_tiles."""
    pps, splits = plan["pages_per_split"], plan["splits"]
    tk = plan["tile_keys"]
    split_keys = pps * bs
    n_act = min(splits, last // split_keys + 1)
    out = []
    for s in range(splits):
        key0 = s * split_keys
        n_tiles = 0
        if s < n_act:
            n_tiles = min(min(split_keys, mb * bs - key0),
                          last - key0 + 1 + tk - 1) // tk
        out += [(s, s * pps + j // (bs // tk), (j % (bs // tk)) * tk)
                for j in range(n_tiles)]
    return out


def _rpa_lasts(plan, mb, bs):
    """Last valid keys at the edges: 0, a tile's, a page's and a split's
    edges (each side), the table's end, and one past it."""
    ends = {0, 1, 63, 64, 65, bs - 1, bs, mb * bs - 1, mb * bs, mb * bs + 5}
    for s in range(1, plan["splits"] + 1):
        e = s * plan["pages_per_split"] * bs
        ends |= {e - 1, e, e + 1}
    return sorted(ends)


@pytest.mark.parametrize("bs", RPA_BS)
@pytest.mark.parametrize("mb", RPA_MB)
def test_rpa_splits_cover_every_page_once_in_order(mb, bs):
    """For every last valid key, the active splits load pages 0 ..
    min(last // bs, mb - 1) of the chunk's table, each tile of 64 keys up
    to the last one's once, in key order (split order is key order); the
    splits past the chunk's last key load nothing, and the active ones
    are ranks 0 .. n_act - 1. At d 64 and 128, bf16 and int8 pages."""
    for d in (64, 128):
        for quant in (False, True):
            plan = rpa.rpa_plan(mb, bs, d, 4, 16, torch.bfloat16, quant)
            assert plan["variant"] == "wgmma"
            pps = plan["pages_per_split"]
            for last in _rpa_lasts(plan, mb, bs):
                tiles = _rpa_tiles(plan, mb, bs, last)
                keys = [page * bs + t0 for _, page, t0 in tiles]
                assert keys == list(range(0, min(last + 1, mb * bs), 64))
                pages = sorted({page for _, page, _ in tiles})
                assert pages == list(range(min(last // bs, mb - 1) + 1))
                active = sorted({s for s, _, _ in tiles})
                assert active == list(range(len(active)))
                assert all(s * pps <= page < (s + 1) * pps
                           for s, page, _ in tiles)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bs", RPA_BS + [512])
@pytest.mark.parametrize("mb", RPA_MB)
def test_rpa_plan_fits(mb, bs, quant):
    """Every geometry the wgmma route takes (d 64 and 128, G 1-16, qb
    1-32): at most 8 splits (a portable cluster), each of at least 1024
    keys (or the whole table) unless that would make more than 8, the
    splits tiling the table; 1-4 ring stages, no more than a split's
    tiles; the ring and the combine fit 227 KB and leave room for three
    blocks an SM; 64-row tiles cover the qb x G query rows."""
    for d in (64, 128):
        for G in (1, 2, 4, 8, 16):
            for qb in (1, 4, 16, 32):
                p = rpa.rpa_plan(mb, bs, d, G, qb, torch.bfloat16, quant)
                pps, splits = p["pages_per_split"], p["splits"]
                assert p["variant"] == "wgmma" and p["tile_keys"] == 64
                assert 1 <= splits <= rpa.RPA_MAX_CLUSTER
                assert (splits - 1) * pps < mb <= splits * pps
                least = -(-rpa.RPA_SPLIT_KEYS // bs)
                assert pps >= least
                if pps > least:           # larger only to keep 8 splits
                    assert -(-mb // (pps - 1)) > rpa.RPA_MAX_CLUSTER
                assert 1 <= p["stages"] <= min(rpa.RPA_MAX_STAGES,
                                               pps * bs // 64)
                stage = 2 * 64 * d * (1 if quant else 2)
                ring = p["stages"] * stage + (2 * 64 * d * 2 if quant
                                              else 0)
                combine = 4 * (64 * (d + 8) + 2 * 64 + 8 * 64 + 64)
                assert p["smem"] == rpa.RPA_SMEM_FIXED + max(ring, combine)
                assert p["smem"] <= rpa.BLOCK_SMEM_MAX
                assert p["blocks_per_sm"] >= rpa.RPA_BLOCKS_PER_SM
                assert rpa.RPA_BLOCKS_PER_SM * (
                    p["smem"] + rpa.BLOCK_SMEM_RESERVED) <= rpa.SM_SMEM_BYTES
                assert p["row_tiles"] == -(-qb * G // 64)


def test_rpa_plan_at_llama3_8b():
    """The engine's step (mb 16, page 128, d 128, G 4, qb 16): 2 splits
    of 8 pages (16 tiles of 64 keys), one 64-row tile; a 2-stage bf16
    ring, or a 2-stage int8 ring beside the bf16 tile, ~65 KB either way:
    three blocks an SM. At mb 32, 4 splits of 8 pages."""
    for quant in (False, True):
        p = rpa.rpa_plan(16, 128, 128, 4, 16, torch.bfloat16, quant)
        assert (p["pages_per_split"], p["splits"], p["row_tiles"],
                p["stages"], p["smem"], p["blocks_per_sm"]) == \
            (8, 2, 1, 2, 66688, 3)
    p = rpa.rpa_plan(32, 128, 128, 4, 16, torch.bfloat16)
    assert (p["pages_per_split"], p["splits"]) == (8, 4)


@pytest.mark.parametrize("dtype,d,bs,want", [
    (torch.bfloat16, 128, 16, "mma"), (torch.bfloat16, 64, 32, "mma"),
    (torch.bfloat16, 128, 48, "mma"), (torch.bfloat16, 256, 128, "fma"),
    (torch.float32, 128, 128, "fma"), (torch.float32, 64, 16, "fma"),
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 64, 64, "wgmma")])
def test_rpa_plan_routes(dtype, d, bs, want):
    """bf16 at d 64/128 takes wgmma where 64-key boxes tile the page and
    mma.sync on pages of 16, 32 or 48 tokens; fp32 and d 256 the FMA
    kernel, whose one block a (chunk, kv head) walks every page."""
    for quant in (False, True):
        p = rpa.rpa_plan(12, bs, d, 2, 4, dtype, quant)
        assert p["variant"] == want
        if want != "wgmma":
            assert (p["splits"], p["pages_per_split"]) == (1, 12)
            assert p["tile_keys"] == (32 if bs % 32 == 0 else 16)
        assert p["smem"] <= rpa.BLOCK_SMEM_MAX


@pytest.mark.parametrize("args", [(16, 100, 128, 4, 16), (16, 128, 96, 4, 16),
                                  (0, 128, 128, 4, 16), (16, 128, 128, 0, 16)])
def test_rpa_plan_refuses_other_geometry(args):
    with pytest.raises(ValueError):
        rpa.rpa_plan(*args)


def test_rpa_plan_reads_no_per_call_tensor():
    """The plan's arguments are the geometry alone: no pos0, n_valid, C,
    page ids or tensor; equal geometries give equal plans."""
    import inspect

    params = list(inspect.signature(rpa.rpa_plan).parameters)
    assert params == ["mb", "bs", "d", "G", "qb", "dtype", "quant"]
    assert rpa.rpa_plan(16, 128, 128, 4, 16) == \
        rpa.rpa_plan(16, 128, 128, 4, 16, torch.bfloat16, False)


def test_rpa_plan_constants_are_the_source():
    src = (Path(rpa.__file__).resolve().parents[2] / "csrc"
           / "ragged_paged_attention.cu").read_text()
    for name, value in (("kRows", rpa.RPA_ROWS),
                        ("kTileKeys", rpa.RPA_TILE_KEYS),
                        ("kSplitKeys", rpa.RPA_SPLIT_KEYS),
                        ("kMaxCluster", rpa.RPA_MAX_CLUSTER),
                        ("kBlocksPerSm", rpa.RPA_BLOCKS_PER_SM),
                        ("kMaxStages", rpa.RPA_MAX_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"constexpr size_t kSmSmem = {rpa.SM_SMEM_BYTES};" in src
    assert f"constexpr size_t kBlockReserved = {rpa.BLOCK_SMEM_RESERVED};" \
        in src
    assert "constexpr size_t kMaxSmem = 227 * 1024;" in src
    assert rpa.BLOCK_SMEM_MAX == 227 * 1024
    assert "constexpr int kSmemFixed = 1024 + 128;" in src
    assert rpa.RPA_SMEM_FIXED == 1024 + 128


def test_rpa_counters_take_the_launched_variant(monkeypatch):
    """A launch is counted under the variant its C entry reported, keyed
    by its geometry, and an error raises before anything is counted."""
    import types

    def entry(code, err=0):
        def c_fn(*args):
            args[-1]._obj.value = code
            return err
        return c_fn

    monkeypatch.setattr(rpa.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros((2, 16, 32, 128), dtype=torch.bfloat16)
    kp = torch.zeros((3, 8, 128, 128), dtype=torch.int8)
    vp = torch.zeros((3, 8, 128, 128), dtype=torch.int8)
    sc = torch.ones((3, 8))
    ints = (torch.zeros((2, 16), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
    try:
        for code, scales in ((2, ()), (1, ()), (2, (sc, sc))):
            monkeypatch.setitem(rpa._fns, "rpa_forward", entry(code))
            monkeypatch.setitem(rpa._fns, "rpa_forward_int8", entry(code))
            name = "rpa_forward_int8" if scales else "rpa_forward"
            rpa._launch(name, q, kp, vp, scales, *ints, 0.1)
        monkeypatch.setitem(rpa._fns, "rpa_forward", entry(2, err=9))
        with pytest.raises(RuntimeError, match="rpa_forward: CUDA error 9"):
            rpa._launch("rpa_forward", q, kp, vp, (), *ints, 0.1)
        diff = rpa.LAUNCHES_BY_PLAN - before
    finally:
        rpa.LAUNCHES_BY_PLAN.clear()
        rpa.LAUNCHES_BY_PLAN.update(before)
    key = ("bfloat16", 128, 128, 16, 4, 16)
    assert diff == {("wgmma", *key, False): 1, ("mma", *key, False): 1,
                    ("wgmma", *key, True): 1}


def _rpa_operands():
    C, qb, nH, nkv, d, bs, mb, P = 4, 16, 32, 8, 128, 128, 16, 9
    return dict(q=torch.zeros((C, qb, nH, d), dtype=torch.bfloat16),
                kp=torch.zeros((P, nkv, d, bs), dtype=torch.bfloat16),
                vp=torch.zeros((P, nkv, bs, d), dtype=torch.bfloat16),
                rows=torch.zeros((C, mb), dtype=torch.int32),
                pos0=torch.zeros(C, dtype=torch.int32),
                nv=torch.ones(C, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    {"q": torch.zeros((4, 16, 32, 128), dtype=torch.float16)},
    {"kp": torch.zeros((9, 8, 128, 128), dtype=torch.float32)},
    {"vp": torch.zeros((9, 8, 64, 128), dtype=torch.bfloat16)},
    {"q": torch.zeros((4, 16, 36, 128), dtype=torch.bfloat16)},
    {"kp": torch.zeros((9, 8, 128, 40), dtype=torch.bfloat16),
     "vp": torch.zeros((9, 8, 40, 128), dtype=torch.bfloat16)},
    {"rows": torch.zeros((4, 16), dtype=torch.int64)},
    {"pos0": torch.zeros(3, dtype=torch.int32)},
    {"nv": torch.ones((4, 1), dtype=torch.int32)},
    {"rows": torch.zeros((16, 4), dtype=torch.int32).t()},
    {"q": torch.zeros((4, 16, 32, 129), dtype=torch.bfloat16)[..., 1:]},
])
def test_rpa_wrapper_checks_refuse_bad_operands(bad):
    """The CUDA arm's checks (run before any launch) refuse a wrong
    dtype, shape, head count, page size, index dtype or shape, and a
    non-contiguous operand, whatever the device."""
    ops = {**_rpa_operands(), **bad}
    with pytest.raises((TypeError, ValueError)):
        rpa._check_cuda(ops["q"], ops["kp"], ops["vp"], ops["rows"],
                        ops["pos0"], ops["nv"], torch.bfloat16)


def test_rpa_wrapper_checks_take_good_operands():
    ops = _rpa_operands()
    rpa._check_cuda(ops["q"], ops["kp"], ops["vp"], ops["rows"],
                    ops["pos0"], ops["nv"], torch.bfloat16)


LORA_ROOM = lm.SM_SMEM_BYTES // lm.BLOCKS_PER_SM - lm.BLOCK_SMEM_RESERVED


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("r", [4, 8, 16])
@pytest.mark.parametrize("H", [128, 4096, 14336])
@pytest.mark.parametrize("N", [128, 1024, 4096])
def test_lora_plan_fits_and_its_slices_cover_h_and_n(N, H, r, itemsize):
    """Three blocks an SM; a cluster of 1-8 blocks (a power of two, the
    most that divides H / 128); block k's H slice and N slice, over the
    cluster, cover every column once; B's slice staged where it fits;
    the stages of a row group copy the block's H slice once, chunk by
    chunk in order, with the chunk's rows of A."""
    p = lm.lora_plan(H, N, r, itemsize)
    assert p["smem"] <= LORA_ROOM and p["smem"] <= 227 * 1024
    assert p["cluster"] in (1, 2, 4, 8) and 2 <= p["stages"] <= 4
    assert p["threads"] == 8 * 32 + 32
    cl = p["cluster"]
    h_cols = [h for k in range(cl)
              for h in range(k * p["h_slice"], (k + 1) * p["h_slice"])]
    n_cols = [n for k in range(cl)
              for n in range(k * p["n_slice"], (k + 1) * p["n_slice"])]
    assert h_cols == list(range(H)) and n_cols == list(range(N))
    assert p["n_slice"] % 16 == 0                # 16-byte output runs
    assert (H // 128) % cl == 0 and (cl == 8 or (H // 128) % (2 * cl))
    chunks = p["h_slice"] // p["h_chunk"]
    assert chunks * p["h_chunk"] == p["h_slice"]
    for k in range(cl):                          # one row group's stages
        cols = [h for c in range(chunks)
                for h in range(k * p["h_slice"] + c * p["h_chunk"],
                               k * p["h_slice"] + (c + 1) * p["h_chunk"])]
        assert cols == h_cols[k * p["h_slice"]:(k + 1) * p["h_slice"]]
    stage = (lm.ROW_GROUP * (p["h_chunk"] + lm.X_PAD)
             + p["h_chunk"] * r) * itemsize
    b_bytes = r * p["n_slice"] * itemsize
    assert p["b_stage"] == (b_bytes <= lm.B_STAGE_BYTES)
    assert p["smem"] == lm.BAR_BYTES + p["b_stage"] * b_bytes \
        + 4 * (2 * 8 + 1 + 8) * lm.ROW_GROUP * r + p["stages"] * stage
    # the tensor-core route: each of the 8 warps takes whole k16 steps
    assert p["h_chunk"] % (16 * lm.WARPS) == 0


def test_lora_plan_at_the_llama3_8b_step():
    """The multi-tenant step's q (N 4096) and v (N 1024) deltas: clusters
    of 8, 512 columns of H a block, 512 and 128 columns of N: 256 blocks
    at C 32 for both, all on the card at once (three an SM); qb 16 is one
    row group, one stage, B's slice staged: every byte a block reads is
    in flight at once."""
    for N, n_slice in ((4096, 512), (1024, 128)):
        p = lm.lora_plan(4096, N, 8, 2)
        assert (p["cluster"], p["h_slice"], p["n_slice"], p["h_chunk"],
                p["b_stage"]) == (8, 512, n_slice, 512, 1)
        assert p["stages"] >= 16 // lm.ROW_GROUP
        assert 32 * p["cluster"] <= 132 * lm.BLOCKS_PER_SM


def test_lora_plan_takes_no_per_call_argument():
    """A row's bits depend on the plan, so the plan reads (H, N, r,
    itemsize) alone: never C, qb or ids."""
    import inspect

    assert list(inspect.signature(lm.lora_plan).parameters) == \
        ["H", "N", "r", "itemsize"]


@pytest.mark.parametrize("args", [(300, 1024, 8, 2), (4096, 1000, 8, 2),
                                  (4096, 1024, 12, 2), (4096, 1024, 32, 4),
                                  (4096, 1024, 8, 1), (0, 128, 8, 2)])
def test_lora_plan_refuses_shapes_outside_the_gate(args):
    with pytest.raises(ValueError):
        lm.lora_plan(*args)


def test_lora_plan_constants_are_the_source():
    src = (Path(lm.__file__).resolve().parents[2] / "csrc"
           / "lora_matmul.cu").read_text()
    for name, value in (("kRowGroup", lm.ROW_GROUP),
                        ("kMaxCluster", lm.MAX_CLUSTER),
                        ("kMaxStages", lm.MAX_STAGES),
                        ("kBlocksPerSm", lm.BLOCKS_PER_SM),
                        ("kBStageBytes", lm.B_STAGE_BYTES),
                        ("kXPad", lm.X_PAD), ("kWarps", lm.WARPS),
                        ("kBarBytes", lm.BAR_BYTES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"constexpr size_t kSmSmem = {lm.SM_SMEM_BYTES};" in src
    assert f"constexpr size_t kBlockReserved = {lm.BLOCK_SMEM_RESERVED};" \
        in src
    assert "constexpr int kThreads = kConsumers + 32;" in src


def test_lora_counters_take_the_launched_variant(monkeypatch):
    """A launch is counted under the variant its C entry reported, keyed
    by its shape; an error, or a qb outside the gate, raises before
    anything is counted."""
    import types

    def entry(code, err=0):
        def c_fn(*args):
            args[-1]._obj.value = code
            return err
        return c_fn

    monkeypatch.setattr(lm.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros((2, 16, 256), dtype=torch.bfloat16)
    a = torch.zeros((3, 256, 8), dtype=torch.bfloat16)
    b = torch.zeros((3, 8, 1024), dtype=torch.bfloat16)
    ids = torch.zeros(2, dtype=torch.int32)
    before = collections.Counter(lm.LAUNCHES_BY_PLAN)
    try:
        monkeypatch.setitem(lm._fns, "lora_matmul", entry(0))
        out = lm._launch(x, a, b, ids)
        monkeypatch.setitem(lm._fns, "lora_matmul", entry(0, err=9))
        with pytest.raises(RuntimeError, match="lora_matmul: CUDA error 9"):
            lm._launch(x, a, b, ids)
        with pytest.raises(ValueError):
            lm._launch(x[:, :12], a, b, ids)
        diff = lm.LAUNCHES_BY_PLAN - before
    finally:
        lm.LAUNCHES_BY_PLAN.clear()
        lm.LAUNCHES_BY_PLAN.update(before)
    assert out.shape == (2, 16, 1024) and out.dtype == torch.float32
    assert diff == {("cluster", "bfloat16", 256, 1024, 8): 1}


DMA_ROOM = da.SM_SMEM_BYTES // da.RING_BLOCKS_PER_SM - da.BLOCK_SMEM_RESERVED


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_paged_dma_plan_fits_two_blocks_an_sm(itemsize, d, bs):
    tile, ks, vs, threads, smem = da.paged_dma_plan(d, bs, itemsize)
    assert smem <= DMA_ROOM
    assert bs % tile == 0 and tile % 8 == 0
    assert tile * d * itemsize <= da.RING_TILE_BYTES
    assert 2 <= ks <= vs <= da.RING_MAX_STAGES and vs - ks <= 1
    assert threads == da.DMA_THREADS == 320
    assert smem == da.DMA_BAR_BYTES + 4 * (d + 2 * bs + 4) \
        + (ks + vs) * tile * d * itemsize


def _dma_walks(d, bs, itemsize, n_pages):
    """The two producers' walks as the kernel issues them: for stage i of
    each ring, (slot, page, first row, rows); and the order in which the
    warpgroups consume them, the score warpgroup up to two pages ahead
    of the value warpgroup (its two score buffers)."""
    tile, ks, vs, _, _ = da.paged_dma_plan(d, bs, itemsize)
    tpp = bs // tile
    walks = {kind: [(i % st, i // tpp, (i % tpp) * tile, tile)
                    for i in range(n_pages * tpp)]
             for kind, st in (("k", ks), ("v", vs))}
    order = []
    for j in range(n_pages + 1):                 # scores of page j while
        if j < n_pages:                          # page j - 1's values run
            order += [("k", j)] * tpp
        if j:
            order += [("v", j - 1)] * tpp
    return walks, order, tile


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_paged_dma_stages_cover_every_page_once_in_order(itemsize, d, bs):
    """Each page's k rows and v rows are staged exactly once, in order,
    the pages in table order, each ring's slots in turn; a page's k
    tiles are consumed (its scores, its softmax) before its v tiles."""
    n_pages = 3
    walks, order, tile = _dma_walks(d, bs, itemsize, n_pages)
    for kind, walk in walks.items():
        stages = da.paged_dma_plan(d, bs, itemsize)[1 if kind == "k" else 2]
        assert [w[0] for w in walk] == [i % stages for i in range(len(walk))]
        for j in range(n_pages):
            rows = [r for _, page, r0, n in walk if page == j
                    for r in range(r0, r0 + n)]
            assert rows == list(range(bs))
        pages = [page for _, page, _, _ in walk]
        assert pages == sorted(pages)
    for j in range(n_pages):
        last_k = max(i for i, e in enumerate(order) if e == ("k", j))
        first_v = min(i for i, e in enumerate(order) if e == ("v", j))
        assert last_k < first_v


def test_paged_dma_plan_at_llama2_7b():
    """B 8, 32 heads of 128, page 128, bf16: stages of 64 rows, three in
    each ring (96 KB in flight a block), two blocks an SM, so the 256
    blocks run in one wave."""
    tile, ks, vs, threads, smem = da.paged_dma_plan(128, 128, 2)
    assert (tile, ks, vs, threads) == (64, 3, 3, 320)
    assert 2 * smem + 2 * da.BLOCK_SMEM_RESERVED <= da.SM_SMEM_BYTES


def test_paged_dma_plan_constants_are_the_source():
    src = (Path(da.__file__).resolve().parents[2] / "csrc"
           / "paged_decode_attention.cu").read_text()
    assert "constexpr int kDmaThreads = 2 * kThreads + 64;" in src
    assert da.DMA_THREADS == 2 * 128 + 64
    assert f"constexpr int kDmaBarBytes = {da.DMA_BAR_BYTES};" in src
    assert "paged_dma_kernel<T, D><<<dim3(nh, B), p.threads, p.smem, st>>>" \
        in src
