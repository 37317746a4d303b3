"""Tile and ring choices of the redesigned kernels, held on the CPU.

K9 (``quant_matmul.qmm_plan``): every matmul shape of the llama3-8b
weight-only int8 engine step takes the TMA + wgmma variant with at least
64 tiles or a split K; shapes TMA cannot take (K % 8, N % 16) take the
mma.sync variant, fp32 x the CUDA-core one; the ring fits a block's
shared memory and every split keeps K steps. K14
(``decode_attention.paged_ring_geometry``): for every geometry the
token-major gate admits (d 64, 128, 256; bs a multiple of 8; fp32 and
bf16) the ring fits 227 KB, leaves room for two blocks on an SM, and its
stages tile the page."""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import quant_matmul as qmm

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
