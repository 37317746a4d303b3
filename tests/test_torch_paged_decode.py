"""The port's paged decode (K15, K14, K16) against the reference's
kernels in interpret mode (paddle_tpu/ops/pallas/decode_attention.py).

The gates are the reference's term for term, so they must agree on every
shape, around each edge: d, bs % 8 and % 128, nq >= 8, nq == nh, the
12 MiB working-set estimate and its k_per of 4, 2 or 1. The plain
versions must give the reference kernels' outputs within the
reference's own fp32 tolerances: 2e-5 for K14 and K16
(tests/test_decode_attention.py), 2e-3 for K15
(tests/test_parity_ops.py); the error reached is far under (~2e-7).
Cases hold ragged lengths on a shuffled table, a sequence of length 0
(which attends to every row of its table's pages with equal weight) and,
for K15, GQA and lengths that end on its ring's stages (32 tokens a v
stage in fp32, 64 in bf16, at pages of 128). In bf16 K15's plain version rounds p to bf16 as the kernel
does and is held at 2e-2, the port's bf16 attention tolerance.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.utils.convert import params_from_jax

K14_TOL = 2e-5          # tests/test_decode_attention.py, K14 and K16
K15_TOL = 2e-3          # tests/test_parity_ops.py:219
BF16_TOL = 2e-2


def _t(a):
    return params_from_jax(np.asarray(a), "cpu")


@pytest.mark.parametrize("nh,bs,d,nq,mb,itemsize", [
    (8, 16, 64, 8, 4, 4), (8, 16, 64, 16, 4, 4), (8, 12, 64, 8, 4, 4),
    (8, 16, 32, 8, 4, 4), (8, 16, 512, 8, 4, 4),
    (16, 128, 128, 16, 4, 2),            # llama1b: k_per 4, ~10 MiB
    (32, 128, 128, 32, 16, 2),           # llama2-7b: k_per 2, 12 MiB exactly
    (32, 128, 128, 32, 16, 4),           # the same in fp32: k_per 1, over
    (32, 136, 128, 32, 16, 2),           # one step past the cap
    (32, 128, 128, 32, 6, 2), (32, 128, 128, 32, 3, 2),
    (4, 1024, 128, 4, 4, 2), (64, 128, 256, 64, 2, 2)])
def test_token_major_gate_matches_reference(nh, bs, d, nq, mb, itemsize):
    shape = (64, nh, bs, d)
    for blocks in (mb, None):
        want = jda.paged_decode_supported(shape, nq, max_blocks=blocks,
                                          itemsize=itemsize)
        assert tda.paged_decode_supported(shape, nq, max_blocks=blocks,
                                          itemsize=itemsize) == want


@pytest.mark.parametrize("nkv,d,bs,nq,mb,itemsize", [
    (2, 128, 128, 8, 3, 4), (2, 128, 128, 4, 3, 4), (2, 128, 128, 7, 3, 4),
    (2, 64, 128, 8, 3, 4), (2, 256, 128, 8, 3, 4), (2, 128, 64, 8, 3, 4),
    (2, 128, 256, 8, 3, 4), (8, 128, 128, 32, 16, 2),
    (32, 128, 128, 32, 16, 2), (32, 128, 128, 32, 16, 4),
    (4, 128, 1024, 8, 4, 2), (4, 128, 1024, 8, 4, 4),
    (8, 256, 512, 64, 4, 2), (32, 128, 128, 32, 7, 2)])
def test_mxu_gate_matches_reference(nkv, d, bs, nq, mb, itemsize):
    shape = (64, nkv, d, bs)
    for blocks in (mb, None):
        want = jda.paged_decode_mxu_supported(shape, nq, max_blocks=blocks,
                                              itemsize=itemsize)
        assert tda.paged_decode_mxu_supported(shape, nq, max_blocks=blocks,
                                              itemsize=itemsize) == want


@pytest.mark.parametrize("mb,page_bytes", [(4, None), (6, None), (3, None),
                                           (16, 2 ** 20), (16, 4 * 2 ** 20),
                                           (4, 2 ** 19), (8, 3 * 2 ** 20)])
def test_pages_per_program_matches_reference(mb, page_bytes):
    assert tda._paged_pages_per_program(mb, page_bytes) == \
        jda._paged_pages_per_program(mb, page_bytes)


def _token_major_case(seed, lens):
    rng = np.random.RandomState(seed)
    B, nh, bs, d, mb, P = 4, 8, 16, 64, 4, 32
    q = rng.randn(B, nh, d).astype(np.float32)
    kp = rng.randn(P, nh, bs, d).astype(np.float32)
    vp = rng.randn(P, nh, bs, d).astype(np.float32)
    table = rng.permutation(P)[:B * mb].reshape(B, mb).astype(np.int32)
    return q, kp, vp, table, np.asarray(lens, np.int32), 1.0 / math.sqrt(d)


LENS = ([1, 16, 35, 64], [0, 5, 64, 17], [0, 0, 1, 48])


@pytest.mark.parametrize("lens", LENS)
def test_k14_plain_matches_interpret_kernel(lens):
    q, kp, vp, table, sl, scale = _token_major_case(1, lens)
    assert jda.paged_decode_supported(kp.shape, q.shape[1],
                                      max_blocks=table.shape[1], itemsize=4)
    want = np.asarray(jda.paged_decode_attention_kernel(
        *map(jnp.asarray, (q, kp, vp, table, sl)), scale))
    got = tda.paged_decode_attention_kernel(
        *map(torch.from_numpy, (q, kp, vp, table, sl)), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=K14_TOL, atol=K14_TOL)


@pytest.mark.parametrize("lens", LENS)
def test_k16_plain_matches_interpret_kernel(lens):
    q, kp, vp, table, sl, scale = _token_major_case(3, lens)
    want = np.asarray(jda.paged_decode_attention_dma(
        *map(jnp.asarray, (q, kp, vp, table, sl)), scale))
    got = tda.paged_decode_attention_dma(
        *map(torch.from_numpy, (q, kp, vp, table, sl)), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=K14_TOL, atol=K14_TOL)
    # the reference holds its DMA kernel bit-equal to K14; so are the ports'
    assert np.array_equal(got, tda.paged_decode_attention_kernel(
        *map(torch.from_numpy, (q, kp, vp, table, sl)), scale).numpy())


def test_length_zero_sequence_is_the_mean_of_its_pages():
    q, kp, vp, table, sl, scale = _token_major_case(4, [0, 1, 2, 3])
    got = tda.paged_decode_plain(*map(torch.from_numpy,
                                      (q, kp, vp, table, sl)), scale)
    mean = vp[table[0]].mean(axis=(0, 2))            # [nh, d]
    np.testing.assert_allclose(got[0].numpy(), mean, rtol=1e-5, atol=1e-6)


def test_k16_entry_raises_where_its_gate_fails():
    q, kp, vp, table, sl, scale = _token_major_case(5, [1, 2, 3, 4])
    q2 = np.concatenate([q, q], axis=1)              # nq != nh
    with pytest.raises(ValueError, match="unsupported"):
        jda.paged_decode_attention_dma(*map(jnp.asarray,
                                            (q2, kp, vp, table, sl)), scale)
    with pytest.raises(ValueError, match="unsupported"):
        tda.paged_decode_attention_dma(*map(torch.from_numpy,
                                            (q2, kp, vp, table, sl)), scale)


def _mxu_case(seed, G, lens, nkv=2, d=128, bs=128, mb=3):
    rng = np.random.RandomState(seed)
    B, nq, P = len(lens), nkv * G, 4 * len(lens)
    q = rng.randn(B, nq, d).astype(np.float32)
    kt = rng.randn(P, nkv, d, bs).astype(np.float32)
    vp = rng.randn(P, nkv, bs, d).astype(np.float32)
    table = rng.permutation(P)[:B * mb].reshape(B, mb).astype(np.int32)
    return q, kt, vp, table, np.asarray(lens, np.int32), 1.0 / math.sqrt(d)


@pytest.mark.parametrize("G,lens", [(4, [300, 0]), (4, [1, 384]),
                                    (8, [128, 129]), (1, [17, 0]),
                                    (4, [32, 256]), (1, [64, 160])])
def test_k15_plain_matches_interpret_kernel(G, lens):
    nkv = 2 if G > 1 else 8
    q, kt, vp, table, sl, scale = _mxu_case(6, G, lens, nkv=nkv)
    assert jda.paged_decode_mxu_supported(kt.shape, q.shape[1],
                                          max_blocks=table.shape[1],
                                          itemsize=4)
    want = np.asarray(jda.paged_decode_attention_mxu(
        *map(jnp.asarray, (q, kt, vp, table, sl)), scale))
    got = tda.paged_decode_attention_mxu(
        *map(torch.from_numpy, (q, kt, vp, table, sl)), scale).numpy()
    err = np.abs(got - want).max()
    assert err < 1e-5, err                 # reached: ~1e-7
    np.testing.assert_allclose(got, want, rtol=K15_TOL, atol=K15_TOL)


def test_k15_stage_edges_in_bf16():
    """Lengths that end on the bf16 kernel's ring stages at this shape
    (paged_mxu_plan: 64 tokens a v stage, pages of 128): a stage, a
    page, a stage into the next page, a token past a page."""
    assert tda.paged_mxu_plan(128, 128, 4, 2)[1] == 64
    q, kt, vp, table, sl, scale = _mxu_case(8, 4, [64, 128, 192, 129])
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, kt, vp))
    want = np.asarray(jda.paged_decode_attention_mxu(
        qb, kb, vb, jnp.asarray(table), jnp.asarray(sl), scale)
        .astype(jnp.float32))
    got = tda.paged_decode_attention_mxu(
        _t(qb), _t(kb), _t(vb), torch.from_numpy(table),
        torch.from_numpy(sl), scale)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_k15_bf16_rounds_p_as_the_kernel():
    q, kt, vp, table, sl, scale = _mxu_case(7, 4, [200, 0, 384, 1])
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, kt, vp))
    want = np.asarray(jda.paged_decode_attention_mxu(
        qb, kb, vb, jnp.asarray(table), jnp.asarray(sl), scale)
        .astype(jnp.float32))
    got = tda.paged_decode_attention_mxu(
        _t(qb), _t(kb), _t(vb), torch.from_numpy(table),
        torch.from_numpy(sl), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
