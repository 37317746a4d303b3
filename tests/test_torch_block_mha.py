"""The port's incubate serving ops (paddle_tpu_torch/incubate) against
the reference's (paddle_tpu/incubate/nn/functional/fused_transformer.py).

- ``PagedKVCache``: after a prefill and decode writes, both k layouts,
  the pages, the table and the lengths equal the reference's bit for bit
  (fp32 and bf16), from a fresh cache and from one carried over with
  ``paged_cache_from_jax``.
- ``block_multihead_attention``: prefill and decode outputs against the
  reference's, and the route each call takes (``ROUTES``) against the
  reference's gates: flash or the plain sdpa for a prefill, K15 on
  d-major pages, K14 on token-major pages, the gather expression (with
  the GQA repeat) where the gates fail. fp32 within 2e-5, the
  reference's own tolerance for these paths
  (tests/test_decode_attention.py); bf16 within 2e-2.
- ``fused_multi_transformer`` against the reference, prefill and one
  decode step, within 2e-5.

The reference's caches are functional (``.at[].set``), the port's are
written in place: where a test needs two copies of a port cache it takes
``copy.deepcopy`` (a shallow ``copy.copy`` would share the pages).
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import fused_transformer as jft
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.incubate.nn.functional import fused_transformer as tft
from paddle_tpu_torch.utils.convert import paged_cache_from_jax, \
    params_from_jax

TOL = 2e-5
BF16_TOL = 2e-2


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _caches(nh, dh, bs, B, max_seq, layout, jdt, tdt):
    n_pages = B * ((max_seq + bs - 1) // bs)
    jc = jft.PagedKVCache(n_pages, nh, bs, dh, B, max_seq, dtype=jdt,
                          k_layout=layout)
    tc = tft.PagedKVCache(n_pages, nh, bs, dh, B, max_seq, dtype=tdt,
                          k_layout=layout, device="cpu")
    return jc, tc


def _same_state(jc, tc):
    for a, b in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.array_equal(_np(a), b.float().numpy())
    assert np.array_equal(np.asarray(jc.block_table), tc.block_table.numpy())
    assert np.array_equal(np.asarray(jc.seq_lens), tc.seq_lens.numpy())


def _qkv(rng, B, S, nh, dh, jdt, tdt):
    a = rng.randn(B, S, 3, nh, dh).astype(np.float32)
    ja = jnp.asarray(a, jdt)
    return ja, params_from_jax(np.asarray(ja), "cpu").to(tdt)


@pytest.mark.parametrize("layout", ["d_major", "token_major"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cache_writes_equal_reference(layout, dt):
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    rng = np.random.RandomState(0)
    B, nh, dh, bs = 3, 4, 64, 16
    jc, tc = _caches(nh, dh, bs, B, 96, layout, jdt, tdt)
    jq, tq = _qkv(rng, B, 37, nh, dh, jdt, tdt)        # a partial page
    jc.write_prefill(jq[:, :, 1], jq[:, :, 2])
    tc.write_prefill(tq[:, :, 1], tq[:, :, 2])
    _same_state(jc, tc)
    for _ in range(12):                                # crosses a page
        jq, tq = _qkv(rng, B, 1, nh, dh, jdt, tdt)
        jc.write_decode(jq[:, :, 1], jq[:, :, 2])
        tc.write_decode(tq[:, :, 1], tq[:, :, 2])
    _same_state(jc, tc)
    # the same decode writes on a cache carried over from the reference
    moved = paged_cache_from_jax(jc, "cpu")
    _same_state(jc, moved)
    jq, tq = _qkv(rng, B, 1, nh, dh, jdt, tdt)
    jc.write_decode(jq[:, :, 1], jq[:, :, 2])
    moved.write_decode(tq[:, :, 1], tq[:, :, 2])
    _same_state(jc, moved)


def _want_route(layout, nq, cache):
    mb = cache.max_blocks
    if layout == "d_major" and jda.paged_decode_mxu_supported(
            cache.k_pages.shape, nq, max_blocks=mb,
            itemsize=cache.k_pages.dtype.itemsize):
        return "mxu"
    if layout == "token_major" and jda.paged_decode_supported(
            cache.k_pages.shape, nq, max_blocks=mb,
            itemsize=cache.k_pages.dtype.itemsize):
        return "kernel"
    return "gather"


@pytest.mark.parametrize("layout,nh,dh,bs,S,route", [
    ("d_major", 8, 128, 128, 128, "mxu"),
    ("token_major", 8, 128, 128, 128, "kernel"),
    ("d_major", 4, 64, 16, 128, "gather"),        # K15 needs d 128/256
    ("token_major", 4, 64, 16, 40, "kernel"),     # prefill: sdpa
])
def test_block_mha_prefill_decode_matches_reference(layout, nh, dh, bs, S,
                                                    route):
    rng = np.random.RandomState(1)
    B = 2
    jc, tc = _caches(nh, dh, bs, B, S + 2 * bs, layout, jnp.float32,
                     torch.float32)
    jq, tq = _qkv(rng, B, S, nh, dh, jnp.float32, torch.float32)
    before = dict(tft.ROUTES)
    want = jft.block_multihead_attention(jq, jc)
    got = tft.block_multihead_attention(tq, tc)
    prefill = "flash" if S % 128 == 0 else "sdpa"
    assert tft.ROUTES[prefill] == before[prefill] + 1
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert _want_route(layout, nh, jc) == route
    for _ in range(3):
        jq, tq = _qkv(rng, B, 1, nh, dh, jnp.float32, torch.float32)
        before = tft.ROUTES[route]
        want = jft.block_multihead_attention(jq, jc)
        got = tft.block_multihead_attention(tq, tc)
        assert tft.ROUTES[route] == before + 1
        assert got.shape == (B, 1, nh, dh)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
    _same_state(jc, tc)


def test_block_mha_bf16_default_layout():
    """The reference's defaults: bf16 pages, d-major k (K15)."""
    rng = np.random.RandomState(2)
    B, nh, dh, bs, S = 2, 8, 128, 128, 128
    jc, tc = _caches(nh, dh, bs, B, 3 * bs, "d_major", jnp.bfloat16,
                     torch.bfloat16)
    jq, tq = _qkv(rng, B, S, nh, dh, jnp.bfloat16, torch.bfloat16)
    jft.block_multihead_attention(jq, jc)
    tft.block_multihead_attention(tq, tc)
    for _ in range(2):
        jq, tq = _qkv(rng, B, 1, nh, dh, jnp.bfloat16, torch.bfloat16)
        before = tft.ROUTES["mxu"]
        want = jft.block_multihead_attention(jq, jc)
        got = tft.block_multihead_attention(tq, tc)
        assert tft.ROUTES["mxu"] == before + 1
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    _same_state(jc, tc)


@pytest.mark.parametrize("layout,dh,bs,route", [
    ("d_major", 128, 128, "mxu"),                 # K15's native GQA
    ("d_major", 64, 16, "gather"),                # GQA repeat in the gather
    ("token_major", 128, 128, "gather")])         # K14 takes no GQA
def test_paged_decode_gqa_matches_reference(layout, dh, bs, route):
    rng = np.random.RandomState(3)
    B, nkv, G = 2, 2, 4
    jc, tc = _caches(nkv, dh, bs, B, 2 * bs, layout, jnp.float32,
                     torch.float32)
    jq, tq = _qkv(rng, B, bs + 5, nkv, dh, jnp.float32, torch.float32)
    jc.write_prefill(jq[:, :, 1], jq[:, :, 2])
    tc.write_prefill(tq[:, :, 1], tq[:, :, 2])
    q = rng.randn(B, 1, nkv * G, dh).astype(np.float32)
    assert _want_route(layout, nkv * G, jc) == route
    before = tft.ROUTES[route]
    want = jft.paged_decode_attention(jnp.asarray(q), jc.k_pages,
                                      jc.v_pages, jc.block_table,
                                      jc.seq_lens, k_layout=layout)
    tcopy = copy.deepcopy(tc)
    got = tft.paged_decode_attention(torch.from_numpy(q), tcopy.k_pages,
                                     tcopy.v_pages, tcopy.block_table,
                                     tcopy.seq_lens, k_layout=layout)
    assert tft.ROUTES[route] == before + 1
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_fused_multi_transformer_matches_reference():
    rng = np.random.RandomState(0)
    B, S, H, nh, L = 2, 6, 16, 4, 2
    mk = lambda *sh: (rng.randn(*sh) * 0.1).astype(np.float32)  # noqa: E731
    w = dict(
        ln_scales=[np.ones(H, np.float32)] * L,
        ln_biases=[np.zeros(H, np.float32)] * L,
        qkv_weights=[mk(H, 3 * H) for _ in range(L)],
        qkv_biases=[mk(3 * H) for _ in range(L)],
        out_weights=[mk(H, H) for _ in range(L)],
        out_biases=[mk(H) for _ in range(L)],
        ffn_ln_scales=[np.ones(H, np.float32)] * L,
        ffn_ln_biases=[np.zeros(H, np.float32)] * L,
        ffn1_weights=[mk(H, 2 * H) for _ in range(L)],
        ffn1_biases=[mk(2 * H) for _ in range(L)],
        ffn2_weights=[mk(2 * H, H) for _ in range(L)],
        ffn2_biases=[mk(H) for _ in range(L)])
    jw = {k: [jnp.asarray(a) for a in v] for k, v in w.items()}
    tw = {k: [torch.from_numpy(a) for a in v] for k, v in w.items()}
    x = mk(B, S, H)
    caches = [np.zeros((2, B, nh, S + 4, H // nh), np.float32)
              for _ in range(L)]
    jx, jc = jft.fused_multi_transformer(
        jnp.asarray(x[:, :S - 1]), cache_kvs=[jnp.asarray(c) for c in caches],
        num_heads=nh, **jw)
    tx, tc = tft.fused_multi_transformer(
        torch.from_numpy(x[:, :S - 1]),
        cache_kvs=[torch.from_numpy(c) for c in caches], num_heads=nh, **tw)
    np.testing.assert_allclose(tx.numpy(), _np(jx), rtol=TOL, atol=TOL)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), _np(a), rtol=TOL, atol=TOL)
    jx, _ = jft.fused_multi_transformer(jnp.asarray(x[:, S - 1:]),
                                        cache_kvs=jc, time_step=S - 1,
                                        num_heads=nh, **jw)
    tx, _ = tft.fused_multi_transformer(torch.from_numpy(x[:, S - 1:]),
                                        cache_kvs=tc, time_step=S - 1,
                                        num_heads=nh, **tw)
    np.testing.assert_allclose(tx.numpy(), _np(jx), rtol=TOL, atol=TOL)
    # without caches
    jx, none = jft.fused_multi_transformer(jnp.asarray(x), num_heads=nh,
                                           **jw)
    tx, _ = tft.fused_multi_transformer(torch.from_numpy(x), num_heads=nh,
                                        **tw)
    assert none is None
    np.testing.assert_allclose(tx.numpy(), _np(jx), rtol=TOL, atol=TOL)
