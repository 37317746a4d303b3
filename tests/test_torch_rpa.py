"""Unified ragged paged attention in the PyTorch port against the JAX
reference: the port's plain version vs the reference's gather arm
(``_ragged_paged_xla``) and its Pallas kernel in interpret mode, and the
CUDA kernel vs the plain version on a card.

Inputs come from numpy with a seed. Tolerance: fp32 atol/rtol 1e-5 (the
same function, summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.ragged_paged_attention import (
    _ragged_paged_xla, ragged_paged_attention_kernel)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)

ATOL = 1e-5


def _case(G, seed=0, C=4, qb=4, nkv=2, d=128, bs=128, mb=3, P=8):
    """Decode row, a chunk straddling a page boundary, a partial chunk
    with padding rows, and an idle row on the sink page."""
    rng = np.random.default_rng(seed)
    nH = nkv * G
    q = rng.normal(size=(C, qb, nH, d)).astype(np.float32)
    kp = rng.normal(size=(P, nkv, d, bs)).astype(np.float32)
    vp = rng.normal(size=(P, nkv, bs, d)).astype(np.float32)
    rows = rng.integers(1, P, size=(C, mb)).astype(np.int32)
    rows[3:] = 0                                  # idle rows: sink
    pos0 = np.array([300, 126, 131, 0], np.int32)[:C]
    n_valid = np.array([1, qb, 2, 1], np.int32)[:C]
    return q, kp, vp, rows, pos0, n_valid


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_reference_gather_arm(G):
    q, kp, vp, rows, pos0, nv = _case(G)
    ref = _ragged_paged_xla(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(rows), jnp.asarray(pos0),
                            jnp.asarray(nv), 0.088, "d_major")
    got = ragged_paged_attention_plain(*_torch(q, kp, vp, rows, pos0, nv),
                                       0.088)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_reference_kernel_interpret(G):
    """Padding rows included: both repeat the last valid row's mask."""
    q, kp, vp, rows, pos0, nv = _case(G, seed=1, C=3)
    rows, pos0, nv = rows[:3], pos0[:3], nv[:3]
    ref = ragged_paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows),
        jnp.asarray(pos0), jnp.asarray(nv), 0.088)
    got = ragged_paged_attention(*_torch(q, kp, vp, rows, pos0, nv), 0.088)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_wrapper_on_cpu_launches_nothing():
    q, kp, vp, rows, pos0, nv = _case(2)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*_torch(q, kp, vp, rows, pos0, nv), 0.1)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert ragged_paged_attention.launches == before



def _int8_case(seed, C=3, qb=4, nkv=2, G=4, d=128, bs=128, mb=3, P=8):
    """int8 pages with per-(page, kv head) scales, the same rows as
    ``_case``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(C, qb, nkv * G, d)).astype(np.float32)
    kq = rng.integers(-127, 128, size=(P, nkv, d, bs)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(P, nkv, bs, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(P, nkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(P, nkv)).astype(np.float32)
    rows = rng.integers(1, P, size=(C, mb)).astype(np.int32)
    pos0 = np.array([300, 126, 131], np.int32)[:C]
    n_valid = np.array([1, qb, 2], np.int32)[:C]
    return q, kq, vq, ks, vs, rows, pos0, n_valid


@pytest.mark.parametrize("ref", ["kernel_interpret", "xla"])
def test_int8_plain_matches_reference(ref):
    """K8q's plain arm against the reference's quant=True kernel in
    interpret mode (d 128, bs 128) and its XLA arm: both dequantize the
    same way (fp32 multiply, cast to q's dtype), fp32 atol/rtol 1e-5."""
    q, kq, vq, ks, vs, rows, pos0, nv = _int8_case(3)
    j = [jnp.asarray(a) for a in (q, kq, vq, rows, pos0, nv)]
    if ref == "xla":
        want = _ragged_paged_xla(*j, 0.088, "d_major", jnp.asarray(ks),
                                 jnp.asarray(vs))
    else:
        want = ragged_paged_attention_kernel(*j, 0.088, jnp.asarray(ks),
                                             jnp.asarray(vs))
    t = _torch(q, kq, vq, rows, pos0, nv)
    got = ragged_paged_attention(*t, 0.088, k_scales=torch.from_numpy(ks),
                                 v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_int8_equals_fp_on_dequantized_pages():
    """The int8 arm is the fp arm on pages dequantized beforehand, bit for
    bit; int8 pages without scales are refused, as the reference does."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention_int8
    from paddle_tpu_torch.ops.quant import dequantize_int8

    q, kq, vq, ks, vs, rows, pos0, nv = _int8_case(4)
    q, kq, vq, ks, vs, rows, pos0, nv = _torch(q, kq, vq, ks, vs, rows,
                                               pos0, nv)
    before = ragged_paged_attention_int8.launches
    got = ragged_paged_attention_int8(q, kq, vq, ks, vs, rows, pos0, nv, 0.1)
    kd = dequantize_int8(kq, ks[:, :, None, None])
    vd = dequantize_int8(vq, vs[:, :, None, None])
    assert torch.equal(got, ragged_paged_attention(q, kd, vd, rows, pos0, nv,
                                                   0.1))
    assert ragged_paged_attention_int8.launches == before
    with pytest.raises(ValueError, match="scale"):
        ragged_paged_attention(q, kq, vq, rows, pos0, nv, 0.1)
