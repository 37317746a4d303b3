"""The port's int8 primitives (paddle_tpu_torch/ops/quant.py) against the
reference's (paddle_tpu/ops/quant.py) on the same numpy inputs, bit for
bit: the same fp32 expressions in the same order (true divides, round
half to even, the SCALE_EPS clamp), so every int8 value and every scale
must be equal, including ties at .5 and zero scales."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import quant as jq
from paddle_tpu_torch.ops import quant as tq


def _x(seed, *shape, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [-2, -1, 0])
def test_absmax_quantize_bitwise(axis):
    w = _x(0, 6, 33, 17)
    w[:, 3] = 0.0                       # an all-zero slice: eps scale
    q, s = tq.absmax_quantize_int8(torch.from_numpy(w), axis=axis)
    jq_, js = jq.absmax_quantize_int8(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_to_scale_bitwise_with_ties_and_zero_scales():
    x = _x(1, 64, 4, 16)
    s = np.abs(x).max(-1, keepdims=True) / 127.0
    s[3] = 0.0                          # clamped to SCALE_EPS
    x[5, 0, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) * s[5, 0, 0]
    got = tq.quantize_to_scale(torch.from_numpy(x), torch.from_numpy(s))
    want = jq.quantize_to_scale(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bitwise(dtype):
    q = np.random.RandomState(2).randint(-127, 128, (8, 4, 32)).astype(
        np.int8)
    s = np.abs(_x(3, 8, 4, 1)) * 0.02
    got = tq.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s),
                             getattr(torch, dtype))
    want = jq.dequantize_int8(jnp.asarray(q), jnp.asarray(s),
                              getattr(jnp, dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_rescale_bitwise_and_identity():
    q = np.random.RandomState(4).randint(-127, 128, (16, 4, 32)).astype(
        np.int8)
    old = np.abs(_x(5, 16, 4, 1)) * 0.01
    new = old * np.where(np.arange(16) % 2, 1.0, 1.7).astype(
        np.float32)[:, None, None]
    new[0] = 0.0
    got = tq.rescale_int8(torch.from_numpy(q), torch.from_numpy(old),
                          torch.from_numpy(new))
    want = jq.rescale_int8(jnp.asarray(q), jnp.asarray(old),
                           jnp.asarray(new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # an unchanged scale gives the stored bytes back
    np.testing.assert_array_equal(got.numpy()[1::2], q[1::2])


def test_kv_scale_update_bitwise_with_duplicates():
    scales = np.abs(_x(6, 9, 4)) * 0.01
    pages = np.array([1, 3, 1, 1, 0, 8, 3], np.int32)
    absmax = np.abs(_x(7, 7, 4)) * 0.02
    got = tq.kv_scale_update(torch.from_numpy(scales.copy()),
                             torch.from_numpy(pages),
                             torch.from_numpy(absmax))
    want = jq.kv_scale_update(jnp.asarray(scales), jnp.asarray(pages),
                              jnp.asarray(absmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # in place, and a running max: a smaller write never shrinks a scale
    plane = torch.from_numpy(scales.copy())
    out = tq.kv_scale_update(plane, torch.from_numpy(pages),
                             torch.from_numpy(absmax))
    assert out is plane
    again = tq.kv_scale_update(plane.clone(), torch.from_numpy(pages),
                               torch.from_numpy(absmax * 0.1))
    assert torch.equal(again, plane)
