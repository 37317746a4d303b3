"""The port's dense GQA decode attention (K10) against the JAX reference
on the CPU: the port's plain arm (what its wrapper runs on a CPU tensor)
against ``paddle_tpu.ops.pallas.decode_attention.decode_attention``, the
Pallas kernel in interpret mode, on the same numpy inputs; and the route
gate term for term against the reference's.

Tolerance: fp32 atol 1e-5 and rtol 1e-5 (o is O(1); the plain arm's one
softmax against the kernel's blockwise online softmax differ in summation
order only)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jd
from paddle_tpu_torch.ops.kernels import decode_attention as td


def _inputs(seed, B, nKV, G, S, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, nKV * G, d).astype(np.float32),
            rng.randn(B, nKV, S, d).astype(np.float32),
            rng.randn(B, nKV, S, d).astype(np.float32))


@pytest.mark.parametrize("S", [256, 1024])
@pytest.mark.parametrize("G", [2, 4])
def test_plain_arm_matches_reference_kernel(G, S):
    B, nKV, d = 2, 2, 128
    q, ck, cv = _inputs(G + S, B, nKV, G, S, d)
    scale = 1.0 / math.sqrt(d)
    # the first position, inside a block, a block's edge, the last slot
    for pos in (0, 100, min(S, 512) - 1, S - 1):
        want = np.asarray(jd.decode_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), pos, scale))
        got = td.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                  torch.from_numpy(cv), pos, scale)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("pos", [63, 191, 639])
def test_plain_arm_at_chunk_ends(pos):
    """pos = 64k - 1, where the kernel's last 64-position chunk is full
    (639: llama1b's last decode step of a 128-token generation after a
    512-token prompt), fp and int8 caches."""
    B, nKV, G, S, d = 2, 2, 4, 1024, 64
    q, ck, cv = _inputs(pos, B, nKV, G, S, d)
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(jd.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), pos, scale))
    got = td.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), pos, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    rng = np.random.RandomState(pos)
    kq, vq = (rng.randint(-127, 128, size=(B, nKV, S, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, size=(B, nKV, S)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jd.decode_attention(
        *map(jnp.asarray, (q, kq, vq)), pos, scale, block_s=512,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = td.decode_attention(*map(torch.from_numpy, (q, kq, vq)), pos,
                              scale, k_scale=torch.from_numpy(ks),
                              v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_positions_past_pos_do_not_count():
    """Other values past pos change nothing, bit for bit."""
    q, ck, cv = _inputs(0, 1, 2, 2, 256, 64)
    pos = 70
    args = [torch.from_numpy(a) for a in (q, ck, cv)]
    want = td.decode_attention(*args, pos, 0.125)
    ck[:, :, pos + 1:] *= 1e3
    cv[:, :, pos + 1:] = 7.0
    got = td.decode_attention(*(torch.from_numpy(a) for a in (q, ck, cv)),
                              pos, 0.125)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,d,nh", [
    ((1, 4, 2048, 128), 128, 16), ((1, 8, 2048, 128), 128, 32),
    ((2, 4, 512, 64), 64, 8), ((2, 4, 384, 256), 256, 8),
    ((2, 4, 1024, 96), 96, 8), ((2, 4, 1000, 128), 128, 8),
    ((2, 4, 640, 128), 128, 8), ((2, 4, 200, 128), 128, 8),
    ((2, 8, 2048, 128), 128, 8), ((2, 4, 2048, 128), 128, 6),
    ((2, 4, 2048, 128), 128, None)])
def test_gate_equals_the_reference(shape, d, nh):
    assert td.decode_attention_supported(shape, d, num_heads=nh) == \
        jd.decode_attention_supported(shape, d, num_heads=nh)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 128, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        td.decode_attention(q.to("meta"), ck.to("meta"), cv.to("meta"), 3,
                            0.1)


def test_int8_plain_arm_matches_reference_kernel():
    """K10q's plain arm (an int8 cache with per-position fp32 scales,
    through the public entry) against the reference's quant=True kernel
    in interpret mode on the same numpy inputs, fp32 atol/rtol 1e-5; equal
    bit for bit to the fp arm on the cache dequantized beforehand; int8
    caches without scales are refused."""
    from paddle_tpu_torch.ops.quant import dequantize_int8

    rng = np.random.RandomState(11)
    B, nKV, G, S, d = 2, 2, 4, 256, 64
    q = rng.randn(B, nKV * G, d).astype(np.float32)
    kq, vq = (rng.randint(-127, 128, size=(B, nKV, S, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, size=(B, nKV, S)).astype(np.float32)
              for _ in range(2))
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs)]
    kd = dequantize_int8(t[1], t[3][..., None])
    vd = dequantize_int8(t[2], t[4][..., None])
    sm = 1.0 / math.sqrt(d)
    for pos in (0, 100, S - 1):
        want = np.asarray(jd.decode_attention(
            *map(jnp.asarray, (q, kq, vq)), pos, sm, block_s=256,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
        got = td.decode_attention(t[0], t[1], t[2], pos, sm, k_scale=t[3],
                                  v_scale=t[4])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=f"pos {pos}")
        assert torch.equal(got, td.decode_attention(t[0], kd, vd, pos, sm))
    with pytest.raises(ValueError, match="scale"):
        td.decode_attention(t[0], t[1], t[2], 5, sm)
