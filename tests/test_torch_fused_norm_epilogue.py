"""The port's residual + bias + norm epilogue (K6) against the JAX
reference on the CPU: the port's plain arm (what its wrapper runs on a
CPU tensor) against ``paddle_tpu.ops.pallas.fused_norm_epilogue`` with
``use_kernel=True``, the Pallas kernel in interpret mode, as
tests/test_fused_norm_epilogue.py runs it. Inputs come from a numpy
seed.

Tolerances: r bit-equal (the adds round at the same places). y in fp32
within rtol 1e-6 and atol 1e-6 (y is O(1); the two sum the statistics in
another order, and r - mean cancels where r is near the mean); in bf16
within 1 ulp of the larger value, and with the gelu 3 ulps of the
larger of the values and half the gelu's input (JAX rounds each op of
the gelu's polynomial in bf16, 1 + tanh on the grid of 1 included;
PyTorch computes it in fp32 and rounds once). Gradients of every operand in fp32 within rtol 1e-5 and
atol 1e-5 of each gradient's largest value (summation order only).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_norm_epilogue as jf
from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as tf

SHAPE = (2, 128, 256)           # 256 rows: one reference row block
CASES = [(norm, sub, bias, beta)
         for norm in ("rms", "layer") for sub in (False, True)
         for bias in (False, True) for beta in (False, True)
         if norm == "rms" or beta]          # layer norm requires beta


def _inputs(seed, dtype, sub, bias, beta):
    rng = np.random.RandomState(seed)
    h = SHAPE[-1]
    x = (rng.randn(*SHAPE) * 1.5 + 0.3).astype(np.float32)
    s = rng.randn(*SHAPE).astype(np.float32) if sub else None
    b = (rng.randn(h) * 0.5).astype(np.float32) if bias else None
    g = (1.0 + 0.2 * rng.randn(h)).astype(np.float32)
    be = (0.2 * rng.randn(h)).astype(np.float32) if beta else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # the rows in x's dtype, the vectors fp32 (as GPT's masters keep them)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))
        s = None if s is None else np.array(
            jnp.asarray(s, jdt).astype(jnp.float32))
    return x, s, b, g, be


def _jax(arrs, dtype, norm, act):
    x, s, b, g, be = arrs
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    r, y = jf.fused_norm_epilogue(
        jnp.asarray(x, jdt), None if s is None else jnp.asarray(s, jdt),
        None if b is None else jnp.asarray(b), jnp.asarray(g),
        None if be is None else jnp.asarray(be), norm=norm, eps=1e-5,
        act=act, use_kernel=True)
    return np.asarray(r.astype(jnp.float32)), np.asarray(y.astype(jnp.float32))


def _torch(arrs, dtype, norm, act):
    tdt = getattr(torch, dtype)
    x, s, b, g, be = (None if a is None else torch.from_numpy(a)
                      for a in arrs)
    r, y = tf.fused_norm_epilogue(
        x.to(tdt), None if s is None else s.to(tdt), b, g, be, norm=norm,
        eps=1e-5, act=act)
    return r.float().numpy(), y.float().numpy()


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("norm,sub,bias,beta", CASES)
def test_forward_matches_reference_kernel(norm, sub, bias, beta, act,
                                          dtype):
    arrs = _inputs(0, dtype, sub, bias, beta)
    jr, jy = _jax(arrs, dtype, norm, act)
    tr, ty = _torch(arrs, dtype, norm, act)
    np.testing.assert_array_equal(tr, jr)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
    else:
        mag = np.maximum(np.abs(ty), np.abs(jy))
        ulps = 1
        if act == "gelu":
            # JAX rounds each of the polynomial's ops in bf16, and its
            # 1 + tanh(.) on the bf16 grid of 1 costs up to an ulp of
            # half the gelu's input z where the output is small
            _, z = _torch(arrs, dtype, norm, None)
            mag, ulps = np.maximum(mag, 0.5 * np.abs(z)), 3
        bound = ulps * _bf16_ulp(mag)
        assert np.all(np.abs(ty - jy) <= bound), \
            float(np.max(np.abs(ty - jy) / bound))


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("norm,sub,bias,beta", CASES)
def test_gradients_match_reference(norm, sub, bias, beta, act):
    """d(sum(r * cr + y * cy)) for every operand, fp32."""
    arrs = _inputs(1, "float32", sub, bias, beta)
    rng = np.random.RandomState(2)
    cr = rng.randn(*SHAPE).astype(np.float32)
    cy = rng.randn(*SHAPE).astype(np.float32)
    names = [n for n, a in zip(("x", "sub", "bias", "gain", "beta"), arrs)
             if a is not None]
    given = [a for a in arrs if a is not None]

    def jloss(*vals):
        kw = dict(zip(names, vals))
        r, y = jf.fused_norm_epilogue(kw.pop("x"), norm=norm, eps=1e-5,
                                      act=act, use_kernel=True, **kw)
        return jnp.sum(r * cr) + jnp.sum(y * cy)

    want = jax.grad(jloss, argnums=tuple(range(len(given))))(
        *[jnp.asarray(a) for a in given])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in given]
    kw = dict(zip(names, leaves))
    r, y = tf.fused_norm_epilogue(kw.pop("x"), norm=norm, eps=1e-5, act=act,
                                  **kw)
    loss = (r * torch.from_numpy(cr)).sum() + (y * torch.from_numpy(cy)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_gate_and_errors():
    sup = tf.fused_norm_epilogue_supported
    assert sup(256, 1024, torch.bfloat16) and sup(512, 128, torch.float32)
    # h 2048 in bf16: the Hopper kernel takes it, the reference's VMEM
    # term does not
    assert sup(256, 2048, torch.bfloat16)
    assert not jf.fused_norm_epilogue_supported(256, 2048, jnp.bfloat16)
    assert not sup(256, 2048 * 8, torch.bfloat16)
    assert not sup(255, 1024, torch.bfloat16)
    assert not sup(256, 1000, torch.bfloat16)
    assert not sup(256, 1024, torch.float16)
    x = torch.zeros(256, 128)
    g = torch.ones(128)
    with pytest.raises(ValueError, match="gain"):
        tf.fused_norm_epilogue(x, norm="rms")
    with pytest.raises(ValueError, match="beta"):
        tf.fused_norm_epilogue(x, gain=g, norm="layer")
    with pytest.raises(ValueError, match="unknown norm"):
        tf.fused_norm_epilogue(x, gain=g, norm="batch")
