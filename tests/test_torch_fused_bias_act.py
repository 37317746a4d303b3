"""The port's bias + tanh gelu (K7) and swiglu (K12) against the JAX
reference on the CPU: the port's plain arms (what its wrappers run on a
CPU tensor) against ``paddle_tpu.ops.pallas.fused_bias_act``'s
``fused_bias_gelu`` / ``fused_swiglu`` with ``use_kernel=True``, the
Pallas kernels in interpret mode. Inputs come from a numpy seed.

Tolerances: fp32 within rtol 1e-6 and atol 1e-6 (y is O(1); XLA's and
PyTorch's tanh may differ in the last bit). bf16 within 3 ulps of the
larger of the values and half the gelu's input (JAX rounds each op of
the gelu's polynomial in bf16, 1 + tanh on the grid of 1 included;
PyTorch computes it in fp32 and rounds once). Gradients in fp32 within
rtol 1e-5 and atol 1e-5 of each gradient's largest value. swiglu: bf16
bit-equal (silu in fp32 rounds once to bf16, the product of two bf16
values rounds once); fp32 within rtol 1e-6 and atol 1e-6 (the last bit of
exp); its gradients as the gelu's.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_bias_act as jf
from paddle_tpu_torch.ops.kernels import fused_bias_act as tf


def _inputs(seed, shape, dtype, bias_dtype):
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(*shape)).astype(np.float32)
    b = (0.5 * rng.randn(shape[-1])).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if bias_dtype == "bfloat16":
        b = np.array(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
    return x, b


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 256), (256, 512)])
def test_forward_matches_reference_kernel(shape, dtype, bias_dtype):
    x, b = _inputs(0, shape, dtype, bias_dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbt, tbt = getattr(jnp, bias_dtype), getattr(torch, bias_dtype)
    jy = np.asarray(jf.fused_bias_gelu(jnp.asarray(x, jdt),
                                       jnp.asarray(b, jbt), use_kernel=True)
                    .astype(jnp.float32))
    ty = tf.fused_bias_gelu(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(b).to(tbt)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
    else:
        z = (torch.from_numpy(x).to(tdt) + torch.from_numpy(b).to(tdt)
             ).float().numpy()
        mag = np.maximum(np.maximum(np.abs(ty), np.abs(jy)), 0.5 * np.abs(z))
        bound = 3 * _bf16_ulp(mag)
        assert np.all(np.abs(ty - jy) <= bound), \
            float(np.max(np.abs(ty - jy) / bound))


@pytest.mark.parametrize("shape", [(2, 128, 256), (256, 512)])
def test_gradients_match_reference(shape):
    x, b = _inputs(1, shape, "float32", "float32")
    cy = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = jax.grad(lambda xx, bb: jnp.sum(
        jf.fused_bias_gelu(xx, bb, use_kernel=True) * cy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    loss = (tf.fused_bias_gelu(xt, bt) * torch.from_numpy(cy)).sum()
    got = torch.autograd.grad(loss, (xt, bt))
    for name, w, g in zip(("x", "bias"), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_gate_swiglu_and_errors():
    sup = tf.fused_bias_act_supported
    assert sup(256, 4096, torch.bfloat16) and sup(512, 128, torch.float32)
    assert sup(512, 5504, torch.bfloat16) and sup(512, 14336, torch.bfloat16)
    assert not sup(255, 4096, torch.bfloat16)
    assert not sup(256, 4000, torch.bfloat16)
    assert not sup(256, 4096, torch.float16)
    with pytest.raises(ValueError, match="shape mismatch"):
        tf.fused_swiglu(torch.zeros(256, 128), torch.zeros(256, 64))
    with pytest.raises(ValueError, match="bias"):
        tf.fused_bias_gelu(torch.zeros(256, 128), torch.zeros(64))


def _swiglu_inputs(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    g = (3.0 * rng.randn(*shape)).astype(np.float32)
    u = rng.randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        g, u = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (g, u))
    return g, u


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 256), (256, 640)])
def test_swiglu_matches_reference_kernel(shape, dtype):
    g, u = _swiglu_inputs(3, shape, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy = np.asarray(jf.fused_swiglu(jnp.asarray(g, jdt), jnp.asarray(u, jdt),
                                    use_kernel=True).astype(jnp.float32))
    ty = tf.fused_swiglu(torch.from_numpy(g).to(tdt),
                         torch.from_numpy(u).to(tdt)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ty, jy)
    else:
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 128, 256), (256, 640)])
def test_swiglu_gradients_match_reference(shape):
    g, u = _swiglu_inputs(4, shape, "float32")
    cy = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(
        jf.fused_swiglu(a, b, use_kernel=True) * cy), argnums=(0, 1))(
        jnp.asarray(g), jnp.asarray(u))
    gt = torch.from_numpy(g).requires_grad_(True)
    ut = torch.from_numpy(u).requires_grad_(True)
    loss = (tf.fused_swiglu(gt, ut) * torch.from_numpy(cy)).sum()
    got = torch.autograd.grad(loss, (gt, ut))
    for name, w, t in zip(("gate", "up"), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
