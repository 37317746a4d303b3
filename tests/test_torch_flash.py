"""The port's flash attention on the fused qkv projection against the JAX
reference's Pallas kernels (interpret mode on the CPU): the plain
forward (o, lse) against ``_flash_fwd``, the plain merged backward
against ``_flash_bwd(fused_dqkv=True)``, and the autograd function's
gradient against ``jax.grad`` of ``flash_attention_qkv_raw``. B 2, S 256,
(h 4, d 64) and (h 2, d 128), causal and not, fp32; tolerance atol and
rtol 1e-5 (summation order only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

B, S = 2, 256
TOL = 1e-5
CASES = [(4, 64, True), (4, 64, False), (2, 128, True), (2, 128, False)]


def _data(h, d, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.standard_normal((B, S, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((B, S, h, d)).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize("h,d,causal", CASES)
def test_plain_forward_matches_pallas(h, d, causal):
    qkv, _ = _data(h, d)
    scale = d ** -0.5
    jo, jlse = jfa._flash_fwd(jnp.asarray(qkv), None, None, causal, scale,
                              with_lse=True, n_heads=h)
    o, lse = tfa.flash_fwd(torch.from_numpy(qkv), h, causal, scale)
    assert o.shape == (B, S, h, d) and lse.shape == (B, h, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0, :],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("h,d,causal", CASES)
def test_plain_backward_matches_pallas(h, d, causal):
    qkv, do = _data(h, d, seed=1)
    scale = d ** -0.5
    jq = jnp.asarray(qkv)
    jo, jlse = jfa._flash_fwd(jq, None, None, causal, scale, with_lse=True,
                              n_heads=h)
    want = jfa._flash_bwd(jq, None, None, jo, jlse, jnp.asarray(do), causal,
                          scale, n_heads=h, fused_dqkv=True)
    got = tfa.flash_bwd(torch.from_numpy(qkv),
                        torch.from_numpy(np.array(jo)),
                        torch.from_numpy(np.array(jlse)[:, :, 0, :].copy()),
                        torch.from_numpy(do), h, causal, scale)
    assert got.shape == (B, S, 3 * h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("h,d,causal", CASES[::3])
def test_autograd_matches_jax_grad(h, d, causal):
    qkv, do = _data(h, d, seed=2)

    def f(x):
        return (jfa.flash_attention_qkv_raw(x, h, causal=causal)
                * jnp.asarray(do)).sum()

    want = jax.grad(f)(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = tfa.flash_attention_qkv(x, h, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_supported_gate_matches_reference():
    for shape, h in (((2, 256, 768), 4), ((2, 256, 768), 2),
                     ((2, 200, 768), 4), ((2, 256, 3 * 3 * 64), 3),
                     ((2, 256, 3 * 8 * 32), 8), ((2, 128, 3 * 1024), 16)):
        want = jfa.flash_qkv_supported(shape, h, jnp.float32)
        assert tfa.flash_qkv_supported(shape, h, torch.float32) == want, \
            (shape, h)


@pytest.mark.parametrize("name,value", [("flash_attention_kernel_bwd", False),
                                        ("flash_attention_native_layout",
                                         False),
                                        ("use_library_flash_attention",
                                         True)])
def test_later_slice_flags_raise(name, value):
    """The XLA-expression backward and the library kernel are refused;
    the head-major layout is ported (K17), and under it the fused-qkv
    gate is off, as the reference's (tests/test_flash_native_layout.py:
    135-146)."""
    old = GLOBAL_FLAGS.get(name)
    GLOBAL_FLAGS.set(name, value)
    try:
        if name == "flash_attention_native_layout":
            assert not tfa.flash_qkv_supported((2, 256, 768), 4,
                                               torch.float32)
        else:
            with pytest.raises(NotImplementedError, match="later slice"):
                tfa.flash_qkv_supported((2, 256, 768), 4, torch.float32)
    finally:
        GLOBAL_FLAGS.set(name, old)
