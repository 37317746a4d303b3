"""The port's vocab-streaming cross-entropy against the JAX reference on
the CPU: the plain forward (nll, lse) and backward (dx, dhead) against
the Pallas kernels ``_fused_ce_fwd`` / ``_fused_ce_bwd`` (interpret
mode) at the reference test's shapes (N 1024, H 128, V 2688: a partial
last vocab tile), the autograd function against ``jax.grad``, and the
chunked loss against ``_chunked_ce``. fp32; tolerance rtol 1e-5 with
atol 1e-5 (gradients: 1e-5 of their largest magnitude)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jg
from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels import fused_ce as tce

N, H, V = 1024, 128, 2048 + 640
TOL = 1e-5


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    x = (rng.randn(N, H) * 0.5).astype(np.float32)
    head = (rng.randn(H, V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, (N,)).astype(np.int32)
    g = rng.rand(N).astype(np.float32)
    return x, head, labels, g


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


def test_plain_forward_matches_pallas(data):
    x, head, labels, _ = data
    jnll, jlse = jce._fused_ce_fwd(jnp.asarray(x), jnp.asarray(head),
                                   jnp.asarray(labels))
    nll, lse = tce.fused_ce_fwd(*(torch.from_numpy(a)
                                  for a in (x, head, labels)))
    _close(nll, jnll)
    _close(lse, jlse)


def test_plain_backward_matches_pallas(data):
    x, head, labels, g = data
    _, jlse = jce._fused_ce_fwd(jnp.asarray(x), jnp.asarray(head),
                                jnp.asarray(labels))
    jdx, jdh = jce._fused_ce_bwd(jnp.asarray(x), jnp.asarray(head),
                                 jnp.asarray(labels), jlse, jnp.asarray(g))
    dx, dh = tce.fused_ce_bwd(torch.from_numpy(x), torch.from_numpy(head),
                              torch.from_numpy(labels),
                              torch.from_numpy(np.array(jlse)),
                              torch.from_numpy(g))
    assert dx.shape == (N, H) and dh.shape == (H, V)
    _close(dx, jdx)
    _close(dh, jdh)


def test_autograd_matches_jax_grad(data):
    x, head, labels, g = data

    def f(a, b):
        return (jce.fused_softmax_ce(a, b, jnp.asarray(labels))
                * jnp.asarray(g)).sum()

    loss, (jdx, jdh) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    out = (tce.fused_softmax_ce(tx, th, torch.from_numpy(labels))
           * torch.from_numpy(g)).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(loss), rtol=TOL)
    _close(tx.grad, jdx)
    _close(th.grad, jdh)


@pytest.mark.parametrize("chunk", [128, 512])
def test_chunked_ce_matches_reference(data, chunk):
    x, head, labels, _ = data
    xb, lb = x.reshape(2, N // 2, H), labels.reshape(2, N // 2)
    want = jg._chunked_ce(jnp.asarray(xb), jnp.asarray(head),
                          jnp.asarray(lb), chunk)
    got = tg._chunked_ce(torch.from_numpy(xb), torch.from_numpy(head),
                         torch.from_numpy(lb), chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    nll, _ = tce.fused_ce_fwd_plain(*(torch.from_numpy(a)
                                      for a in (x, head, labels)))
    np.testing.assert_allclose(nll.mean().item(), float(want), rtol=TOL)


def test_supported_states_the_kernels_conditions():
    assert tce.fused_ce_supported(16384, 1024, 50304)
    assert tce.fused_ce_supported(300, 128, 1000)      # ragged N and V
    assert not tce.fused_ce_supported(1024, 100, 2688)  # H % 128
    assert not tce.fused_ce_supported(1024, 128, 1001)  # V % 8
    assert tce.fused_ce_supported(1024, 2048, 2688, torch.bfloat16)
    assert tce.fused_ce_supported(1024, 2048, 2688, torch.float32)
    assert not tce.fused_ce_supported(1024, 128, 2688, torch.float16)
