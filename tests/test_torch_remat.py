"""GPT's remat policies in the port against the JAX reference on the CPU
(vocab 256, H 128, 2 layers, 2 heads of 64, S 128, B 2, fp32):

- ``remat=True`` saves the weight matmuls' outputs and the flash o/lse,
  ``"full"`` the flash o/lse only (reference gpt.py's policies): the
  gradients of every leaf under False, True and "full" are equal to each
  other bit for bit (one CPU thread: the multithreaded embedding backward
  sums in a varying order), and within rtol 1e-5 / atol 1e-5 of each
  leaf's largest gradient of ``jax.grad`` under the same setting (the
  reference with its compiler off; the port with its fusion compiler on
  and off);
- the flash forward runs L times per step under both policies (the
  backward never recomputes it), and 2L without a policy, which shows
  the count sees a recompute; the flash backward runs L times."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, seq_len=128)
B = 2
REMATS = (False, True, "full")


@pytest.fixture
def flags():
    """Set port flags (and the reference's use_auto_fusion off) for one
    test; restored after."""
    jold = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    saved = {}

    def set_(name, value):
        saved.setdefault(name, GLOBAL_FLAGS.get(name))
        GLOBAL_FLAGS.set(name, value)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield set_
    torch.set_num_threads(threads)
    for name, value in saved.items():
        GLOBAL_FLAGS.set(name, value)
    JFLAGS.set("use_auto_fusion", jold)


@pytest.fixture
def counts(monkeypatch):
    """Calls of the flash forward and backward wrappers, on any device."""
    n = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def run(*args, **kw):
            n[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(tfa, "flash_fwd", counted("fwd", tfa.flash_fwd))
    monkeypatch.setattr(tfa, "flash_bwd", counted("bwd", tfa.flash_bwd))
    return n


def _batch():
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randint(0, SHAPE["vocab_size"],
                                         size=(B, SHAPE["seq_len"])))
            for _ in range(2)]


def _port_grads(jp, remat, counts=None):
    tc = tg.GPTConfig(**SHAPE, dtype=torch.float32,
                      param_dtype=torch.float32, remat=remat)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    tok, lab = _batch()
    if counts is not None:
        counts.update(fwd=0, bwd=0)
    loss = tg.loss_fn(tp, tok, lab, tc)
    grads = torch.autograd.grad(loss, flat)
    return loss, grads


@pytest.mark.parametrize("fused", [True, False])
def test_grads_equal_across_policies_and_match_jax(flags, counts, fused):
    flags("use_auto_fusion", fused)
    jc = jg.GPTConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    jp = jg.init_params(jc, jax.random.PRNGKey(0))
    tok, lab = (jnp.asarray(t.numpy()) for t in _batch())
    L = SHAPE["n_layers"]
    runs = {}
    for remat in REMATS:
        loss, grads = _port_grads(jp, remat, counts)
        assert counts == {"fwd": L, "bwd": L}, (remat, counts)
        runs[remat] = grads
        jl, jgrads = jax.value_and_grad(jg.loss_fn)(
            jp, tok, lab, dataclasses.replace(jc, remat=remat))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        jflat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jgrads))[0]
        assert len(jflat) == len(grads)
        for (path, want), got in zip(jflat, grads):
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * scale,
                                       err_msg=f"{remat} {path}")
    for remat in (True, "full"):
        for a, b in zip(runs[remat], runs[False]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("fused", [True, False])
def test_without_a_policy_the_flash_forward_runs_twice(flags, counts,
                                                       monkeypatch, fused):
    flags("use_auto_fusion", fused)
    monkeypatch.setattr(tg, "_REMAT_POLICY", {True: None, "full": None})
    # programs traced under the policies must not be replayed
    monkeypatch.setattr(tcompiler, "_WRAPPERS", {})
    jc = jg.GPTConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    jp = jg.init_params(jc, jax.random.PRNGKey(0))
    L = SHAPE["n_layers"]
    _port_grads(jp, "full", counts)
    assert counts == {"fwd": 2 * L, "bwd": L}
