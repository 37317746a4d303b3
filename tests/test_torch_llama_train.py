"""LLaMA's backward in the port against the JAX reference on the CPU, fp32:

- ``llama_loss`` and the gradient of every parameter against
  ``jax.grad(llama_loss)`` (the reference with its compiler off, which it
  holds equal to its fused path; the JAX compiler needs
  ``jax.core.Var``) on vocab 256, hidden 256, 2 layers, S 128, B 2, at
  head dim 64 (4 heads, 2 kv heads: the separate-input flash, K1-sep +
  K3) and head dim 128 (2 heads, 1 kv head: with the port's compiler on,
  K11 + its backward), remat on and off, the port's compiler on and off;
  loss rtol 1e-5, gradients rtol 1e-5 with atol 1e-5 of each leaf's
  largest gradient (summation order only). The gradients flow to the kv
  heads through autograd of the GQA repeat;
- K11's backward (K3 on the re-rotated q/k, then the rotary pullback)
  against ``jax.grad`` of the reference's ``fused_rope_flash_attention``
  (its Pallas kernels in interpret mode), q rotated alone, k alone and
  both, atol/rtol 1e-5; cos and sin get no gradient."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import llama as jl
from paddle_tpu.ops.pallas import fused_rope_attention as jr
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.kernels import fused_rope_attention as tr
from paddle_tpu_torch.utils.convert import params_from_jax

TOL = 1e-5
B, S = 2, 128


@pytest.fixture
def fusion():
    """Set the port's use_auto_fusion (the reference's stays off)."""
    old, jold = (GLOBAL_FLAGS.get("use_auto_fusion"),
                 JFLAGS.get("use_auto_fusion"))
    JFLAGS.set("use_auto_fusion", False)
    yield lambda on: GLOBAL_FLAGS.set("use_auto_fusion", on)
    GLOBAL_FLAGS.set("use_auto_fusion", old)
    JFLAGS.set("use_auto_fusion", jold)


def _shape(n_heads, n_kv_heads):
    return dict(vocab_size=256, hidden=256, n_layers=2, n_heads=n_heads,
                n_kv_heads=n_kv_heads, ffn_hidden=384, max_seq_len=S)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("heads", [(4, 2), (2, 1)], ids=["d64", "d128"])
def test_loss_and_grads_match_jax(fusion, monkeypatch, heads, remat,
                                  fused):
    fusion(fused)
    shape = _shape(*heads)
    jc = jl.LlamaConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    tc = tl.LlamaConfig(**shape, dtype=torch.float32,
                        param_dtype=torch.float32)
    jp = jl.init_llama_params(jc, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    tok, lab = (rng.randint(0, shape["vocab_size"], size=(B, S))
                for _ in range(2))

    def jloss(params):
        logits = jl.llama_apply(params, jnp.asarray(tok), jc, remat=remat)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(lab)[..., None],
                                   axis=-1)[..., 0]
        return (lse - gold).mean()

    want_loss, want = jax.value_and_grad(jloss)(jp)
    if remat:       # the reference's own entry takes its default, remat on
        np.testing.assert_allclose(
            float(jl.llama_loss(jp, jnp.asarray(tok), jnp.asarray(lab), jc)),
            float(want_loss), rtol=1e-6)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    if remat:
        loss = tl.llama_loss(tp, torch.from_numpy(tok), torch.from_numpy(lab),
                             tc)
    else:
        logits = tl.llama_apply(tp, torch.from_numpy(tok), tc, remat=False)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, shape["vocab_size"]),
            torch.from_numpy(lab).reshape(-1).long())
    if fused:       # the compiler planned the model (K11 where d is 128)
        rep = tcompiler.last_report()
        L = shape["n_layers"]
        rope = {s["applied"] for s in rep.sites
                if s["template"] == "rope_attention"}
        assert rope == ({True} if heads[0] == 2 else {False}), rep.sites
        assert sum(s["template"] == "swiglu" and s["applied"]
                   for s in rep.sites) == L and not rep.errors
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    assert len(jflat) == len(grads)
    for (path, w), g in zip(jflat, grads):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL * scale,
                                   err_msg=str(path))


def _operands(seed, h, d):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, h, d).astype(np.float32)
                   for _ in range(4))
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.arange(S, dtype=np.float32)[:, None] * inv
    return q, k, v, do, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("rope_q,rope_k", [(True, True), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("h,d", [(2, 128), (1, 256)])
def test_rope_attention_backward_matches_jax_grad(h, d, rope_q, rope_k):
    q, k, v, do, cos, sin = _operands(d + rope_k, h, d)

    def f(q, k, v):
        o = jr.fused_rope_flash_attention(q, k, v, jnp.asarray(cos),
                                          jnp.asarray(sin), causal=True,
                                          rope_q=rope_q, rope_k=rope_k,
                                          use_kernel=True)
        return (o * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tables = [torch.from_numpy(a).requires_grad_(True) for a in (cos, sin)]
    o = tr.fused_rope_flash_attention(*leaves, *tables, causal=True,
                                      rope_q=rope_q, rope_k=rope_k)
    got = torch.autograd.grad(o, leaves + tables, torch.from_numpy(do),
                              allow_unused=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    assert got[3] is None and got[4] is None
