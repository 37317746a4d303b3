"""The port's head-major flash attention (K17) against the reference's
transpose-layout Pallas kernels (``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``, interpret mode on
the CPU), and the routes that reach it.

- K17's plain forward (o, lse) and backward (dq, dk, dv) against
  ``_flash_fwd`` / ``_flash_bwd`` with ``native=False``, and
  ``flash_attention_raw``'s gradients against ``jax.grad`` of the
  reference's under ``FLAGS_flash_attention_native_layout=0`` (the
  pattern of tests/test_flash_native_layout.py); fp32, rtol and atol
  1e-5 (summation order only).
- Where the reference's lane fusion fails (d 64, an odd head count)
  ``flash_attention_raw`` is head-major with the flag on as well.
- GPT with 5 heads of 64 (hidden 320, S 128): the fused-qkv gate fails,
  and the attention goes through ``flash_attention_raw`` (K17), as the
  reference's ``_attention`` does; its loss and gradients equal JAX's.
  The same with the flag off at 4 heads of 64, and LLaMA's loss and
  gradients under the flag (unfused rope, then K17).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import gpt as jg
from paddle_tpu.models import llama as jl
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.utils.convert import params_from_jax

TOL = 1e-5
B, S = 2, 128
CASES = [(5, 64, True), (4, 64, False), (2, 128, True), (1, 256, False)]


@pytest.fixture
def head_major():
    """FLAGS_flash_attention_native_layout=0 in both packages (the
    reference's compiler off, as the other parity tests run it)."""
    old = (GLOBAL_FLAGS.get("flash_attention_native_layout"),
           JFLAGS.get("flash_attention_native_layout"),
           JFLAGS.get("use_auto_fusion"))
    GLOBAL_FLAGS.set("flash_attention_native_layout", False)
    JFLAGS.set("flash_attention_native_layout", False)
    JFLAGS.set("use_auto_fusion", False)
    yield
    GLOBAL_FLAGS.set("flash_attention_native_layout", old[0])
    JFLAGS.set("flash_attention_native_layout", old[1])
    JFLAGS.set("use_auto_fusion", old[2])


@pytest.fixture
def no_jax_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _qkv(h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, S, h, d)).astype(np.float32)
            for _ in range(4)]


def _hm(a):
    return torch.from_numpy(np.swapaxes(a, 1, 2).copy())


@pytest.mark.parametrize("h,d,causal", CASES)
def test_plain_forward_matches_pallas(h, d, causal):
    q, k, v, _ = _qkv(h, d)
    scale = d ** -0.5
    jo, jlse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), causal, scale,
                              with_lse=True, native=False)
    o, lse = tfa.flash_fwd_hm(_hm(q), _hm(k), _hm(v), causal, scale)
    assert o.shape == (B, h, S, d) and lse.shape == (B, h, S)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(jo),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,d,causal", CASES)
def test_plain_backward_matches_pallas(h, d, causal):
    q, k, v, do = _qkv(h, d, seed=1)
    scale = d ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale, with_lse=True,
                              native=False)
    want = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, causal, scale,
                          native=False)
    got = tfa.flash_bwd_hm(_hm(q), _hm(k), _hm(v), _hm(np.asarray(jo)),
                           torch.from_numpy(np.asarray(jlse)[:, :, 0].copy()),
                           _hm(do), causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)


def _raw_grads_match(h, d, causal, seed):
    q, k, v, do = _qkv(h, d, seed=seed)

    def f(q, k, v):
        return (jfa.flash_attention_raw(q, k, v, causal=causal)
                * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = dict(tfa.RAW_ROUTES)
    out = tfa.flash_attention_raw(*ts, causal=causal)
    assert tfa.RAW_ROUTES["head_major"] == before["head_major"] + 1
    assert tfa.RAW_ROUTES["native"] == before["native"]
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("h,d,causal", CASES)
def test_raw_under_the_flag_matches_jax_grad(head_major, h, d, causal):
    _raw_grads_match(h, d, causal, seed=2)


@pytest.mark.parametrize("h", [3, 5])
def test_odd_heads_at_d64_take_head_major(h):
    assert GLOBAL_FLAGS.get("flash_attention_native_layout")
    assert not tfa._native_supported(h, 64) and tfa._native_supported(4, 64)
    assert tfa._native_supported(h, 128)
    _raw_grads_match(h, 64, True, seed=3)


def test_flag_turns_the_fused_entries_off(head_major):
    """As the reference's gates: the fused-qkv and rope entries are off
    under the flag (tests/test_flash_native_layout.py:135-146)."""
    from paddle_tpu.ops.pallas import fused_rope_attention as jr
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as tr

    shape = (2, 256, 3 * 4 * 64)
    assert not jfa.flash_qkv_supported(shape, 4, jnp.float32)
    assert not tfa.flash_qkv_supported(shape, 4, torch.float32)
    assert not jr.fused_rope_supported((2, 256, 4, 128), jnp.float32)
    assert not tr.fused_rope_supported((2, 256, 4, 128), torch.float32)
    assert tfa.flash_supported((2, 256, 4, 64), torch.float32)


def _gpt_loss_and_grads_match(n_heads, hidden, monkeypatch):
    shape = dict(vocab_size=256, hidden=hidden, n_layers=2,
                 n_heads=n_heads, seq_len=S)
    jc = jg.GPTConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    tc = tg.GPTConfig(**shape, dtype=torch.float32, param_dtype=torch.float32)
    rng = np.random.RandomState(4)
    tok, lab = (rng.randint(0, 256, size=(B, S)) for _ in range(2))
    jp = jg.init_params(jc, jax.random.PRNGKey(0))
    loss, grads = jax.value_and_grad(jg.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(lab), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    before = dict(tfa.RAW_ROUTES)
    tloss = tg.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(lab), tc)
    # the attention of every layer went through flash_attention_raw, K17
    assert tfa.RAW_ROUTES["head_major"] == before["head_major"] + 2
    assert tfa.RAW_ROUTES["native"] == before["native"]
    # the compiler planned the model around it (K6 needs hidden % 128)
    rep = tcompiler.last_report()
    assert rep.n_sites == 7 and not rep.errors
    assert rep.n_applied == (7 if hidden % 128 == 0 else 2)
    tgrads = torch.autograd.grad(tloss, flat)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=TOL)
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, grads))[0]
    assert len(jflat) == len(tgrads)
    for (path, want), got in zip(jflat, tgrads):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * scale, err_msg=str(path))


def test_gpt_odd_heads_reach_flash_attention_raw(no_jax_fusion,
                                                 monkeypatch):
    """hidden 320, 5 heads of 64: the fused-qkv gate fails on both sides
    and the reference's _attention calls flash_attention_raw."""
    assert not tfa.flash_qkv_supported((B, S, 3 * 320), 5, torch.float32)
    _gpt_loss_and_grads_match(5, 320, monkeypatch)


def test_gpt_under_the_flag_matches_jax(head_major, monkeypatch):
    _gpt_loss_and_grads_match(4, 256, monkeypatch)


def test_llama_under_the_flag_matches_jax(head_major, monkeypatch):
    """head dim 128: the rope template would take K11 with the flag on;
    under it the unfused rope runs, then flash_attention_raw (K17)."""
    shape = dict(vocab_size=256, hidden=256, n_layers=2, n_heads=2,
                 n_kv_heads=1, ffn_hidden=384, max_seq_len=S)
    jc = jl.LlamaConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    tc = tl.LlamaConfig(**shape, dtype=torch.float32,
                        param_dtype=torch.float32)
    jp = jl.init_llama_params(jc, jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    tok, lab = (rng.randint(0, 256, size=(B, S)) for _ in range(2))
    want_loss, want = jax.value_and_grad(jl.llama_loss)(
        jp, jnp.asarray(tok), jnp.asarray(lab), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    before = tfa.RAW_ROUTES["head_major"]
    loss = tl.llama_loss(tp, torch.from_numpy(tok), torch.from_numpy(lab),
                         tc)
    assert tfa.RAW_ROUTES["head_major"] >= before + 2
    rep = tcompiler.last_report()
    assert not any(s["template"] == "rope_attention" and s["applied"]
                   for s in rep.sites), rep.sites
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    for (path, w), g in zip(jflat, grads):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL * scale,
                                   err_msg=str(path))
