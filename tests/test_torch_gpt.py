"""The port's GPT against the JAX reference on the CPU: presets, the
parameter tree, and the loss with the gradient of every leaf at the
reference bench's CPU configuration (vocab 1024, H 256, 4 layers, 4
heads, S 256, B 2), in fp32. The port runs its default path, the fusion
compiler on (K6 at every LayerNorm, K7 at every gelu, their plain arms
on the CPU); the reference runs with its compiler off, which it holds
equal to its fused path, and, where the JAX compiler runs (it needs
``jax.core.Var``), with it on. The reference's Pallas kernels run in
interpret mode. Tolerance: rtol 1e-5 on the loss; gradients rtol 1e-5
with atol 1e-5 of each leaf's largest gradient (summation order only)."""

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
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.utils.convert import params_from_jax
from torch_sharded_common import count_flash

SHAPE = dict(vocab_size=1024, hidden=256, n_layers=4, n_heads=4,
             seq_len=256)
B = 2


@pytest.fixture
def no_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _cfgs(**kw):
    return (jg.GPTConfig(**SHAPE, dtype=jnp.float32,
                         param_dtype=jnp.float32, **kw),
            tg.GPTConfig(**SHAPE, dtype=torch.float32,
                         param_dtype=torch.float32, **kw))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SHAPE["vocab_size"], size=(B, SHAPE["seq_len"])),
            rng.randint(0, SHAPE["vocab_size"], size=(B, SHAPE["seq_len"])))


def test_presets_match():
    for name in ("gpt3-125m", "gpt3-350m", "gpt3-760m", "gpt3-1.3b",
                 "gpt3-2.7b", "gpt3-6.7b", "gpt3-13b"):
        j, t = jg.gpt_presets(name), tg.gpt_presets(name)
        for f in dataclasses.fields(jg.GPTConfig):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(j, f.name) == getattr(t, f.name), (name, f)
        assert j.head_dim == t.head_dim


@pytest.mark.parametrize("tie", [True, False])
def test_param_tree_names_shapes_dtypes(tie):
    jc = jg.GPTConfig(**SHAPE, tie_embeddings=tie)
    tc = tg.GPTConfig(**SHAPE, tie_embeddings=tie)
    jp = jax.tree.map(np.asarray, jg.init_params(jc, jax.random.PRNGKey(0)))
    tp = tg.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        assert tflat[path].shape == leaf.shape and \
            tflat[path].dtype == leaf.dtype, path


def test_layer_norm_matches():
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 7, 64) * 2 + 0.5).astype(np.float32)
    g, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = jg._layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          1e-5)
    got = tg._layer_norm(*(torch.from_numpy(a) for a in (x, g, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _check_loss_and_grads(loss_chunk, remat, monkeypatch):
    jc, tc = _cfgs(remat=remat)
    jp = jg.init_params(jc, jax.random.PRNGKey(0))
    tok, lab = _batch()
    loss, grads = jax.value_and_grad(jg.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(lab), jc, loss_chunk=loss_chunk)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    tloss = tg.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(lab), tc,
                       loss_chunk=loss_chunk)
    # the port's fused path ran: 2L + 1 layer epilogues and L gelus
    L = SHAPE["n_layers"]
    rep = tcompiler.last_report()
    assert (rep.n_sites, rep.n_applied) == (3 * L + 1, 3 * L + 1)
    tgrads = torch.autograd.grad(tloss, flat)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, grads))[0]
    assert len(jflat) == len(tgrads)
    for (path, want), got in zip(jflat, tgrads):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=str(path))


@pytest.mark.parametrize("loss_chunk,remat", [(512, False), (0, False),
                                              (512, True)])
def test_loss_and_grads_match(no_auto_fusion, monkeypatch, loss_chunk,
                              remat):
    _check_loss_and_grads(loss_chunk, remat, monkeypatch)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_the_fused_reference(monkeypatch, remat):
    _needs_the_jax_compiler()
    assert JFLAGS.get("use_auto_fusion")
    _check_loss_and_grads(512, remat, monkeypatch)


def test_later_slices_raise(monkeypatch):
    # ring_axis on one device has come: no mesh axis to ring over, so the
    # fused-qkv entry is skipped and attention goes through
    # flash_attention_raw on the split q, k, v (K1-sep forward, K3-sep
    # backward), as the reference's; the loss is the fused entry's. The
    # GSPMD layout hooks still give way to the sharded step's own forward
    _, tc = _cfgs()
    ring = dataclasses.replace(tc, ring_axis="mp")
    tp = tg.init_params(ring, torch.Generator().manual_seed(0), "cpu")
    tok, lab = (torch.from_numpy(a) for a in _batch())
    base = tg.loss_fn(tp, tok, lab, tc)
    counts = count_flash(monkeypatch)
    leaves = [v for d in (tp, tp["blocks"]) for v in d.values()
              if isinstance(v, torch.Tensor)]
    for t in leaves:
        t.requires_grad_(True)
    loss = tg.loss_fn(tp, tok, lab, ring)
    torch.autograd.grad(loss, leaves)
    L = SHAPE["n_layers"]
    assert counts == {"flash_fwd": 0, "flash_fwd_sep": L,
                      "flash_bwd_sep": L}
    np.testing.assert_allclose(loss.item(), base.item(), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="make_sharded_train_step"):
        tg.loss_fn(tp, tok, lab, tc, sp_constraint=lambda x: x)


def test_flops_per_token_matches_bench():
    import bench

    for name in ("gpt3-125m", "gpt3-350m", "gpt3-1.3b"):
        assert tg.gpt_flops_per_token(tg.gpt_presets(name)) == \
            bench._flops_per_token(jg.gpt_presets(name))


def _needs_the_jax_compiler():
    if not hasattr(jax.core, "Var"):
        pytest.skip("this jax has no jax.core.Var, which the JAX compiler "
                    "(paddle_tpu.compiler) needs")
