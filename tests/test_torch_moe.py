"""The port's MoE layers against the JAX reference on one process (CPU):

- ``moe_block_apply`` (Switch top-1, capacity, aux) at a capacity factor
  that drops tokens: fp32 outputs and aux within rtol 1e-5 (summation
  order only), the dropped tokens' rows exactly their residual; bf16
  within the train-step bf16 bar (rtol 1e-3 on a sum of |y|, every
  routing decision the same);
- the slot-index dispatch and combine bitwise equal to the reference's
  one-hot form (``moe_dispatch_dense``, ``moe_combine_dense``) in fp32
  and bf16;
- ``loss_fn`` of a small MoE GPT and the gradient of every leaf: rtol
  1e-5 on the loss, gradients within 1e-5 of each leaf's largest (the
  GPT test's bar), the port's fused path (its compiler on) against the
  reference's compiler off; the port's fused and unfused losses bitwise
  and their gradients within the same bar (K6's composed backward sums
  in another order than autograd's LayerNorm: 5.7e-7 of a leaf's
  largest, measured);
- the fusion plan: the MoE LayerNorm is one more ``layer_epilogue``
  site a layer and the MoE bias + gelu, a [E, 1, F] broadcast, no
  ``bias_gelu`` site (the reference's matcher takes a bias of shape [F]
  only, ``paddle_tpu/compiler/catalog.py::match_bias_gelu``).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2,
             seq_len=128, n_experts=4, n_moe_layers=2)
B = 2


@pytest.fixture
def no_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _cfgs(dt="float32", **kw):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dt == "bfloat16"
                else (jnp.float32, torch.float32))
    shape = dict(SHAPE, **kw)
    return (jg.GPTConfig(**shape, dtype=jdt),
            tg.GPTConfig(**shape, dtype=tdt))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _layer(dt, cap):
    """One MoE layer's params and an input, both packages."""
    jc, tc = _cfgs(dt, moe_capacity_factor=cap)
    jp = jg.init_params(jc, jax.random.PRNGKey(1))
    jmp = jax.tree.map(lambda a: a[0], jp["moe"])
    rng = np.random.RandomState(2)
    x = rng.randn(B, SHAPE["seq_len"], SHAPE["hidden"]).astype(np.float32)
    jx = jnp.asarray(x).astype(jc.dtype)
    tmp = params_from_jax(_np(jmp), "cpu")
    tx = params_from_jax(np.asarray(jx), "cpu")
    return jc, tc, jmp, jx, tmp, tx


def _f(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_block_matches_with_drops(dt):
    jc, tc, jmp, jx, tmp, tx = _layer(dt, cap=0.5)
    jy, jaux = jg.moe_block_apply(jmp, jx, jc)
    ty, taux = tg.moe_block_apply(tmp, tx, tc)
    jy = np.asarray(jy.astype(jnp.float32))
    # a quarter of the slots for the tokens: some are dropped, their row
    # the residual itself
    H = SHAPE["hidden"]
    flat = tg._layer_norm(tx, tmp["ln_g"], tmp["ln_b"], tc.eps).reshape(
        -1, H)
    N = flat.shape[0]
    C = max(1, int(0.5 * N / SHAPE["n_experts"]))
    _, _, _, slot = tg.moe_route(flat, tmp["router_w"], C)
    dropped = (slot == SHAPE["n_experts"] * C).numpy()
    assert 0 < dropped.sum() < N
    assert torch.equal(ty.reshape(N, H)[dropped], tx.reshape(N, H)[dropped])
    if dt == "float32":
        np.testing.assert_allclose(_f(ty), jy, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    else:
        err = np.abs(_f(ty) - jy).sum() / np.abs(jy).sum()
        assert err <= 1e-3, err
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-3)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dispatch_and_combine_equal_the_one_hot_form(dt):
    torch.manual_seed(0)
    E, C, N, H = 4, 24, 128, 64
    flat = torch.randn(N, H).to(dt)
    router = torch.randn(H, E) * 0.1
    _, _, gate, slot = tg.moe_route(flat, router, C)
    assert (slot == E * C).any()
    assert torch.equal(tg.moe_dispatch(flat, slot, E, C),
                       tg.moe_dispatch_dense(flat, slot, E, C))
    hout = torch.randn(E, C, H).to(dt)
    assert torch.equal(tg.moe_combine(hout, slot, gate),
                       tg.moe_combine_dense(hout, slot, gate))


def _loss_and_grads(params, tok, lab, cfg):
    flat = [p.requires_grad_(True) for p in jax.tree.leaves(params)]
    loss = tg.loss_fn(params, torch.as_tensor(tok), torch.as_tensor(lab),
                      cfg)
    return loss, torch.autograd.grad(loss, flat)


def test_moe_gpt_loss_and_grads_match(no_auto_fusion, monkeypatch):
    jc, tc = _cfgs()
    jp = jg.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tok = rng.randint(0, SHAPE["vocab_size"], size=(B, SHAPE["seq_len"]))
    lab = rng.randint(0, SHAPE["vocab_size"], size=(B, SHAPE["seq_len"]))
    jl, jgr = jax.value_and_grad(
        lambda p: jg.loss_fn(p, jnp.asarray(tok), jnp.asarray(lab), jc))(jp)
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    tp = params_from_jax(_np(jp), "cpu")
    tl, tgr = _loss_and_grads(tp, tok, lab, tc)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for g, w in zip(tgr, jax.tree.leaves(_np(jgr))):
        np.testing.assert_allclose(_f(g), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # the fused program ran: one layer epilogue a LayerNorm (2L + M + 1),
    # a bias + gelu a dense layer, none in the MoE layers
    rep = tcompiler.last_report()
    L, M = SHAPE["n_layers"], SHAPE["n_moe_layers"]
    sites = {}
    for row in rep.sites:
        sites[row["template"]] = sites.get(row["template"], 0) + 1
    assert sites == {"layer_epilogue": 2 * L + M + 1, "bias_gelu": L}
    assert rep.n_applied == rep.n_sites and not rep.errors
    # the unfused composition: the same loss bits
    TFLAGS.set("use_auto_fusion", False)
    try:
        ul, ugr = _loss_and_grads(params_from_jax(_np(jp), "cpu"), tok, lab,
                                  tc)
    finally:
        TFLAGS.set("use_auto_fusion", True)
    assert ul.item() == tl.item()
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    for name, a, b in zip(names, ugr, tgr):
        np.testing.assert_allclose(_f(a), _f(b), rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item(),
                                   err_msg=name)
