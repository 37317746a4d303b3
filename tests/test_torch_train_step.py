"""The port's AdamW and single-device training step against the JAX
reference on the CPU. The port's step runs its default path, the fusion
compiler on; the reference's runs with its compiler off (which it holds
equal to its fused path) and, where the JAX compiler runs (it needs
``jax.core.Var``), with it on.

- ``adamw_update`` from identical numpy state, two steps, in every moment
  storage (fp32, bf16, int8 m with bf16 v), with and without fp32
  masters: bit-equal params, moments, masters and step count.
- a 3-step trajectory of ``make_train_step`` against
  ``make_sharded_train_step`` on a one-device mesh from the same weights
  and batch: fp32 losses within rtol 1e-5; bf16 compute with fp32
  masters (bf16 rounds at other places in the two frameworks), losses
  within rtol 1e-3 (measured 7e-5; a step moves the loss by ~10%) and,
  per master leaf, sum |torch - JAX| at most 5% of sum |JAX's update|
  (measured at most 2.3%): a master left in place or moved the wrong way
  is off by 100% or more.
- the paths of later slices raise (``weights="sr-bf16"``, which has
  come, in tests/test_torch_sr_bf16.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.distributed.process_mesh import build_mesh
from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import train_step as jts
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.utils.convert import opt_state_from_jax, params_from_jax

MODES = [(None, None), ("bfloat16", "bfloat16"), ("int8", "bfloat16")]
SMALL = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=2, seq_len=128)
LR = 1e-3


@pytest.fixture
def no_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _assert_trees_equal(jtree, ttree):
    want = params_from_jax(_np(jtree), "cpu")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree_util.tree_leaves(ttree)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert w.dtype == g.dtype and w.shape == g.shape, path
        diff = int((_bits(w) != _bits(g)).sum())
        assert diff == 0, f"{path}: {diff} elements differ"


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("m_dtype,v_dtype", MODES)
def test_adamw_update_bit_equal(master, m_dtype, v_dtype):
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(64, 96).astype(np.float32) * 0.1,
          "e": {"t": rng.randn(3000, 4).astype(np.float32) * 0.1},
          "b": rng.randn(96).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    js = jts.adamw_init(jp, master_weights=master, m_dtype=m_dtype,
                        v_dtype=v_dtype)
    if master:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2
                          else a, jp)
    tp = params_from_jax(_np(jp), "cpu")
    ts = opt_state_from_jax(_np(js), "cpu")
    for seed in (1, 2):
        g = jax.tree.map(lambda a: jnp.asarray(np.random.RandomState(
            seed).randn(*a.shape) * 0.01, a.dtype), jp)
        jp, js = jts.adamw_update(jp, g, js, LR, m_dtype=m_dtype,
                                  v_dtype=v_dtype)
        tp, ts = tts.adamw_update(tp, params_from_jax(_np(g), "cpu"), ts,
                                  LR, m_dtype=m_dtype, v_dtype=v_dtype)
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(js, ts)


@pytest.mark.parametrize("bf16", [False, True])
def test_three_step_trajectory_matches(no_auto_fusion, monkeypatch, bf16):
    _check_trajectory(bf16, monkeypatch)


@pytest.mark.parametrize("bf16", [False, True])
def test_three_step_trajectory_matches_the_fused_reference(monkeypatch,
                                                            bf16):
    _needs_the_jax_compiler()
    assert JFLAGS.get("use_auto_fusion")
    _check_trajectory(bf16, monkeypatch)


def _check_trajectory(bf16, monkeypatch):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jc = jg.GPTConfig(**SMALL, dtype=jdt)
    tc = tg.GPTConfig(**SMALL, dtype=tdt)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    kw = dict(m_dtype="bfloat16", v_dtype="bfloat16") if bf16 else {}
    jstep, jp, js = jts.make_sharded_train_step(jc, mesh, lr=LR, zero1=False,
                                                **kw)
    tstep, _, _ = tts.make_train_step(tc, lr=LR, device="cpu", **kw)
    tp = params_from_jax(_np(jp), "cpu")
    ts = opt_state_from_jax(_np(js), "cpu")
    start = params_from_jax(_np(js["master"]), "cpu") if bf16 else None
    rng = np.random.RandomState(0)
    tok = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    lab = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    jl, tl = [], []
    monkeypatch.setattr(tcompiler, "_LAST_REPORT", None)
    for _ in range(3):
        loss, jp, js = jstep(jp, js, tok, lab)
        jl.append(float(loss))
        loss, tp, ts = tstep(tp, ts, tok, lab)
        tl.append(loss.item())
    # the port's fused step ran: 2L + 1 layer epilogues and L gelus
    rep = tcompiler.last_report()
    L = SMALL["n_layers"]
    assert (rep.n_sites, rep.n_applied) == (3 * L + 1, 3 * L + 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if bf16 else 1e-5)
    assert tl[-1] < tl[0]
    if bf16:
        want = params_from_jax(_np(js["master"]), "cpu")
        # the key third of qkv_b has a gradient of 0 in exact arithmetic
        # (softmax ignores a shift of a query's scores), so both updates
        # there are AdamW-normalized rounding noise: left out
        H = SMALL["hidden"]
        keep = torch.ones(3 * H, dtype=torch.bool)
        keep[H:2 * H] = False
        names = [jax.tree_util.keystr(k) for k, _ in
                 jax.tree_util.tree_flatten_with_path(want)[0]]
        for name, j0, j, t in zip(names, jax.tree_util.tree_leaves(start),
                                  jax.tree_util.tree_leaves(want),
                                  jax.tree_util.tree_leaves(ts["master"])):
            if not j.numel():           # 1-D leaves keep no master
                continue
            if "qkv_b" in name:
                j0, j, t = j0[..., keep], j[..., keep], t[..., keep]
            drift = (t - j).abs().sum() / (j - j0).abs().sum()
            assert drift <= 0.05, (name, drift.item())


def test_later_slices_raise():
    tc = tg.GPTConfig(**SMALL, dtype=torch.float32)
    # weights="sr-bf16" has come (tests/test_torch_sr_bf16.py); a mode of
    # no slice is refused
    with pytest.raises(ValueError):
        tts.make_train_step(tc, weights="sr-fp8", device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tts.make_train_step(tc, n_microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tts.make_train_step(dataclasses.replace(tc, n_experts=4,
                                                n_moe_layers=1),
                            device="cpu")
    with pytest.raises(ValueError):
        tts.make_train_step(tc, v_dtype="int8", device="cpu")


def _needs_the_jax_compiler():
    if not hasattr(jax.core, "Var"):
        pytest.skip("this jax has no jax.core.Var, which the JAX compiler "
                    "(paddle_tpu.compiler) needs")
