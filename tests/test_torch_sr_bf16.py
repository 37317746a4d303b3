"""``weights="sr-bf16"``: AdamW without fp32 masters, bf16 weights written
back by stochastic rounding, against the JAX reference on the CPU.

The port's noise comes from a ``torch.Generator`` and the reference's
import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
from rbg keys, whose bits its backend defines, so the two are held to the
reference's own statistical checks (tests/test_lean_optimizer.py), not
to each other's bits:

- unbiasedness: 2000 copies of 1 + 1.5e-3 (between two bf16 codes) round
  to exactly those two codes with a mean within 5e-4; fp32 passes
  through untouched;
- tracking: 30 AdamW steps on a quadratic, SR without a master against
  the fp32-master trajectory, relative distance < 0.05 (the reference's
  bound); the port's SR trajectory also within 0.05 of the reference's
  master trajectory (the two packages' master trajectories are bit-equal,
  tests/test_torch_train_step.py), and within 0.1 of the reference's SR
  trajectory: two trajectories of independent noise are each within 0.05
  of that master, so apart by up to twice that (here 0.0399 and 0.0423
  from the master, 0.0568 apart);
- ``make_train_step(weights="sr-bf16")``: the state has the tree, dtypes
  and shapes of the reference's ``make_sharded_train_step(weights=
  "sr-bf16")`` on a one-device mesh (no master, bf16 >= 2-D weights, fp32
  1-D leaves); from the reference's weights the first loss equals the
  reference's within rtol 1e-3 (the bf16 tolerance of
  tests/test_torch_train_step.py), and three steps lower it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.distributed.process_mesh import build_mesh
from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import train_step as jts
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.utils.convert import opt_state_from_jax, params_from_jax

SMALL = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=2, seq_len=128)
LR = 1e-2


@pytest.fixture
def no_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def test_stochastic_round_unbiased():
    x = torch.full((2000,), 1.0 + 1.5e-3, dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    out = tts._stochastic_round(x, torch.bfloat16, gen).float()
    assert len(torch.unique(out)) == 2          # the two neighbours
    assert abs(out.mean().item() - (1.0 + 1.5e-3)) < 5e-4
    same = tts._stochastic_round(x, torch.float32, gen)
    assert torch.equal(same, x)


def test_stochastic_round_wraps_like_uint32():
    """The add on the int32 view is the reference's uint32 add: negative
    values (sign bit set) round in magnitude, to their two neighbours,
    unbiased."""
    gen = torch.Generator().manual_seed(0)
    x = torch.tensor([-1.0 - 1.5e-3] * 1000, dtype=torch.float32)
    out = tts._stochastic_round(x, torch.bfloat16, gen).float()
    assert set(out.unique().tolist()) == {-1.0, -1.0078125}
    assert abs(out.mean().item() - x[0].item()) < 5e-4


def _quadratic(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 64).astype(np.float32),
            rng.randn(16, 64).astype(np.float32))


def _port_run(w0, target, sr: bool):
    tgt = torch.from_numpy(target)
    params = {"w": torch.from_numpy(w0).to(torch.bfloat16)}
    state = (tts.adamw_init(params) if sr else
             tts.adamw_init({"w": torch.from_numpy(w0)},
                            master_weights=True))
    gen = torch.Generator().manual_seed(5)
    for _ in range(30):
        g = {"w": 2 * (params["w"].float() - tgt) / tgt.numel()}
        tts.adamw_update(params, g, state, LR, stochastic_round=sr,
                         sr_generator=gen)
    return params["w"].float().numpy()


def test_sr_no_master_tracks_master_adamw():
    w0, target = _quadratic(4)
    w_master = _port_run(w0, target, sr=False)
    w_sr = _port_run(w0, target, sr=True)
    rel = np.linalg.norm(w_sr - w_master) / np.linalg.norm(w_master - w0)
    assert rel < 0.05, rel


def _jax_run(w0, target, sr: bool):
    jt = jnp.asarray(target)
    params = {"w": jnp.asarray(w0).astype(jnp.bfloat16)}
    state = (jts.adamw_init(params) if sr else
             jts.adamw_init({"w": jnp.asarray(w0)}, master_weights=True))
    for _ in range(30):
        g = {"w": 2 * (params["w"].astype(jnp.float32) - jt) / jt.size}
        params, state = jts.adamw_update(params, g, state, lr=LR,
                                         stochastic_round=sr)
    return np.asarray(params["w"].astype(jnp.float32))


def test_sr_tracks_the_reference_sr():
    w0, target = _quadratic(4)
    j_master, j_sr = _jax_run(w0, target, False), _jax_run(w0, target, True)
    w_port = _port_run(w0, target, sr=True)
    moved = np.linalg.norm(j_master - w0)
    assert moved > 0.1
    assert np.linalg.norm(j_sr - j_master) / moved < 0.05
    assert np.linalg.norm(w_port - j_master) / moved < 0.05
    rel = np.linalg.norm(w_port - j_sr) / moved
    assert rel < 0.1, rel


def test_adamw_update_sr_draws_from_the_given_generator():
    """``stochastic_round=True`` needs ``sr_generator``; two runs from
    equally seeded generators agree, and the 1-D fp32 leaf stays fp32."""
    w0, target = _quadratic(1)
    params = {"w": torch.from_numpy(w0).to(torch.bfloat16),
              "b": torch.zeros(64)}
    g = {"w": torch.from_numpy(target) * 1e-3, "b": torch.ones(64)}
    with pytest.raises(ValueError, match="sr_generator"):
        tts.adamw_update(params, g, tts.adamw_init(params), LR,
                         stochastic_round=True)
    outs = []
    for _ in range(2):
        params = {"w": torch.from_numpy(w0).to(torch.bfloat16),
                  "b": torch.zeros(64)}
        state = tts.adamw_init(params)
        tts.adamw_update(params, g, state, LR, stochastic_round=True,
                         sr_generator=torch.Generator().manual_seed(3))
        assert params["b"].dtype == torch.float32
        outs.append(params["w"].clone())
    assert torch.equal(*outs)


def test_train_step_state_and_loss_match_reference(no_auto_fusion):
    jc = jg.GPTConfig(**SMALL, dtype=jnp.bfloat16)
    tc = tg.GPTConfig(**SMALL, dtype=torch.bfloat16)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    kw = dict(m_dtype="bfloat16", v_dtype="bfloat16", weights="sr-bf16")
    jstep, jp, js = jts.make_sharded_train_step(jc, mesh, lr=1e-3,
                                                zero1=False, **kw)
    tstep, tp0, ts0 = tts.make_train_step(tc, lr=1e-3, device="cpu", **kw)
    assert "master" not in ts0 and "master" not in js
    # the port's own state: the reference's tree, dtypes and shapes
    for jtree, ttree in (
            (params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), tp0),
            (opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"), ts0)):
        wl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        gl = jax.tree_util.tree_leaves(ttree)
        assert len(wl) == len(gl)
        for (path, w), g in zip(wl, gl):
            assert (w.dtype, w.shape) == (g.dtype, g.shape), path
    for leaf in jax.tree_util.tree_leaves(tp0):
        assert leaf.dtype == (torch.bfloat16 if leaf.dim() >= 2
                              else torch.float32)
    # from the reference's weights and state
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    rng = np.random.RandomState(0)
    tok = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    lab = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    jl, _, _ = jstep(jp, js, tok, lab)
    losses = []
    for _ in range(3):
        loss, tp, ts = tstep(tp, ts, tok, lab)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], float(jl), rtol=1e-3)
    assert losses[-1] < losses[0]
    assert int(ts["t"]) == 3 and "master" not in ts
