"""The incubate MoE Layer (``MoELayer``, the gates) and the expert
all-to-all (``distributed.utils.global_scatter`` / ``global_gather``) in
the port against the JAX reference's.

The reference holds every expert in one process. Over 4 gloo ranks of
the port (tests/torch_dist_worker.py, rank side
tests/torch_pp_moe_cases.py), a moe group of W ranks holds E / W
experts a rank, group rank r the rows r of the batch; by the MoE rule
(``incubate/distributed/models/moe/moe_layer.py``: capacity over the
group's tokens, queue positions in the group's rank-major token order)
the Layer equals the reference's Layer holding all E experts on the
concatenated batch, capacity drops included. fp32 within rtol 1e-5 (an
absolute floor of 1e-6 of the tensor's largest magnitude):

- tests/test_moe_sp_sep.py's three MoE cases on both packages from the
  same weights: 4 AdamW steps of the GShard Layer, the naive top-1
  Layer at capacity factor 0.25 (its drops), the scatter / gather
  round trip (and the reference's ``ValueError`` on unequal totals);
- the Layer at moe groups of 1, 2 and 4 on a sum loss plus the GShard
  auxiliary loss: outputs, input gradients, the auxiliary loss (both
  means over the group's tokens), every expert's gradient and the
  gate's (summed over the group);
- a mean loss over each rank's tokens: every gradient W times the
  reference's mean over the concatenated batch (ROADMAP Queue 3,
  defect K);
- ``global_scatter`` / ``global_gather`` over 4 ranks on uneven counts:
  the rows each expert receives, the round trip, the gradient;
- ``SwitchGate``: eval mode the reference's top-1; its training noise
  by property (the port's generator).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.distributed import fleet as jfleet

import torch_dist_common as C

port.set_device("cpu")
N_RANKS = 4
MOE = dict(name="moe", kind="moe_group", d=8, h=16, E=8, N=24, cf=0.5,
           seed=5)
MOE_DP = dict(name="moe_dp", kind="moe_dp", d=8, h=16, E=8, N=24, cf=0.5,
              seed=9, lr=0.1, clip=1.0)
CASES = [MOE, MOE_DP]


def _close(a, b, what, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-6 * float(np.abs(b).max()),
                               err_msg=what)


def _layer(pkg, state, E, gate=None, cf=1.25, d=8, h=16):
    from importlib import import_module

    moe = import_module(f"{pkg.__name__}.incubate.distributed.models.moe")
    nn = pkg.nn
    experts = [nn.Sequential(nn.Linear(d, h), nn.GELU(), nn.Linear(h, d))
               for _ in range(E)]
    layer = moe.MoELayer(d, experts, gate=gate or {"type": "gshard",
                                                   "top_k": 2},
                         capacity_factor=cf)
    for k, v in layer.state_dict().items():
        v.set_value(pkg.to_tensor(state[k]))
    return layer


def _leaf(pkg, a):
    t = pkg.to_tensor(a)
    t.stop_gradient = False
    return t


def _ref_moe():
    """The reference's Layer with all E experts on each group size's
    concatenated batch: a sum loss plus the auxiliary loss, then a mean
    loss."""
    c = MOE
    state = C.moe_arrays(c["seed"], c["d"], c["h"], c["E"])
    out = {}
    for W in (1, 2, 4):
        rng = np.random.RandomState(c["seed"] + W)
        X = rng.randn(W * c["N"], c["d"]).astype(np.float32)
        cot = rng.randn(W * c["N"], c["d"]).astype(np.float32)
        for kind in ("sum", "mean"):
            layer = _layer(ref, state, c["E"], cf=c["cf"])
            x = _leaf(ref, X)
            y = layer(x)
            aux = layer.gate.get_loss()
            prod = y * ref.to_tensor(cot)
            loss = prod.sum() + aux if kind == "sum" else prod.mean()
            loss.backward()
            out[f"g{W}/{kind}"] = {
                "y": y.numpy(), "xgrad": x.grad.numpy(),
                "aux": float(aux.numpy()),
                "grad": {n: p.grad.numpy()
                         for n, p in layer.named_parameters()}}
    return out


def _ref_moe_dp():
    """The reference's Layer with all E experts under Paddle's dp rule:
    at dp 2 x mp 2 (the moe group over mp) the mean of its gradients on
    the two dp replicas' batches, at dp 4 (the moe group over dp) its
    gradient on the one batch; a sum loss plus the auxiliary loss; the
    global norm and the clipped SGD step (numpy, fp64 norm)."""
    c = MOE_DP
    state = C.moe_arrays(c["seed"], c["d"], c["h"], c["E"])
    out = {}
    for tag, batches, W in (("mp", 2, 2), ("dp", 1, 4)):
        X, cot = C.moe_batches(c["seed"] + W, batches, W * c["N"], c["d"])
        grads = []
        for j in range(batches):
            layer = _layer(ref, state, c["E"], cf=c["cf"])
            y = layer(ref.to_tensor(X[j]))
            loss = (y * ref.to_tensor(cot[j])).sum() + layer.gate.get_loss()
            loss.backward()
            grads.append({n: p.grad.numpy().astype(np.float64)
                          for n, p in layer.named_parameters()})
        g = {k: np.mean([gj[k] for gj in grads], 0) for k in grads[0]}
        norm = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        scale = c["clip"] / max(norm, c["clip"])
        out[tag] = {"norm": norm, "params": {
            k: state[k] - c["lr"] * scale * v for k, v in g.items()}}
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
    from paddle_tpu.distributed import parallel as jpar
    from paddle_tpu.distributed import topology as jtop

    root = str(tmp_path_factory.mktemp("moe_layer"))
    old = (jpar._DEFAULT_GROUP, jtop.get_hybrid_communicate_group(),
           JFLAGS.get("use_auto_fusion"), dict(jfleet._FLEET_STATE))
    JFLAGS.set("use_auto_fusion", False)
    try:
        refs = C.launch(root, CASES, N_RANKS, {"moe": _ref_moe,
                                                "moe_dp": _ref_moe_dp},
                        timeout=300)
    finally:
        jpar._DEFAULT_GROUP = old[0]
        jtop.set_hybrid_communicate_group(old[1])
        JFLAGS.set("use_auto_fusion", old[2])
        jfleet._FLEET_STATE.clear()
        jfleet._FLEET_STATE.update(old[3])
    return root, refs


@pytest.fixture(scope="module")
def runs(launched):
    root, refs = launched
    return [C.result(root, "moe", r) for r in range(N_RANKS)], refs["moe"]


def _group_rank(rank, W):
    # W 2: the mp axis of dp 2 x mp 2 (rank % 2); W 4: dp 4 (the rank)
    return 0 if W == 1 else (rank % 2 if W == 2 else rank)


# -- tests/test_moe_sp_sep.py's cases, one process --------------------------

def test_moe_layer_trains():
    """4 AdamW steps of the GShard Layer (with its auxiliary loss at
    0.01) from the same weights on both packages: losses and the
    parameters after them."""
    state = C.moe_arrays(3, 16, 32, 4)
    X = np.random.RandomState(4).randn(8, 4, 16).astype(np.float32)
    res = []
    for pkg in (ref, port):
        layer = _layer(pkg, state, 4, d=16, h=32)
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=layer.parameters())
        x = pkg.to_tensor(X)
        losses = []
        for _ in range(4):
            y = layer(x)
            assert y.shape == [8, 4, 16]
            loss = (y - 1.0).pow(2).mean() + layer.gate.get_loss().scale(0.01)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        res.append((losses, {k: v.numpy()
                             for k, v in layer.state_dict().items()}))
    _close(res[1][0], res[0][0], "losses")
    assert res[1][0][-1] < res[1][0][0]
    for k, v in res[0][1].items():
        _close(res[1][1][k], v, k, rtol=1e-4)


def test_moe_capacity_bounds_dispatch():
    """The naive top-1 gate at capacity factor 0.25: 16 tokens, 2
    experts, a capacity of 2; the dropped tokens output 0 in both."""
    rng = np.random.RandomState(1)
    state = {"gate.gate.weight": rng.randn(8, 2).astype(np.float32),
             "gate.gate.bias": np.zeros(2, np.float32)}
    for e in range(2):
        state[f"experts.{e}.weight"] = rng.randn(8, 8).astype(np.float32)
        state[f"experts.{e}.bias"] = rng.randn(8).astype(np.float32)
    X = rng.randn(16, 8).astype(np.float32)
    outs = []
    for pkg in (ref, port):
        from importlib import import_module

        moe = import_module(
            f"{pkg.__name__}.incubate.distributed.models.moe")
        layer = moe.MoELayer(8, [pkg.nn.Linear(8, 8) for _ in range(2)],
                             capacity_factor=0.25,
                             gate={"type": "naive", "top_k": 1})
        for k, v in layer.state_dict().items():
            v.set_value(pkg.to_tensor(state[k]))
        y = layer(pkg.to_tensor(X))
        assert y.shape == [16, 8]
        outs.append(y.numpy())
    _close(outs[1], outs[0], "outputs")
    dropped = (np.abs(outs[1]).sum(-1) == 0).sum()
    assert dropped == 16 - 2 * 2


def test_global_scatter_gather_roundtrip():
    """One rank: the reference's checked identity, and its ValueError."""
    outs = []
    for pkg in (ref, port):
        from importlib import import_module

        utils = import_module(f"{pkg.__name__}.distributed.utils")
        x = pkg.to_tensor(np.arange(12, dtype=np.float32).reshape(6, 2))
        lc = pkg.to_tensor(np.array([2, 1, 3]))
        gc = pkg.to_tensor(np.array([2, 1, 3]))
        s = utils.global_scatter(x, lc, gc)
        g = utils.global_gather(s, lc, gc)
        outs.append((s.numpy(), g.numpy()))
        with pytest.raises(ValueError, match="totals"):
            utils.global_scatter(x, lc, pkg.to_tensor(np.array([2, 1, 2])))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[1][1], np.arange(12).reshape(6, 2))


def test_switch_gate():
    """Eval mode: the reference's top-1 of the softmax. Training: the
    logits scaled by noise in [1 - eps, 1 + eps] from the port's
    generator (the same seed, the same draw; another seed, another)."""
    from paddle_tpu.incubate.distributed.models.moe import SwitchGate as RG
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        SwitchGate as PG

    rng = np.random.RandomState(2)
    w, b = rng.randn(8, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    X = rng.randn(32, 8).astype(np.float32)
    gates = []
    for pkg, cls in ((ref, RG), (port, PG)):
        g = cls(8, 6)
        g.gate.weight.set_value(pkg.to_tensor(w))
        g.gate.bias.set_value(pkg.to_tensor(b))
        g.eval()
        val, idx = g(pkg.to_tensor(X))
        gates.append(g)
        if pkg is ref:
            want = (val.numpy(), idx.numpy())
        else:
            _close(val.numpy(), want[0], "eval values")
            np.testing.assert_array_equal(idx.numpy(), want[1])
    g = gates[1]
    g.train()
    logits = X @ w + b
    draws = []
    for seed in (7, 7, 8):
        port.seed(seed)
        val, idx = g(port.to_tensor(X))
        draws.append((val.numpy(), idx.numpy()))
        # the chosen expert's noisy logit (at most its upper bound) is at
        # least every expert's lower bound under noise in [0.9, 1.1]
        lo, hi = logits * 0.9, logits * 1.1
        noisy_min = np.minimum(lo, hi)
        noisy_max = np.maximum(lo, hi)
        chosen = noisy_max[np.arange(32), idx[:, 0]]
        assert (chosen >= noisy_min.max(-1) - 1e-5).all()
        assert (val > 0).all() and (val <= 1).all()
    np.testing.assert_array_equal(draws[0][0], draws[1][0])
    assert not np.array_equal(draws[0][0], draws[2][0])


# -- moe groups over gloo ranks -----------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 4])
def test_moe_layer_at_group_matches_the_reference(runs, W):
    got, want_all = runs
    want = want_all[f"g{W}/sum"]
    N = MOE["N"]
    for rank, g in enumerate(got):
        r = _group_rank(rank, W)
        rows = slice(r * N, (r + 1) * N)
        tag = f"g{W}/sum"
        _close(g[f"{tag}/y"], want["y"][rows], f"rank {rank} outputs")
        _close(g[f"{tag}/xgrad"], want["xgrad"][rows], f"rank {rank} dx")
        _close(g[f"{tag}/aux"][0], want["aux"], f"rank {rank} aux")
        grads = C.unflat_state(f"{tag}/grad", g)
        assert set(grads) == set(want["grad"])
        for k, v in want["grad"].items():
            _close(grads[k], v, f"rank {rank} grad {k}")
    assert not all(g[f"g{W}/sum/keep"].all() for g in got)  # drops


@pytest.mark.parametrize("W", [2, 4])
def test_mean_loss_scales_gradients_by_the_group_defect_k(runs, W):
    """A mean over each rank's tokens: every gradient is W times the
    reference's mean over the concatenated batch (defect K)."""
    got, want_all = runs
    want = want_all[f"g{W}/mean"]
    N = MOE["N"]
    for rank, g in enumerate(got):
        r = _group_rank(rank, W)
        rows = slice(r * N, (r + 1) * N)
        tag = f"g{W}/mean"
        _close(g[f"{tag}/y"], want["y"][rows], "outputs")
        _close(g[f"{tag}/xgrad"], W * want["xgrad"][rows], "dx")
        grads = C.unflat_state(f"{tag}/grad", g)
        for k, v in want["grad"].items():
            _close(grads[k], W * v, f"grad {k}")


def test_global_scatter_gather_uneven_counts(runs):
    """Rank r's ``local_count[i]`` rows go to expert i % 2 of rank
    i // 2; each rank receives its experts' rows grouped by expert, then
    by source rank; the gather brings them back; the scatter's gradient
    is the gather of its cotangent."""
    got, _ = runs
    sent = []                                  # per rank: rows by target
    for g in got:
        x, lc = g["a2a/x"], g["a2a/lc"]
        starts = np.concatenate([[0], np.cumsum(lc)])
        sent.append([x[starts[i]:starts[i + 1]] for i in range(8)])
    for rank, g in enumerate(got):
        want = np.concatenate(
            [sent[src][rank * 2 + e] for e in range(2) for src in range(4)])
        np.testing.assert_array_equal(g["a2a/s"], want)
        np.testing.assert_array_equal(g["a2a/back"], g["a2a/x"])
        assert sorted(set(g["a2a/lc"])) != [int(g["a2a/lc"][0])]  # uneven
        # d/dx of sum(s * c), c = arange over s: each row of x gets c's
        # row where it landed (the rows are distinct across ranks)
        for i, row in enumerate(g["a2a/x"]):
            where = [(j, k) for j, gd in enumerate(got)
                     for k, vals in enumerate(gd["a2a/s"])
                     if np.array_equal(vals, row)]
            assert len(where) == 1
            k = where[0][1]
            np.testing.assert_array_equal(g["a2a/xgrad"][i],
                                          np.arange(3 * k, 3 * k + 3))


@pytest.mark.parametrize("tag", ["mp", "dp"])
def test_moe_layer_under_dp_steps_like_the_reference(launched, tag):
    """One clipped SGD step through ``fleet.distributed_model`` /
    ``distributed_optimizer``. ``mp``: dp 2 x mp 2, the moe group over
    mp, each dp replica on a batch of its own: the experts and the gate
    averaged over dp. ``dp``: dp 4, the moe group over dp: each rank's
    experts its own and not averaged. On every rank the clip's norm is
    the reference's global norm (the experts' squared norms summed over
    the moe group) and clips, and the state after the step is the
    reference's."""
    root, refs = launched
    want = refs["moe_dp"][tag]
    assert want["norm"] > MOE_DP["clip"]
    got = [C.result(root, "moe_dp", r) for r in range(N_RANKS)]
    for r, g in enumerate(got):
        assert str(g[f"{tag}/kind"]) == ("TensorParallel" if tag == "mp"
                                         else "DataParallel")
        _close(g[f"{tag}/norm"][0], want["norm"], f"rank {r} norm")
        params = C.unflat_state(f"{tag}/params", g)
        assert set(params) == set(want["params"])
        for k, v in want["params"].items():
            _close(params[k], v, f"rank {r} {k}")


def test_held_apart_rule():
    """Which dp syncs skip an expert: a moe group holding every rank of
    the group (apart), one holding only this rank of it (replicated), and
    one holding some but not all (refused); the clip refuses a moe group
    across pipeline stages."""
    from types import SimpleNamespace as NS

    from paddle_tpu_torch.distributed.fleet.hybrid_parallel_optimizer \
        import HybridParallelClipGrad
    from paddle_tpu_torch.distributed.parallel import held_apart

    def expert(ranks):
        return NS(moe_group=NS(ranks=ranks))

    dp = NS(ranks=[0, 2])
    assert held_apart(expert([0, 1, 2, 3]), dp)
    assert held_apart(expert([0, 2]), dp)
    assert not held_apart(expert([0, 1]), dp)
    assert not held_apart(NS(), dp)
    with pytest.raises(ValueError, match="moe group"):
        held_apart(expert([0, 1]), NS(ranks=[0, 1, 2, 3]))
    hcg = NS(get_pipe_parallel_group=lambda: NS(ranks=[0, 2]))
    clip = port.nn.ClipGradByGlobalNorm(1.0)
    HybridParallelClipGrad(clip, hcg, [expert([0, 1])])
    with pytest.raises(ValueError, match="pipeline stages"):
        HybridParallelClipGrad(clip, hcg, [expert([0, 1, 2, 3])])
