"""The fleet's tensor-, sequence- and segment-parallel Layers, recompute
and the RNG tracker in the port against the JAX reference's, over 4
gloo ranks started by the port's launcher (tests/torch_dist_worker.py),
the reference at the same degrees on the fake CPU devices.

Each rank holds its block of a split parameter, the reference the whole
array (on every fake device, as its own tests' fixtures place it); by
the correspondence rule (``paddle_tpu_torch/distributed/collective.py``)
the ranks' blocks of a gradient, concatenated along
the parameter's ``split_axis``, are the reference's gradient, and a
replicated output or gradient equals it on every rank. fp32 within rtol
1e-5, the reference's own bar (an absolute floor of 1e-6 of the
tensor's largest magnitude for sums that cancel):

- the five cases of tests/test_fleet_tp.py at mp 4 (column with
  ``gather_output``, the column / row pair, the vocab-parallel
  embedding, the parallel cross-entropy, with its gradient and an
  ignored row; the tracker by property below), and a row layer that
  splits a whole input and adds its bias once;
- tests/test_moe_sp_sep.py's ``test_sequence_parallel_matches_serial``
  (mp 4) and ``test_segment_parallel_split_concat`` (sep 4, through
  ``fleet.distributed_model``);
- a LayerNorm on the sequence-split activations: its gradients with
  ``register_sequence_parallel_allreduce_hooks`` equal the serial
  LayerNorm's, without it each rank's covers its own tokens (they sum
  to the serial one);
- the RNG tracker at dp 2 x mp 2 by property: ``local_seed`` draws
  differ between mp ranks and agree across dp, ``global_seed`` and the
  default generator agree everywhere, a stream advances and its saved
  state replays;
- both recompute cases of tests/test_subsystems.py (one process), and a
  dropout block whose recomputed mask is the forward's.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as ref
import paddle_tpu.nn as jnn
import paddle_tpu_torch as port
from paddle_tpu.distributed import fleet as jfleet

import torch_dist_common as C
from torch_eager_common import reference_ops_restored  # noqa: F401

port.set_device("cpu")
N = 4
CASES = [dict(name="tp", kind="fleet_tp"), dict(name="rng", kind="rng_tracker"),
         dict(name="sep", kind="sep")]


def _close(a, b, what, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-6 * float(np.abs(b).max()),
                               err_msg=what)


def _leaf(a):
    t = ref.to_tensor(a)
    t.stop_gradient = False
    return t


def _init(**dims):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sep_degree": 1, **dims}
    return jfleet.init(strategy=s)


def _set(layer, spec=None, **arrays):
    from paddle_tpu.distributed.fleet.mp_layers import _shard_param

    for k, v in arrays.items():
        getattr(layer, k).set_value(ref.to_tensor(v))
    if spec:
        for k, s in spec.items():
            _shard_param(getattr(layer, k), s)


def _reference_tp():
    """The reference's side of the tensor- and sequence-parallel cases
    at mp 4."""
    from paddle_tpu.distributed.fleet import sequence_parallel_utils as spu

    # the reference tests' fixture: every fake device, mp at the port's
    # degree (its results do not depend on dp)
    hcg = _init(dp_degree=2, mp_degree=N)
    out = {}
    a = C.tp_arrays(0, {"w": (16, 32), "b": (32,), "x": (8, 16)})
    col = jfleet.ColumnParallelLinear(16, 32, gather_output=True)
    _set(col, {"weight": P(None, "mp"), "bias": P("mp")}, weight=a["w"],
         bias=a["b"])
    x = _leaf(a["x"])
    y = col(x)
    y.sum().backward()
    out.update(col_y=y.numpy(), col_wg=col.weight.grad.numpy(),
               col_bg=col.bias.grad.numpy(), col_xg=x.grad.numpy())
    a = C.tp_arrays(1, {"w1": (16, 32), "w2": (32, 16), "x": (4, 16)})
    c = jfleet.ColumnParallelLinear(16, 32, has_bias=False,
                                    gather_output=False)
    r = jfleet.RowParallelLinear(32, 16, has_bias=False,
                                 input_is_parallel=True)
    _set(c, {"weight": P(None, "mp")}, weight=a["w1"])
    _set(r, {"weight": P("mp", None)}, weight=a["w2"])
    x = _leaf(a["x"])
    y = r(c(x))
    y.sum().backward()
    out.update(pair_y=y.numpy(), pair_w1g=c.weight.grad.numpy(),
               pair_w2g=r.weight.grad.numpy(), pair_xg=x.grad.numpy())
    a = C.tp_arrays(5, {"w": (32, 16), "b": (16,), "x": (4, 32)})
    r = jfleet.RowParallelLinear(32, 16, input_is_parallel=False)
    # the bias replicated over the mesh, as the reference's TensorParallel
    # wrapper places a parameter that is not split
    _set(r, {"weight": P("mp", None), "bias": P()}, weight=a["w"],
         bias=a["b"])
    x = _leaf(a["x"])
    y = r(x)
    (y * y).sum().backward()
    out.update(row_y=y.numpy(), row_wg=r.weight.grad.numpy(),
               row_bg=r.bias.grad.numpy(), row_xg=x.grad.numpy())
    rng = np.random.RandomState(2)
    table = rng.randn(64, 8).astype(np.float32)
    ids = rng.randint(0, 64, size=(4, 6))
    emb = jfleet.VocabParallelEmbedding(64, 8)
    _set(emb, {"weight": P("mp", None)}, weight=table)
    y = emb(ref.to_tensor(ids))
    (y * y).sum().backward()
    out.update(emb_y=y.numpy(), emb_g=emb.weight.grad.numpy())
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 64).astype(np.float32)
    labels = rng.randint(0, 64, size=(4,))
    labels[2] = -100
    t = ref.to_tensor(logits)
    t._bump(jax.device_put(t._data, NamedSharding(hcg.mesh, P(None, "mp"))))
    t.stop_gradient = False
    loss = jfleet.ParallelCrossEntropy()(t, ref.to_tensor(labels))
    (loss * ref.to_tensor(np.arange(1, 5, dtype=np.float32))).sum() \
        .backward()
    out.update(ce_loss=loss.numpy(), ce_g=t.grad.numpy())
    a = C.tp_arrays(0, {"w1": (16, 32), "w2": (32, 16), "x": (8, 2, 16)})
    col = spu.ColumnSequenceParallelLinear(16, 32, has_bias=False)
    row = spu.RowSequenceParallelLinear(32, 16, has_bias=False)
    _set(col, {"weight": P(None, "mp")}, weight=a["w1"])
    _set(row, {"weight": P("mp", None)}, weight=a["w2"])
    x = _leaf(a["x"])
    y = spu.GatherOp.apply(row(col(spu.ScatterOp.apply(x))))
    y.sum().backward()
    out.update(sp_y=y.numpy(), sp_w1g=col.weight.grad.numpy(),
               sp_w2g=row.weight.grad.numpy(), sp_xg=x.grad.numpy())
    a = C.tp_arrays(4, {"x": (8, 2, 16), "gamma": (16,), "beta": (16,),
                        "dy": (8, 2, 16)})
    ln = jnn.LayerNorm(16)
    _set(ln, weight=a["gamma"], bias=a["beta"])
    x = _leaf(a["x"])
    y = ln(x)
    (y * ref.to_tensor(a["dy"])).sum().backward()
    out.update(ln_y=y.numpy(), ln_xg=x.grad.numpy(),
               ln_wg=ln.weight.grad.numpy(), ln_bg=ln.bias.grad.numpy())
    return out


def _reference_sep():
    from paddle_tpu.distributed.fleet.meta_parallel.segment_parallel import (
        SegmentParallel, concat_sequence, split_sequence)

    # tests/test_moe_sp_sep.py's fixture (sep 2 x mp 4 of every fake
    # device); the split and the concat are the same function at any sep
    _init(mp_degree=4, sep_degree=2)
    a = C.tp_arrays(6, {"w": (8, 8), "b": (8,), "x": (2, 8, 8)})
    model = jnn.Linear(8, 8)
    _set(model, weight=a["w"], bias=a["b"])
    wrapped = SegmentParallel(model)
    x = _leaf(a["x"])
    y = concat_sequence(wrapped(split_sequence(x, axis=1)), axis=1)
    (y * y).sum().backward()
    return {"y": y.numpy(), "wg": model.weight.grad.numpy(),
            "bg": model.bias.grad.numpy(), "xg": x.grad.numpy()}


def _references():
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
    from paddle_tpu.distributed import parallel as jpar
    from paddle_tpu.distributed import topology as jtop

    old = (jpar._DEFAULT_GROUP, jtop.get_hybrid_communicate_group(),
           JFLAGS.get("use_auto_fusion"), dict(jfleet._FLEET_STATE))
    JFLAGS.set("use_auto_fusion", False)
    try:
        return {"tp": _reference_tp(), "sep": _reference_sep()}
    finally:
        jpar._DEFAULT_GROUP = old[0]
        jtop.set_hybrid_communicate_group(old[1])
        JFLAGS.set("use_auto_fusion", old[2])
        jfleet._FLEET_STATE.update(old[3])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fleet_layers"))
    holder = {}
    C.launch(root, CASES, N, {"all": lambda: holder.update(_references())})
    return {c["name"]: [C.result(root, c["name"], r) for r in range(N)]
            for c in CASES}, holder


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis)


# (output or gradient, the axis its ranks' blocks concatenate on; None:
# replicated, the reference's on every rank)
TP = {
    "column": [("col_y", None), ("col_wg", 1), ("col_bg", 0),
               ("col_xg", None)],
    "column_row_pair": [("pair_y", None), ("pair_w1g", 1), ("pair_w2g", 0),
                        ("pair_xg", None)],
    "row_split_input_bias_once": [("row_y", None), ("row_wg", 0),
                                  ("row_bg", None), ("row_xg", None)],
    "vocab_parallel_embedding": [("emb_y", None), ("emb_g", 0)],
    "parallel_cross_entropy": [("ce_loss", None), ("ce_g", 1)],
    "sequence_parallel_matches_serial": [("sp_y", None), ("sp_w1g", 1),
                                         ("sp_w2g", 0), ("sp_xg", None)],
}


@pytest.mark.parametrize("case", list(TP))
def test_tensor_parallel_matches_the_reference(runs, case):
    got, want = runs[0]["tp"], runs[1]["tp"]
    for key, axis in TP[case]:
        if axis is None:
            for r, g in enumerate(got):
                _close(g[key], want[key], f"{key} rank {r}")
        else:
            _close(_cat(got, key, axis), want[key], key)


def test_parallel_cross_entropy_ignores_the_row(runs):
    got = runs[0]["tp"]
    for g in got:
        assert g["ce_loss"].shape == (4,) and g["ce_loss"][2] == 0.0
        assert not g["ce_g"][2].any()


def test_sequence_parallel_layernorm_hook(runs):
    got, want = runs[0]["tp"], runs[1]["tp"]
    for r, g in enumerate(got):
        assert g["sp_hooked"].tolist() == [2]
        _close(g["ln_y"], want["ln_y"], f"ln y rank {r}")
        _close(g["ln_xg"], want["ln_xg"], f"ln dx rank {r}")
        _close(g["ln_hook_wg"], want["ln_wg"], f"ln dgamma rank {r}")
        _close(g["ln_hook_bg"], want["ln_bg"], f"ln dbeta rank {r}")
        # without the hook a rank's gradient is its own tokens' part
        assert not np.allclose(g["ln_plain_wg"], want["ln_wg"])
    for k in ("w", "b"):
        _close(sum(g[f"ln_plain_{k}g"] for g in got), want[f"ln_{k}g"],
               f"ln d{k} summed over ranks")


def test_segment_parallel_split_concat(runs):
    got, want = runs[0]["sep"], runs[1]["sep"]
    for r, g in enumerate(got):
        assert str(g["kind"]) == "SegmentParallel"
        for key in ("y", "wg", "bg", "xg"):
            _close(g[key], want[key], f"sep {key} rank {r}")


def test_rng_tracker_streams(runs):
    got = runs[0]["rng"]
    by = {tuple(g["coords"]): g for g in got}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for dp in (0, 1):
        assert not np.array_equal(by[(dp, 0)]["local"], by[(dp, 1)]["local"])
    for mp in (0, 1):
        np.testing.assert_array_equal(by[(0, mp)]["local"],
                                      by[(1, mp)]["local"])
    for g in got:
        for key in ("global", "default"):
            np.testing.assert_array_equal(g[key], got[0][key])
        assert not np.array_equal(g["local"], g["local2"])
        np.testing.assert_array_equal(g["replay"][0], g["replay"][1])
        assert not np.array_equal(g["local"], g["global"])


# -- recompute (one process) ---------------------------------------------------

def _pair_blocks(seed, make):
    ref.seed(seed)
    rb = make(jnn)
    pb = make(port.nn)
    pb.set_state_dict({k: port.to_tensor(np.asarray(v.numpy()))
                       for k, v in rb.state_dict().items()})
    return rb, pb


def test_recompute_matches_plain(reference_ops_restored):  # noqa: F811
    from paddle_tpu.distributed.fleet.recompute import recompute as jrc
    from paddle_tpu_torch.distributed.fleet.recompute import recompute

    rb, pb = _pair_blocks(0, lambda nn: nn.Sequential(
        nn.Linear(8, 32), nn.GELU(), nn.Linear(32, 8)))
    x_np = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    rx = _leaf(x_np)
    y_ref = jrc(rb, rx)
    y_ref.sum().backward()
    for use_reentrant in (True, False):
        px = port.to_tensor(x_np)
        px.stop_gradient = False
        y = recompute(pb, px, use_reentrant=use_reentrant)
        _close(y.numpy(), y_ref.numpy(), "recompute y")
        y.sum().backward()
        for (n, p), q in zip(pb.named_parameters(), rb.parameters()):
            _close(p.grad.numpy(), q.grad.numpy(), f"recompute grad {n}")
        _close(px.grad.numpy(), rx.grad.numpy(), "recompute dx")
        for p in pb.parameters():
            p.clear_gradient()
    # the plain call's gradients are the recomputed ones
    px = port.to_tensor(x_np)
    px.stop_gradient = False
    pb(px).sum().backward()
    for (n, p), q in zip(pb.named_parameters(), rb.parameters()):
        _close(p.grad.numpy(), q.grad.numpy(), f"plain grad {n}")


def test_recompute_sequential(reference_ops_restored):  # noqa: F811
    from paddle_tpu.distributed.fleet.recompute import \
        recompute_sequential as jrs
    from paddle_tpu_torch.distributed.fleet.recompute import \
        recompute_sequential

    rb, pb = _pair_blocks(1, lambda nn: nn.Sequential(
        nn.Linear(8, 8), nn.ReLU(), nn.Linear(8, 8), nn.ReLU()))
    x_np = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    rx = _leaf(x_np)
    jrs({"segments": 2}, rb, rx).sum().backward()
    px = port.to_tensor(x_np)
    px.stop_gradient = False
    y = recompute_sequential({"segments": 2}, pb, px)
    y.sum().backward()
    _close(px.grad.numpy(), rx.grad.numpy(), "dx")
    for (n, p), q in zip(pb.named_parameters(), rb.parameters()):
        assert p.grad is not None
        _close(p.grad.numpy(), q.grad.numpy(), f"grad {n}")


def test_recompute_replays_the_dropout_mask():
    """preserve_rng_state: the replay draws the forward's mask from the
    port's generator, so the gradients are the plain call's."""
    from paddle_tpu_torch.distributed.fleet.recompute import recompute

    port.seed(5)
    blk = port.nn.Sequential(port.nn.Linear(8, 32), port.nn.Dropout(0.5),
                             port.nn.Linear(32, 8))
    x_np = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    grads = []
    for rc in (False, True):
        port.seed(7)
        x = port.to_tensor(x_np)
        x.stop_gradient = False
        y = recompute(blk, x) if rc else blk(x)
        y.sum().backward()
        grads.append([p.grad.numpy().copy() for p in blk.parameters()]
                     + [x.grad.numpy()])
        for p in blk.parameters():
            p.clear_gradient()
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_mp_layers_at_one_rank_under_amp():
    """At mp 1 (one process, no process group) the mp Layers are the
    plain layers: under O1 bf16, on an fp32 activation (a LayerNorm's
    output) and on ids, the column and row layers and the embedding give,
    bitwise, what ``F.linear`` and ``F.embedding`` of the same weights
    give."""
    from paddle_tpu_torch.distributed import fleet as pfleet
    from paddle_tpu_torch.distributed import parallel, topology

    F = port.nn.functional
    old = (topology.get_hybrid_communicate_group(), parallel._DEFAULT_GROUP,
           dict(pfleet._FLEET_STATE))
    try:
        pfleet.init(strategy=pfleet.DistributedStrategy())
        port.seed(0)
        emb = pfleet.VocabParallelEmbedding(64, 16)
        col = pfleet.ColumnParallelLinear(16, 32, gather_output=False)
        row = pfleet.RowParallelLinear(32, 8, input_is_parallel=True)
        rng = np.random.RandomState(0)
        ids = port.to_tensor(rng.randint(0, 64, (2, 5)))
        x = port.to_tensor(rng.randn(2, 5, 16).astype(np.float32))
        with port.amp.auto_cast(level="O1", dtype="bfloat16"):
            got = [row(col(x)), emb(ids)]
            want = F.linear(F.linear(x, col.weight, col.bias), row.weight)
            want = [want + row.bias.astype(want.dtype),
                    F.embedding(ids, emb.weight)]
        for a, b in zip(got, want):
            assert str(a.dtype) == "torch.bfloat16"
            np.testing.assert_array_equal(a.astype("float32").numpy(),
                                          b.astype("float32").numpy())
    finally:
        topology.set_hybrid_communicate_group(old[0])
        parallel._DEFAULT_GROUP = old[1]
        pfleet._FLEET_STATE.clear()
        pfleet._FLEET_STATE.update(old[2])
