"""The fleet's pipeline Layers (``pp_layers.py``, ``pipeline_parallel.py``:
1F1B, interleaved and zero-bubble) and the zero-bubble split backward in
the port against the JAX reference's.

Over 4 gloo ranks started by the port's launcher
(tests/torch_dist_worker.py, rank side tests/torch_pp_moe_cases.py), the
reference at the same degrees on the fake CPU devices. The stage-rank
correspondence rule: each rank builds its stage's layers under the
reference's names, so the reference's state is the union of the ranks'
(``utils/convert.py::pipeline_global_state``), mp-split parameters
gathered along their ``split_axis``. fp32 within rtol 1e-5 (an absolute
floor of 1e-6 of the tensor's largest magnitude):

- ``SegmentLayers``' cuts (uniform, ``layer:<regex>``, lists, virtual
  stages) equal the reference's;
- tests/test_zero_bubble.py's five cases: the ``linear`` and ``matmul``
  splits (dx at once, dW deferred, then flushed), the declines, ZBH1
  through ``distributed_model`` against the reference's (and so serial
  accumulation), the ``static_scheduler`` strings, and each stage's
  executed order equal to them;
- tests/test_gpt_model.py::test_interleaved_pipeline_matches_serial at
  dp 2 x pp 2 (the dp ranks on their halves of the batch);
- 1F1B, ZBH1 and interleaved at pp 4, each against the reference's
  schedule; 1F1B at dp 2 x pp 2 with ``ClipGradByGlobalNorm``: the norm
  the reference's gradients give and the clipped SGD step on them (the
  reference's own clip cannot sum gradients placed on different stage
  submeshes; ROADMAP Queue 3, defect L);
- the mp GPT (tests/torch_mp_gpt.py) as a ``PipelineLayer`` at pp 2 x
  mp 2 (``seg_method="layer:Block"``) through 1F1B, ZBH1 and interleaved
  (V 2) with the clip: losses, the pp clip norm and the parameters after
  2 SGD steps against the reference's serial 4-microbatch accumulation
  from the same weights; 1F1B without the clip against the reference's
  ``PipelineParallel``; a ``SharedLayerDesc`` tied head against the
  reference's serial tied model; ``eval_batch``'s loss;
- the 1F1B stash on stage s at min(pp - s, n) microbatches, the ranks'
  gathered states bitwise equal, and ``distributed_model``'s dispatch.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.distributed import fleet as jfleet

import torch_dist_common as C
import torch_mp_gpt as G

port.set_device("cpu")
N = 4
GPT = dict(vocab_size=256, hidden=64, n_layers=4, n_heads=4, seq_len=16)
GPT_CASE = dict(name="gpt", kind="pp_gpt", cfg=GPT, batch=8, n=4, steps=2,
                lr=0.1, clip=0.5, runs=[
                    dict(tag="1f1b", schedule="1f1b", clip=True),
                    dict(tag="zb", schedule="zb", clip=True),
                    dict(tag="vpp", schedule="vpp", V=2, clip=True),
                    dict(tag="noclip", schedule="1f1b", eval=True),
                    dict(tag="tied", schedule="1f1b", clip=True, tied=True)])
PP4 = dict(name="pp4", kind="pp_linear", dp=1, pp=4, runs=[
    dict(tag="1f1b", schedule="1f1b", n=4, layers=4, rows=8, seed=0),
    dict(tag="zb", schedule="zb", n=4, layers=4, rows=8, seed=0),
    dict(tag="vpp", schedule="vpp", V=2, n=4, layers=8, rows=8, seed=1)])
DP2PP2 = dict(name="dp2pp2", kind="pp_linear", dp=2, pp=2, runs=[
    dict(tag="clip", schedule="1f1b", n=4, layers=4, rows=16, seed=2,
         clip=1.0),
    dict(tag="zb", schedule="zb", n=4, layers=4, rows=8, seed=0),
    dict(tag="vpp", schedule="vpp", V=2, n=2, layers=4, rows=8, seed=0)])
CASES = [PP4, DP2PP2, GPT_CASE]
KINDS = {"1f1b": "PipelineParallel", "zb": "PipelineParallelZeroBubble",
         "vpp": "PipelineParallelWithInterleave"}


def _close(a, b, what, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-6 * float(np.abs(b).max()),
                               err_msg=what)


def _init(pp=1, mp=1, dp=1, n=4, mb=2, zb=False):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sep_degree": 1}
    s.pipeline_configs = {"accumulate_steps": n, "micro_batch_size": mb}
    if zb:
        s.pipeline_configs["schedule_mode"] = "ZBH1"
    return jfleet.init(strategy=s), s


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _ref_linear_run(case, run):
    """The reference's side of one ``pp_linear`` run: its schedule's
    loss and weights, and for a clipped run the global norm of its
    gradients and the clipped SGD step on them (in numpy)."""
    from paddle_tpu.distributed.fleet.meta_parallel import (LayerDesc,
                                                            PipelineLayer)

    V = run.get("V", 1)
    hcg, strat = _init(dp=case["dp"], pp=case["pp"], n=run["n"],
                       zb=run["schedule"] == "zb")
    ws, X, Y = C.linear_stack(run["seed"], run["layers"], run["rows"])
    pipe = PipelineLayer(
        [LayerDesc(ref.nn.Linear, 8, 8, bias_attr=False)
         for _ in range(run["layers"])],
        loss_fn=lambda p, y: ref.nn.functional.cross_entropy(p, y),
        num_virtual_pipeline_stages=V if V > 1 else None)
    for i, w in enumerate(ws):
        pipe._built_by_index[i].weight.set_value(ref.to_tensor(w))
    model = jfleet.distributed_model(pipe)
    data = (ref.to_tensor(X), ref.to_tensor(Y))
    out = {"kind": type(model).__name__}
    if run["schedule"] == "zb":
        out["sched"] = model.static_scheduler()
    if run.get("clip"):
        loss = model.forward_backward_pipeline(data)
        grads = [np.asarray(pipe._built_by_index[i].weight.grad.numpy(),
                            np.float64) for i in range(len(ws))]
        norm = np.sqrt(sum((g ** 2).sum() for g in grads))
        scale = run["clip"] / max(norm, run["clip"])
        out["norm"] = norm
        out["w"] = [w - 0.05 * g * scale for w, g in zip(ws, grads)]
    else:
        opt = ref.optimizer.SGD(learning_rate=0.05,
                                parameters=pipe.parameters())
        loss = model.train_batch(data, opt)
        out["w"] = [np.asarray(pipe._built_by_index[i].weight.numpy())
                    for i in range(len(ws))]
    out["loss"] = float(loss.numpy())
    return out


def _ref_linear(case):
    def run():
        return {r["tag"]: _ref_linear_run(case, r) for r in case["runs"]}

    return run


def _ref_gpt(root):
    """Write the reference's initial states (one-stage names) for the
    ranks, and return the function that runs its sides: serial
    4-microbatch accumulation with the clip, untied and tied, and its
    ``PipelineParallel`` at pp 2 x mp 2 without it."""
    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer

    case = GPT_CASE
    cfg = G.MPGPTConfig(**GPT)
    tok, lab = G.batch(cfg, case["batch"])
    mb = case["batch"] // case["n"]
    layers, inits = {}, {}
    for tied in (False, True):
        _init(mp=2, n=case["n"], mb=mb)
        ref.seed(0)
        descs, loss_fn = G.pipeline(ref, cfg, tied=tied)
        layers[tied] = (PipelineLayer(descs, loss_fn=loss_fn, num_stages=1,
                                      seg_method="layer:Block"), loss_fn)
        inits[tied] = _state(layers[tied][0])
    C.save_inputs(root, "gpt", {**C.flat_state("untied", inits[False]),
                                **C.flat_state("tied", inits[True])})

    def serial(tied):
        _init(mp=2, n=case["n"], mb=mb)
        pipe, loss_fn = layers[tied]
        opt = ref.optimizer.SGD(learning_rate=case["lr"],
                                parameters=pipe.parameters(),
                                grad_clip=ref.nn.ClipGradByGlobalNorm(
                                    case["clip"]))
        losses, norms = [], []
        for _ in range(case["steps"]):
            tot = 0.0
            for k in range(case["n"]):
                rows = slice(k * mb, (k + 1) * mb)
                loss = loss_fn(pipe(ref.to_tensor(tok[rows])),
                               ref.to_tensor(lab[rows]))
                loss.scale(1.0 / case["n"]).backward()
                tot += float(loss.numpy())
            norms.append(float(np.sqrt(sum(
                float((np.asarray(p.grad.numpy(), np.float64) ** 2).sum())
                for p in pipe.parameters()))))
            opt.step()
            opt.clear_grad()
            losses.append(tot / case["n"])
        return {"losses": losses, "norms": norms, "params": _state(pipe)}

    def pipelined():
        hcg, _ = _init(pp=2, mp=2, n=case["n"], mb=mb)
        ref.seed(0)
        descs, loss_fn = G.pipeline(ref, cfg)
        pipe = PipelineLayer(descs, loss_fn=loss_fn, seg_method="layer:Block")
        two = C.stage_names(pipe.segment_parts, 2)
        one = C.stage_names([0, len(descs)], 1)
        assert {k: v.tobytes() for k, v in C.rename_stages(
            _state(pipe), two, one).items()} == \
            {k: v.tobytes() for k, v in inits[False].items()}
        model = jfleet.distributed_model(pipe)
        opt = jfleet.distributed_optimizer(ref.optimizer.SGD(
            learning_rate=case["lr"], parameters=pipe.parameters()))
        data = (ref.to_tensor(tok), ref.to_tensor(lab))
        losses = [float(model.train_batch(data, opt).numpy())
                  for _ in range(case["steps"])]
        return {"losses": losses,
                "params": C.rename_stages(_state(pipe), two, one)}

    def run():
        return {"serial": serial(False), "tied": serial(True),
                "pipelined": pipelined(), "init": inits[False]}

    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
    from paddle_tpu.distributed import parallel as jpar
    from paddle_tpu.distributed import topology as jtop

    root = str(tmp_path_factory.mktemp("pipeline_layers"))
    old = (jpar._DEFAULT_GROUP, jtop.get_hybrid_communicate_group(),
           JFLAGS.get("use_auto_fusion"), dict(jfleet._FLEET_STATE))
    JFLAGS.set("use_auto_fusion", False)
    try:
        gpt = _ref_gpt(root)
        refs = C.launch(root, CASES, N, {
            "gpt": gpt, "pp4": _ref_linear(PP4),
            "dp2pp2": _ref_linear(DP2PP2)}, timeout=400)
    finally:
        jpar._DEFAULT_GROUP = old[0]
        jtop.set_hybrid_communicate_group(old[1])
        JFLAGS.set("use_auto_fusion", old[2])
        jfleet._FLEET_STATE.clear()
        jfleet._FLEET_STATE.update(old[3])
    got = {c["name"]: [C.result(root, c["name"], r) for r in range(N)]
           for c in CASES}
    return got, refs


def _stage(rank, dp, pp, mp=1):
    # the hybrid mesh's rank order: dp, pp, sharding, sep, mp
    return (rank // mp) % pp


# -- SegmentLayers ---------------------------------------------------------

SEG_CASES = [
    ("uniform", ["Embed"] + ["Block"] * 5 + ["Head"], 2, None),
    ("uniform", ["Block"] * 10, 4, None),
    ("uniform", ["Block"] * 9, 2, 2),
    ("layer:Block", ["Embed"] + ["Block"] * 4 + ["LnF", "Head"], 2, None),
    ("layer:Block", ["Embed"] + ["Block"] * 8 + ["Head"], 2, 2),
    ("layer:Block", ["Embed"] + ["Block"] * 6 + ["Head"], 4, None),
    ("layer:Bl.ck", ["Embed", "Block", "Other", "Block", "Head"], 2, None),
    ([0, 3, 7], ["Block"] * 7, 2, None),
    ([2, 5], ["Block"] * 7, 3, None),
]


@pytest.mark.parametrize("method,names,parts,V", SEG_CASES)
def test_segment_layers_cuts(method, names, parts, V):
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
        SegmentLayers as RSeg
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers import \
        SegmentLayers as PSeg

    def descs(pkg, mp):
        classes = {n: type(n, (pkg.nn.Layer,), {}) for n in set(names)}
        return [mp.LayerDesc(classes[n]) for n in names]

    from paddle_tpu.distributed.fleet import meta_parallel as rmp
    from paddle_tpu_torch.distributed.fleet import meta_parallel as pmp

    want = RSeg(descs(ref, rmp), parts, method=method,
                num_virtual_pipeline_stage=V).do_segment()
    got = PSeg(descs(port, pmp), parts, method=method,
               num_virtual_pipeline_stage=V).do_segment()
    assert got == want


def test_pipeline_layer_builds_its_stage_alone():
    """Stage metadata on a one-process topology of pp 2 (stage 0): the
    segments, their owners and stage 0's sublayer names."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)

    old = topology.get_hybrid_communicate_group()
    try:
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            topology.CommunicateTopology(dims=(1, 2, 1, 1, 1))))
        pipe = PipelineLayer([LayerDesc(port.nn.Linear, 4, 4)
                              for _ in range(6)],
                             num_virtual_pipeline_stages=2)
        assert pipe.segment_parts == [0, 2, 4, 5, 6]
        assert [pipe.segment_stage(g) for g in range(4)] == [0, 1, 0, 1]
        assert pipe.own_segments() == [0, 2]
        assert [pipe.get_stage_from_index(i) for i in range(6)] == \
            [0, 0, 1, 1, 0, 1]
        assert sorted({k.split(".")[0] for k in pipe.state_dict()}) == \
            ["stage0_0", "stage0_1", "stage0_2"]
        with pytest.raises(ValueError, match="stage 1"):
            pipe.forward_segment(port.ones([1, 4]), 1)
        with pytest.raises(RuntimeError, match="train_batch"):
            pipe(port.ones([1, 4]))
    finally:
        topology.set_hybrid_communicate_group(old)


# -- the zero-bubble split (tests/test_zero_bubble.py) -----------------------

def _leaf(pkg, a):
    t = pkg.to_tensor(a)
    t.stop_gradient = False
    return t


def _split_case(pkg, store, build):
    """(grads after the split backward, the store's size then, grads
    after the flush) of ``build``'s leaves."""
    store.enable()
    try:
        leaves, out = build(pkg)
        out.sum().backward()
    finally:
        store.disable()
    mid = [None if t.grad is None else np.asarray(t.grad.numpy())
           for t in leaves]
    size = store.size()
    store.flush()
    return mid, size, [np.asarray(t.grad.numpy()) for t in leaves]


def _linear(pkg):
    rng = np.random.RandomState(0)
    x, w, b = (_leaf(pkg, rng.randn(*s).astype(np.float32))
               for s in ((4, 6), (6, 3), (3,)))
    return [x, w, b], pkg.nn.functional.linear(x, w, b)


def _matmul_ty(pkg):
    rng = np.random.RandomState(1)
    x, y = (_leaf(pkg, rng.randn(*s).astype(np.float32))
            for s in ((5, 4), (3, 4)))
    return [x, y], pkg.matmul(x, y, transpose_y=True)


def _matmul_tx(pkg):
    rng = np.random.RandomState(3)
    x, y = (_leaf(pkg, rng.randn(*s).astype(np.float32))
            for s in ((2, 4, 5), (4, 3)))
    return [x, y], pkg.matmul(x, y, transpose_x=True)


@pytest.mark.parametrize("build,deferred", [(_linear, [1, 2]),
                                            (_matmul_ty, [1]),
                                            (_matmul_tx, [1])])
def test_weight_grad_store_split(build, deferred):
    """dx at once, the parameters' gradients deferred to one thunk and
    equal to the reference's after the flush."""
    from paddle_tpu.core.autograd import WeightGradStore as RStore
    from paddle_tpu_torch.core.autograd import WeightGradStore as PStore

    r_mid, r_size, r_end = _split_case(ref, RStore, build)
    p_mid, p_size, p_end = _split_case(port, PStore, build)
    assert p_size == r_size == 1 and PStore.size() == 0
    for i, (a, b) in enumerate(zip(p_mid, r_mid)):
        assert (a is None) == (b is None) == (i in deferred), i
        if a is not None:
            _close(a, b, f"dx {i}")
    for i, (a, b) in enumerate(zip(p_end, r_end)):
        _close(a, b, f"flushed {i}")
    # without the split: torch's native backward, the same values
    leaves, out = build(port)
    out.sum().backward()
    for t, b in zip(leaves, r_end):
        _close(t.grad.numpy(), b, "native")


def test_split_declines_non_weight_patterns():
    """A product of two activations defers nothing, in either package."""
    from paddle_tpu.core.autograd import WeightGradStore as RStore
    from paddle_tpu_torch.core.autograd import WeightGradStore as PStore

    rng = np.random.RandomState(2)
    av, bv = rng.randn(3, 3).astype(np.float32), \
        rng.randn(3, 3).astype(np.float32)
    grads = []
    for pkg, store in ((ref, RStore), (port, PStore)):
        a, b = _leaf(pkg, av), _leaf(pkg, bv)
        h = a + 0.0
        store.enable()
        try:
            pkg.matmul(h, b.reshape([3, 3]) + 0.0).sum().backward()
        finally:
            store.disable()
        assert store.size() == 0
        grads.append([a.grad.numpy(), b.grad.numpy()])
    for x, y in zip(*grads):
        _close(x, y, "declined")


def _linear_w3(pkg):
    rng = np.random.RandomState(4)
    x, w = (_leaf(pkg, rng.randn(*s).astype(np.float32))
            for s in ((4, 6), (2, 6, 3)))
    return [x, w], pkg.nn.functional.linear(x, w)


def _linear_wide_bias(pkg):
    rng = np.random.RandomState(5)
    x, w, b = (_leaf(pkg, rng.randn(*s).astype(np.float32))
               for s in ((4, 6), (6, 3), (4, 3)))
    return [x, w, b], pkg.nn.functional.linear(x, w, b)


def _matmul_vec(pkg):
    rng = np.random.RandomState(6)
    x, y = (_leaf(pkg, rng.randn(*s).astype(np.float32))
            for s in ((6,), (6, 3)))
    return [x, y], pkg.matmul(x, y)


@pytest.mark.parametrize("build", [_linear_w3, _linear_wide_bias,
                                   _matmul_vec])
def test_split_declines_at_forward_time(build):
    """Leaf parameters in a pattern the rules do not split (a 3-D weight,
    a bias of another shape than the output's width, a 1-D activation):
    with the store on, the port records torch's own backward node, and
    neither package defers anything; the gradients are the reference's."""
    from paddle_tpu.core.autograd import WeightGradStore as RStore
    from paddle_tpu_torch.core.autograd import WeightGradStore as PStore

    grads = []
    for pkg, store in ((ref, RStore), (port, PStore)):
        store.enable()
        try:
            leaves, out = build(pkg)
            if pkg is port:
                assert "Split" not in type(out._data.grad_fn).__name__
            out.sum().backward()
        finally:
            store.disable()
        assert store.size() == 0
        grads.append([t.grad.numpy() for t in leaves])
    for i, (a, b) in enumerate(zip(*grads)):
        _close(b, a, f"declined {i}")


def test_split_scope_keeps_native_backward_outside():
    """With the store off ``linear`` records torch's own backward node;
    recorded with the store on (the zero-bubble forwards) and
    differentiated with it off, the split node gives the same gradients
    at once; a hook on the weight fires on the flushed one."""
    from paddle_tpu_torch.core.autograd import WeightGradStore

    leaves, out = _linear(port)
    assert "Split" not in type(out._data.grad_fn).__name__
    WeightGradStore.enable()
    try:
        leaves2, out2 = _linear(port)
    finally:
        WeightGradStore.disable()
    assert "Split" in type(out2._data.grad_fn).__name__
    out.sum().backward()
    out2.sum().backward()
    for a, b in zip(leaves, leaves2):
        assert np.array_equal(a.grad.numpy(), b.grad.numpy())
    seen = []
    WeightGradStore.enable()
    leaves3, out3 = _linear(port)
    leaves3[1].register_hook(lambda g: seen.append(g.shape))
    out3.sum().backward()
    WeightGradStore.disable()
    assert seen == []
    WeightGradStore.flush()
    assert seen == [[6, 3]]


def test_store_serves_backwards_on_other_threads():
    """torch runs a CUDA backward on its engine's device thread: the
    store's switch and queue are the process's, not the enabling
    thread's (a backward run from another thread here)."""
    import threading

    from paddle_tpu_torch.core.autograd import WeightGradStore

    WeightGradStore.enable()
    try:
        leaves, out = _linear(port)
        t = threading.Thread(target=lambda: out.sum().backward())
        t.start()
        t.join()
    finally:
        WeightGradStore.disable()
    assert leaves[1].grad is None and WeightGradStore.size() == 1
    WeightGradStore.flush()
    assert leaves[1].grad is not None and leaves[2].grad is not None


# -- the schedules over gloo ranks --------------------------------------------

@pytest.mark.parametrize("tag", ["1f1b", "zb", "vpp"])
def test_pp4_schedules_match_the_reference(runs, tag):
    got, refs = runs
    want = refs["pp4"][tag]
    for r, g in enumerate(got["pp4"]):
        assert str(g[f"{tag}/kind"]) == KINDS[tag] == want["kind"]
        _close(g[f"{tag}/losses"][0], want["loss"], f"rank {r} loss")
        stage = _stage(r, 1, 4)
        layers = PP4["runs"][["1f1b", "zb", "vpp"].index(tag)]["layers"]
        owned = [i for i in range(layers) if (i % 4 if tag == "vpp"
                                              else i * 4 // layers) == stage]
        for i in owned:
            _close(g[f"{tag}/w{i}"], want["w"][i], f"rank {r} w{i}")
        if tag != "vpp":
            assert g[f"{tag}/stash"][0] == min(4 - stage, 4)
        if tag == "zb":
            assert str(g["zb/log"]) == want["sched"][stage]
            assert g["zb/deferred"][0] == 4        # a thunk a microbatch


@pytest.mark.parametrize("tag", ["clip", "zb", "vpp"])
def test_dp2_pp2_matches_the_reference(runs, tag):
    """dp 2 x pp 2: the mean of the dp ranks' losses and the dp-synced
    weights are the reference's on the whole batch; 1F1B's clip norm is
    the reference gradients' global norm."""
    got, refs = runs
    want = refs["dp2pp2"][tag]
    ranks = got["dp2pp2"]
    for s in range(2):
        pair = [ranks[s], ranks[2 + s]]          # dp 0 and 1 of stage s
        _close((pair[0][f"{tag}/losses"][0] + pair[1][f"{tag}/losses"][0])
               / 2, want["loss"], f"stage {s} loss")
        for g in pair:
            for k in g:
                if k.startswith(f"{tag}/w"):
                    _close(g[k], want["w"][int(k.rsplit("w", 1)[1])], k)
            if tag == "clip":
                _close(g["clip/norm"][0], want["norm"], "clip norm")
            if tag == "zb":
                assert str(g["zb/log"]) == want["sched"][s]
    assert want["norm"] > DP2PP2["runs"][0]["clip"] if tag == "clip" \
        else True


def _gpt_params(ranks, tag):
    params = C.unflat_state(f"{tag}/params", ranks[0])
    for g in ranks[1:]:
        other = C.unflat_state(f"{tag}/params", g)
        assert {k: v.tobytes() for k, v in other.items()} == \
            {k: v.tobytes() for k, v in params.items()}, tag
    return params


@pytest.mark.parametrize("tag", ["1f1b", "zb", "vpp", "tied"])
def test_gpt_pp2_mp2_against_serial_accumulation(runs, tag):
    got, refs = runs
    ranks = got["gpt"]
    want = refs["gpt"]["tied" if tag == "tied" else "serial"]
    for r, g in enumerate(ranks):
        kind = KINDS["1f1b" if tag == "tied" else tag]
        assert str(g[f"{tag}/kind"]) == kind
        _close(g[f"{tag}/losses"], want["losses"], f"rank {r} losses")
        _close(g[f"{tag}/norms"], want["norms"], f"rank {r} norms")
        if tag in ("1f1b", "zb", "tied"):
            stage = _stage(r, 1, 2, mp=2)
            assert g[f"{tag}/stash"][0] == min(2 - stage, GPT_CASE["n"])
    assert want["norms"][0] > GPT_CASE["clip"]           # the clip acts
    params = _gpt_params(ranks, tag)
    assert set(params) == set(want["params"])
    for k, w in want["params"].items():
        _close(params[k], w, f"{tag} {k}")


def test_gpt_pp2_mp2_against_the_reference_pipeline(runs):
    """1F1B without the clip against the reference's PipelineParallel at
    pp 2 x mp 2; ``eval_batch`` before it against the first loss."""
    got, refs = runs
    want = refs["gpt"]["pipelined"]
    for g in got["gpt"]:
        _close(g["noclip/losses"], want["losses"], "losses")
        _close(g["noclip/eval"][0], refs["gpt"]["serial"]["losses"][0],
               "eval")
        sends, recvs = g["noclip/p2p"]
        assert sends > 0 and recvs > 0
    params = _gpt_params(got["gpt"], "noclip")
    for k, w in want["params"].items():
        _close(params[k], w, f"noclip {k}")


def test_zero_bubble_order_on_the_gpt(runs):
    got, _ = runs
    from paddle_tpu.distributed.fleet.meta_parallel import \
        PipelineParallelZeroBubble

    # the reference's strings (its method reads these two attributes)
    want = PipelineParallelZeroBubble.static_scheduler(
        type("S", (), {"accumulate_steps": GPT_CASE["n"],
                       "num_stages": 2})())
    for r, g in enumerate(got["gpt"]):
        assert str(g["zb/log"]) == want[_stage(r, 1, 2, mp=2)]
        # linear layers a stage: qkv, proj, fc1, fc2 of 2 blocks, and on
        # the last stage the head (the embeddings are not linear)
        per_mb = 8 + (1 if _stage(r, 1, 2, mp=2) == 1 else 0)
        assert g["zb/deferred"][0] == per_mb * GPT_CASE["n"]
