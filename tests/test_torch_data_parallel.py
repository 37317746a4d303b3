"""``DataParallel``, the fleet's model and optimizer wrappers and the
hybrid optimizer in the port against the JAX reference's, over 4 gloo
ranks started by the port's launcher (tests/torch_dist_worker.py) at dp
2 x mp 2, the reference on the fake CPU devices with its compiler off.

- ``BertForPretraining`` (tests/test_torch_bert.py's small config: vocab
  128, hidden 128, 2 layers, S 128; 20 MLM labels a sequence, as
  pretraining data fixes the count) under ``DataParallel`` at dp 2, B 2
  a step, 3 AdamW steps, against the reference's ``DataParallel`` on
  the same global batch: the mean of the dp ranks' losses within rtol
  1e-5 (for a mean loss over equal per-rank counts, Paddle's average of
  the ranks' gradients is the gradient of the global loss, which is the
  reference's), the parameters after 3 steps within atol 1e-5 (the key
  biases, whose gradient is rounding noise, within 2 lr a step of their
  start, as tests/test_torch_bert.py holds them), the ranks bitwise
  equal; the bytes all-reduced a step exactly the gradients' bytes; with
  buckets of 0.05 MB (many buckets) bitwise the default run.
- ``no_sync``: a micro-batch accumulated locally, the next synced: the
  reference's gradient of both global micro-batches.
- ``find_unused_parameters``: a layer no backward reaches is refused
  without it and synced as zeros with it (the others the reference's);
  a branch one dp rank alone takes gets the average over the ranks.
- The sum-reduced loss: the reference's gradient is dp times the port's
  (Paddle's) average: reference defect J (ROADMAP Queue 3).
- AMP: an inf in one rank's ``no_sync`` gradient reaches every rank
  through the synced backward: both skip the step and halve the scale;
  the next step is taken on both, the ranks' weights bitwise equal.
- A GPT of the fleet's mp Layers (tests/torch_mp_gpt.py) at dp 2 x mp 2
  through ``fleet.distributed_model`` (``TensorParallel``) and
  ``fleet.distributed_optimizer`` with ``ClipGradByGlobalNorm`` (a norm
  that clips): 3 AdamW steps; losses and the clip's global norm within
  rtol 1e-5, the gathered parameters within atol 1e-5 of the
  reference's (an element whose first gradient is rounding noise, ~1e-9
  where the leaf's run to ~1e-2, within 2 lr a step of its start on both
  sides: AdamW's first step moves it by lr with the noise's sign), the
  ranks' bitwise equal.
- ``distributed_model`` dispatches pipeline mode (zero-bubble,
  interleaved, 1F1B) as the reference's does.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import bert as jb

import torch_dist_common as C
import torch_mp_gpt as G

port.set_device("cpu")
N = 4
BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
BERT_BATCH = dict(vocab=128, B=2, S=128, masked=20)
STEPS = 3
GPT = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, seq_len=16)
CASES = [
    dict(name="bert", kind="bert_dp", cfg=BERT, batch=BERT_BATCH,
         steps=STEPS, small_mb=0.05),
    dict(name="small", kind="dp_small"),
    dict(name="gpt", kind="mp_gpt", cfg=GPT, batch=4, steps=STEPS, lr=1e-4,
         clip=0.5),
]


def _init(**dims):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sep_degree": 1, **dims}
    return jfleet.init(strategy=s)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _bert_reference(root):
    """Build the reference's BERT, write its state for the ranks, and
    return the function that trains it under the reference's
    DataParallel (dp 2)."""
    import paddle_tpu.distributed as jdist

    ref.seed(0)
    model = jb.BertForPretraining(jb.BertConfig(**BERT))
    init = _state(model)
    C.save_inputs(root, "bert", C.flat_state("params", init))

    def run():
        jdist.init_parallel_env({"dp": 2})
        dp = jdist.DataParallel(model)
        crit = jb.BertPretrainingCriterion(BERT["vocab_size"])
        opt = ref.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=dp.parameters())
        ids, tt, mlm, nsp = (ref.to_tensor(a)
                             for a in C.bert_batch(**BERT_BATCH))
        losses = []
        for _ in range(STEPS):
            loss = crit(*dp(dp.scale_batch(ids), dp.scale_batch(tt)), mlm,
                        nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        return {"losses": np.asarray(losses), "params": _state(model),
                "init": init}

    return run


def _mlp():
    ref_nn = ref.nn
    a = C.tp_arrays(8, {"w1": (8, 16), "b1": (16,), "w2": (16, 4),
                        "b2": (4,)})
    net = ref_nn.Sequential(ref_nn.Linear(8, 16), ref_nn.GELU(),
                            ref_nn.Linear(16, 4))
    for layer, w, b in ((net[0], "w1", "b1"), (net[2], "w2", "b2")):
        layer.weight.set_value(ref.to_tensor(a[w]))
        layer.bias.set_value(ref.to_tensor(a[b]))
    return net


def _small_reference():
    """The reference's gradients for the DataParallel cases: the global
    batch's (its DataParallel is the plain model on one controller)."""
    xs = C.tp_arrays(7, {"x0": (4, 8), "x1": (4, 8)})
    out = {}
    net = _mlp()
    for k in ("x0", "x1"):
        (net(ref.to_tensor(xs[k])) ** 2).mean().backward()
    out["nosync"] = [p.grad.numpy() for p in net.parameters()]
    net = _mlp()
    (net(ref.to_tensor(xs["x0"])) ** 2).mean().backward()
    out["unused"] = [p.grad.numpy() for p in net.parameters()]
    lin = ref.nn.Linear(8, 4)
    a = C.tp_arrays(9, {"w": (8, 4), "b": (4,)})
    lin.weight.set_value(ref.to_tensor(a["w"]))
    lin.bias.set_value(ref.to_tensor(a["b"]))
    (lin(ref.to_tensor(xs["x0"])) ** 2).sum().backward()
    out["sum"] = [lin.weight.grad.numpy(), lin.bias.grad.numpy()]
    return out


def _gpt_reference(root):
    case = CASES[2]
    cfg = G.MPGPTConfig(**GPT)
    hcg_dims = dict(dp_degree=2, mp_degree=2)
    _init(**hcg_dims)
    ref.seed(0)
    rm = G.build(ref, cfg)
    init = _state(rm)
    C.save_inputs(root, "gpt", C.flat_state("params", init))

    def run():
        _init(**hcg_dims)
        model = jfleet.distributed_model(rm)
        opt = jfleet.distributed_optimizer(ref.optimizer.AdamW(
            learning_rate=case["lr"], parameters=model.parameters(),
            grad_clip=ref.nn.ClipGradByGlobalNorm(case["clip"])))
        tok, lab = (ref.to_tensor(a) for a in G.batch(cfg, case["batch"]))
        losses, norms, grad0 = [], [], None
        for _ in range(STEPS):
            loss = rm.loss(tok, lab)
            loss.backward()
            if grad0 is None:
                grad0 = {n: p.grad.numpy() for n, p in rm.named_parameters()}
            norms.append(float(np.sqrt(sum(
                float((p.grad.numpy().astype(np.float64) ** 2).sum())
                for p in rm.parameters()))))
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        return {"losses": np.asarray(losses), "norms": np.asarray(norms),
                "params": _state(rm), "init": init, "grad0": grad0}

    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
    from paddle_tpu.distributed import parallel as jpar
    from paddle_tpu.distributed import topology as jtop

    root = str(tmp_path_factory.mktemp("data_parallel"))
    old = (jpar._DEFAULT_GROUP, jtop.get_hybrid_communicate_group(),
           JFLAGS.get("use_auto_fusion"), dict(jfleet._FLEET_STATE))
    JFLAGS.set("use_auto_fusion", False)
    try:
        bert, gpt = _bert_reference(root), _gpt_reference(root)
        refs = C.launch(root, CASES, N, {"bert": bert, "gpt": gpt,
                                         "small": _small_reference},
                        timeout=400)
    finally:
        jpar._DEFAULT_GROUP = old[0]
        jtop.set_hybrid_communicate_group(old[1])
        JFLAGS.set("use_auto_fusion", old[2])
        jfleet._FLEET_STATE.update(old[3])
    got = {c["name"]: [C.result(root, c["name"], r) for r in range(N)]
           for c in CASES}
    return got, refs


def _bitwise_across_ranks(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert r[k].tobytes() == ranks[0][k].tobytes(), k


def _dp_mean(ranks, key):
    # ranks 0 and 1 are dp rank 0 (mp 0, 1), ranks 2 and 3 dp rank 1
    return (ranks[0][key] + ranks[2][key]) / 2


def test_bert_under_data_parallel(runs):
    got, refs = runs
    ranks, want = got["bert"], refs["bert"]
    _bitwise_across_ranks(ranks, "params/")
    np.testing.assert_allclose(_dp_mean(ranks, "losses"), want["losses"],
                               rtol=1e-5)
    assert want["losses"][-1] < want["losses"][0]
    params = C.unflat_state("params", ranks[0])
    assert set(params) == set(want["params"])
    for k, w in want["params"].items():
        if k.endswith("k_proj.bias"):
            # 0 in exact arithmetic: AdamW moves it by ~lr a step on
            # rounding noise in either package
            for side in (params[k], w):
                assert np.abs(side - want["init"][k]).max() <= \
                    2e-4 * STEPS, k
        else:
            np.testing.assert_allclose(params[k], w, rtol=0, atol=1e-5,
                                       err_msg=k)


def test_bert_buckets_and_bytes(runs):
    ranks = runs[0]["bert"]
    for g in ranks:
        buckets, steps, calls, nbytes, grad_bytes = g["stats"].tolist()
        assert buckets == 1 and steps == STEPS and calls == STEPS
        assert nbytes == STEPS * grad_bytes
        sb, ss, sc, sn, sg = g["small_stats"].tolist()
        assert sb > 10 and ss == STEPS and sc == STEPS * sb
        assert sn == STEPS * sg == STEPS * grad_bytes
        np.testing.assert_array_equal(g["small_losses"], g["losses"])
    _bitwise_across_ranks(ranks, "small_params/")
    for k in C.unflat_state("params", ranks[0]):
        assert ranks[0][f"small_params/{k}"].tobytes() == \
            ranks[0][f"params/{k}"].tobytes(), k


def test_no_sync_accumulates_then_syncs(runs):
    ranks, want = runs[0]["small"], runs[1]["small"]
    for g in ranks:
        assert g["nosync_steps"].tolist() == [1]
        for i, w in enumerate(want["nosync"]):
            np.testing.assert_allclose(g[f"nosync_g{i}"], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
    # inside no_sync the gradient was this rank's alone
    assert not np.array_equal(ranks[0]["nosync_local"],
                              ranks[2]["nosync_local"])


def test_find_unused_parameters(runs):
    ranks, want = runs[0]["small"], runs[1]["small"]
    for g in ranks:
        assert g["unused_refused"].tolist() == [1]
        for i, w in enumerate(want["unused"]):
            np.testing.assert_allclose(g[f"unused_g{i}"], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
        for i in (4, 5):                  # the unused layer: zeros
            assert not g[f"unused_g{i}"].any()


def test_a_branch_one_rank_takes(runs):
    """dp rank 1 alone runs ``extra``: every rank holds the average of
    the ranks' gradients, which one process computes here as the
    gradient of the mean of the two ranks' losses."""
    ranks = runs[0]["small"]
    import torch_dist_worker as W

    xs = C.tp_arrays(7, {"x0": (4, 8), "x1": (4, 8)})
    net, _ = W._mlp(8)
    extra = port.nn.Linear(4, 4)
    extra.set_state_dict({"weight": port.to_tensor(np.eye(4, dtype=np.float32)),
                          "bias": port.to_tensor(np.ones(4, np.float32))})
    x = xs["x0"]
    y0 = net(port.to_tensor(x[:2]))
    y1 = extra(net(port.to_tensor(x[2:])))
    ((y0 ** 2).mean() / 2 + (y1 ** 2).mean() / 2).backward()
    want = [p.grad.numpy() for p in net.parameters()] + \
        [p.grad.numpy() for p in extra.parameters()]
    for g in ranks:
        for i, w in enumerate(want):
            np.testing.assert_allclose(g[f"branch_g{i}"], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


def test_sum_loss_defect_j(runs):
    """For a sum-reduced loss the reference's gradient is that of the sum
    over the global batch: dp times the average Paddle's DataParallel
    (and the port) takes. Recorded as reference defect J."""
    ranks, want = runs[0]["small"], runs[1]["small"]
    for g in ranks:
        for key, w in zip(("sum_wg", "sum_bg"), want["sum"]):
            np.testing.assert_allclose(2 * g[key], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
            assert not np.allclose(g[key], w)


def test_amp_found_inf_agrees(runs):
    ranks = runs[0]["small"]
    for g in ranks:
        found, scale, unchanged = g["amp_skip"].tolist()
        assert found == 1.0 and scale == 2.0 ** 9 and unchanged == 1.0
        assert g["amp_take"].tolist() == [0.0, 2.0 ** 9]
    _bitwise_across_ranks(ranks, "amp_w")


def test_mp_gpt_at_dp2_mp2(runs):
    got, refs = runs
    ranks, want = got["gpt"], refs["gpt"]
    for g in ranks:
        assert str(g["kind"]) == "TensorParallel"
    _bitwise_across_ranks(ranks, "params/")
    np.testing.assert_allclose(_dp_mean(ranks, "losses"), want["losses"],
                               rtol=1e-5)
    for g in ranks:
        np.testing.assert_allclose(g["norms"], want["norms"], rtol=1e-5)
    assert want["norms"][0] > CASES[2]["clip"]     # the clip acts
    params = C.unflat_state("params", ranks[0])
    assert set(params) == set(want["params"])
    lr = CASES[2]["lr"]
    for k, w in want["params"].items():
        # an element whose first gradient is rounding noise (an exact 0
        # that cancels to ~1e-9 against ~3e-3 a typical element of the
        # leaf): AdamW's first step moves it by lr with the noise's sign
        # in either package; each side within 2 lr a step of its start
        g0 = np.abs(want["grad0"][k])
        noise = g0 <= 1e-5 * g0.max()
        for side in (params[k][noise], w[noise]):
            assert np.abs(side - want["init"][k][noise]).max(
                initial=0.0) <= 2 * lr * STEPS, k
        np.testing.assert_allclose(params[k][~noise], w[~noise], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_distributed_model_dispatches_pipeline_mode():
    """Pipeline mode (the reference's fleet/__init__.py:135-148): a
    ``ZB*`` schedule_mode gives the zero-bubble wrapper, virtual stages
    the interleaved one, anything else ``PipelineParallel``; a
    zero-bubble schedule_mode outside pipeline mode is not read."""
    from paddle_tpu_torch.distributed import fleet, topology
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp

    old = topology.get_hybrid_communicate_group()
    try:
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            topology.CommunicateTopology(dims=(1, 2, 1, 1, 1))))
        for mode, V, want in (("", 1, mp.PipelineParallel),
                              ("1F1B", 1, mp.PipelineParallel),
                              ("", 2, mp.PipelineParallelWithInterleave),
                              ("ZBH1", 1, mp.PipelineParallelZeroBubble)):
            s = fleet.DistributedStrategy()
            s.pipeline_configs.update(accumulate_steps=2,
                                      schedule_mode=mode)
            fleet._FLEET_STATE["strategy"] = s
            pipe = mp.PipelineLayer(
                [mp.LayerDesc(port.nn.Linear, 2, 2) for _ in range(4)],
                num_virtual_pipeline_stages=V)
            model = fleet.distributed_model(pipe)
            assert type(model) is want, (mode, V)
            assert model.stage_id == 0 and model.accumulate_steps == 2
        with pytest.raises(TypeError, match="PipelineLayer"):
            fleet.distributed_model(port.nn.Linear(2, 2))
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            topology.CommunicateTopology(dims=(1, 1, 1, 1, 1))))
        s = fleet.DistributedStrategy()
        s.pipeline_configs["schedule_mode"] = "ZBH1"
        fleet._FLEET_STATE["strategy"] = s
        assert type(fleet.distributed_model(port.nn.Linear(2, 2))) is \
            port.distributed.DataParallel
    finally:
        fleet._FLEET_STATE["strategy"] = None
        topology.set_hybrid_communicate_group(old)
