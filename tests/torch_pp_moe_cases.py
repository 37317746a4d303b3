"""The port's side of the pipeline and MoE tests
(tests/test_torch_pipeline_layers.py, test_torch_moe_layer.py): rank
functions run by tests/torch_dist_worker.py on 4 gloo ranks, each
returning arrays for ``DIR/<name>.r<rank>.npz``. Inputs come from the
seeds of tests/torch_dist_common.py or, for the GPT's weights, from
``DIR/<name>.in.npz`` (the reference's initial state under its
one-stage names).
"""

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.meta_parallel import (LayerDesc,
                                                              PipelineLayer)
from paddle_tpu_torch.utils.convert import (pipeline_global_state,
                                            pipeline_shards_from_global)

import torch_dist_common as C
import torch_mp_gpt as G


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _pp_fleet(dp=1, mp=1, pp=1, n=4, mb=2, zb=False):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sep_degree": 1}
    s.pipeline_configs = {"accumulate_steps": n, "micro_batch_size": mb}
    if zb:
        s.pipeline_configs["schedule_mode"] = "ZBH1"
    return fleet.init(strategy=s)


def _record(out, tag, model, losses):
    out[f"{tag}/kind"] = np.asarray(type(model).__name__)
    out[f"{tag}/log"] = np.asarray(";".join(model.schedule_log))
    out[f"{tag}/stash"] = np.asarray([model.max_stash])
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/deferred"] = np.asarray([getattr(model, "deferred", 0)])


def pp_linear(case, rank):
    """tests/test_zero_bubble.py's and test_gpt_model.py's Linear stacks
    through ``fleet.distributed_model`` at ``case``'s dp x pp: each run
    one ``train_batch`` of SGD (with ``ClipGradByGlobalNorm`` where the
    run names a clip), the dp ranks taking their half of the batch."""
    out = {}
    for run in case["runs"]:
        tag, sched, V = run["tag"], run["schedule"], run.get("V", 1)
        hcg = _pp_fleet(dp=case["dp"], pp=case["pp"], n=run["n"],
                        zb=sched == "zb")
        ws, X, Y = C.linear_stack(run["seed"], run["layers"], run["rows"])
        dp, r = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
        k = len(X) // dp
        X, Y = X[r * k:(r + 1) * k], Y[r * k:(r + 1) * k]
        pipe = PipelineLayer(
            [LayerDesc(pt.nn.Linear, 8, 8, bias_attr=False)
             for _ in range(run["layers"])],
            loss_fn=lambda p, y: pt.nn.functional.cross_entropy(p, y),
            num_virtual_pipeline_stages=V if V > 1 else None)
        for i, lyr in pipe._built_by_index.items():
            lyr.weight.set_value(pt.to_tensor(ws[i]))
        model = fleet.distributed_model(pipe)
        clip = pt.nn.ClipGradByGlobalNorm(run["clip"]) if run.get("clip") \
            else None
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=0.05, parameters=pipe.parameters(),
            grad_clip=clip))
        loss = model.train_batch((pt.to_tensor(X), pt.to_tensor(Y)), opt)
        _record(out, tag, model, [float(loss.numpy())])
        if clip is not None:
            out[f"{tag}/norm"] = np.asarray(
                [float(opt._inner_opt._grad_clip.last_norm)])
        for i, lyr in pipe._built_by_index.items():
            out[f"{tag}/w{i}"] = _np(lyr.weight)
    return out


def pp_gpt(case, rank):
    """The mp GPT (tests/torch_mp_gpt.py) as a ``PipelineLayer`` at pp 2 x
    mp 2 from the reference's initial weights, through each run's
    schedule: ``eval_batch`` first where asked, then ``steps``
    ``train_batch`` calls of SGD (clipped where asked); the global state
    after them under the one-stage names."""
    cfg = G.MPGPTConfig(**case["cfg"])
    tok, lab = G.batch(cfg, case["batch"])
    out = {}
    for run in case["runs"]:
        tag, sched, V = run["tag"], run["schedule"], run.get("V", 1)
        tied = run.get("tied", False)
        hcg = _pp_fleet(mp=2, pp=2, n=case["n"], mb=case["batch"] //
                        case["n"], zb=sched == "zb")
        init = C.unflat_state("tied" if tied else "untied",
                              C.load_inputs(case["root"], case["name"]))
        descs, loss_fn = G.pipeline(pt, cfg, tied=tied)
        pipe = PipelineLayer(descs, loss_fn=loss_fn, seg_method="layer:Block",
                             num_virtual_pipeline_stages=V if V > 1 else None)
        one = C.stage_names([0, len(descs)], 1)
        mine = C.stage_names(pipe.segment_parts, 2, V)
        pipe.set_state_dict(pipeline_shards_from_global(
            C.rename_stages(init, one, mine), pipe, "cpu"))
        model = fleet.distributed_model(pipe)
        data = (pt.to_tensor(tok), pt.to_tensor(lab))
        if run.get("eval"):
            out[f"{tag}/eval"] = np.asarray([float(model.eval_batch(
                data).numpy())])
        clip = pt.nn.ClipGradByGlobalNorm(case["clip"]) if run.get("clip") \
            else None
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=case["lr"], parameters=pipe.parameters(),
            grad_clip=clip))
        losses, norms = [], []
        for _ in range(case["steps"]):
            losses.append(float(model.train_batch(data, opt).numpy()))
            if clip is not None:
                norms.append(float(opt._inner_opt._grad_clip.last_norm))
        _record(out, tag, model, losses)
        out[f"{tag}/norms"] = np.asarray(norms)
        out[f"{tag}/p2p"] = np.asarray([model.p2p_stats["sends"],
                                        model.p2p_stats["recvs"]])
        state = C.rename_stages(pipeline_global_state(pipe), mine, one)
        for k, v in state.items():
            out[f"{tag}/params/{k}"] = v
    return out


def moe_group(case, rank):
    """``MoELayer`` (GShard top-2 over ``case["E"]`` experts, capacity
    drops) at moe groups of 1, 2 and 4 (each rank alone; the mp axis of
    dp 2 x mp 2; dp 4), group rank r taking rows r of the concatenated
    batch; a sum loss (and the gate's auxiliary loss), then a mean loss;
    and the expert all-to-all alone on uneven counts."""
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.utils.convert import (moe_global_state,
                                                moe_shards_from_global)

    d, h, E, N, cf = case["d"], case["h"], case["E"], case["N"], case["cf"]
    state = C.moe_arrays(case["seed"], d, h, E)
    out = {}
    for W in (1, 2, 4):
        hcg = _pp_fleet(dp=4 // W if W < 4 else 4, mp=W if W == 2 else 1)
        group = None if W == 1 else (hcg.get_model_parallel_group()
                                     if W == 2 else
                                     hcg.get_data_parallel_group())
        r = 0 if group is None else group.rank
        rng = np.random.RandomState(case["seed"] + W)
        X = rng.randn(W * N, d).astype(np.float32)
        cot = rng.randn(W * N, d).astype(np.float32)
        rows = slice(r * N, (r + 1) * N)
        for loss_kind in ("sum", "mean"):
            experts = [pt.nn.Sequential(pt.nn.Linear(d, h), pt.nn.GELU(),
                                        pt.nn.Linear(h, d))
                       for _ in range(E // W)]
            moe = MoELayer(d, experts, gate={"type": "gshard", "top_k": 2},
                           moe_group=group, capacity_factor=cf)
            moe.set_state_dict(moe_shards_from_global(state, moe, "cpu"))
            x = pt.to_tensor(X[rows])
            x.stop_gradient = False
            y = moe(x)
            aux = moe.gate.get_loss()
            if loss_kind == "sum":
                loss = (y * pt.to_tensor(cot[rows])).sum() + aux
            else:
                loss = (y * pt.to_tensor(cot[rows])).mean()
            loss.backward()
            tag = f"g{W}/{loss_kind}"
            out[f"{tag}/y"] = _np(y)
            out[f"{tag}/xgrad"] = _np(x.grad)
            out[f"{tag}/aux"] = np.asarray([float(aux.numpy())])
            out[f"{tag}/keep"] = moe.last_routing["keep"].numpy()
            grads = {}
            for n, p in moe.named_parameters():
                grads[n] = p.grad
            for k, v in moe_global_state(_GradView(moe, grads)).items():
                out[f"{tag}/grad/{k}"] = v
    # the all-to-all alone: uneven counts over dp 4
    hcg = _pp_fleet(dp=4)
    g = hcg.get_data_parallel_group()
    counts = np.random.RandomState(case["seed"]).randint(0, 4, (4, 8))
    lc = counts[rank]                      # to expert i % 2 of rank i // 2
    gc = np.concatenate([counts[j].reshape(4, 2)[rank] for j in range(4)])
    x = pt.to_tensor(np.arange(lc.sum() * 3, dtype=np.float32).reshape(
        -1, 3) + 1000 * rank)
    x.stop_gradient = False
    s = global_scatter(x, pt.to_tensor(lc), pt.to_tensor(gc), group=g)
    back = global_gather(s, pt.to_tensor(lc), pt.to_tensor(gc), group=g)
    (s * pt.to_tensor(np.arange(s.shape[0] * 3, dtype=np.float32)
                      .reshape(-1, 3))).sum().backward()
    out["a2a/x"], out["a2a/s"], out["a2a/back"] = _np(x), _np(s), _np(back)
    out["a2a/xgrad"] = _np(x.grad)
    out["a2a/lc"], out["a2a/gc"] = lc, gc
    return out


def moe_dp(case, rank):
    """``MoELayer`` under dp, one SGD step clipped by
    ``ClipGradByGlobalNorm`` through ``fleet.distributed_model`` /
    ``distributed_optimizer``, on a sum loss plus the auxiliary loss:
    ``mp``, dp 2 x mp 2 with the moe group over mp (the dp replicas hold
    the same experts, each replica on a batch of its own, mp rank r on
    its rows r); ``dp``, dp 4 with the moe group over dp (each rank its
    own experts, rank r on rows r of one batch). The clip's norm and the
    global state after the step."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.utils.convert import (moe_global_state,
                                                moe_shards_from_global)

    d, h, E, N = case["d"], case["h"], case["E"], case["N"]
    state = C.moe_arrays(case["seed"], d, h, E)
    out = {}
    for tag, dp, mp in (("mp", 2, 2), ("dp", 4, 1)):
        hcg = _pp_fleet(dp=dp, mp=mp)
        group = hcg.get_model_parallel_group() if mp > 1 else \
            hcg.get_data_parallel_group()
        W = group.nranks
        X, cot = C.moe_batches(case["seed"] + W, dp * mp // W, W * N, d)
        j = hcg.get_data_parallel_rank() if mp > 1 else 0
        rows = slice(group.rank * N, (group.rank + 1) * N)
        experts = [pt.nn.Sequential(pt.nn.Linear(d, h), pt.nn.GELU(),
                                    pt.nn.Linear(h, d))
                   for _ in range(E // W)]
        moe = MoELayer(d, experts, gate={"type": "gshard", "top_k": 2},
                       moe_group=group, capacity_factor=case["cf"])
        moe.set_state_dict(moe_shards_from_global(state, moe, "cpu"))
        model = fleet.distributed_model(moe)
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=case["lr"], parameters=moe.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(case["clip"])))
        y = model(pt.to_tensor(X[j][rows]))
        loss = (y * pt.to_tensor(cot[j][rows])).sum() + moe.gate.get_loss()
        loss.backward()
        opt.step()
        out[f"{tag}/kind"] = np.asarray(type(model).__name__)
        out[f"{tag}/norm"] = np.asarray(
            [float(opt._inner_opt._grad_clip.last_norm)])
        for k, v in moe_global_state(moe).items():
            out[f"{tag}/params/{k}"] = v
    return out


class _GradView:
    """A MoELayer seen through its gradients (for ``moe_global_state``)."""

    def __init__(self, moe, grads):
        self.group, self.num_expert = moe.group, moe.num_expert
        self._grads = grads

    def state_dict(self):
        return {k: pt.Tensor(g._data) for k, g in self._grads.items()}
