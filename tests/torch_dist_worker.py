"""Worker of the collective, fleet-Layer, DataParallel, pipeline and MoE
tests: one gloo rank of the port, started by the port's launcher
(``paddle_tpu_torch.distributed.launch.launch_procs``).

    python tests/torch_dist_worker.py DIR

``DIR/cases.json`` lists the cases; each names its ``kind``, a
function below or of tests/torch_pp_moe_cases.py, which runs the port's side on this rank and returns
arrays written to ``DIR/<name>.r<rank>.npz``. Inputs come from the
seeds of tests/torch_dist_common.py or, where the reference draws
them (initial weights), from ``DIR/<name>.in.npz``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.utils.convert import (  # noqa: E402
    layer_global_state, layer_shards_from_global)

import torch_dist_common as C  # noqa: E402
from torch_pp_moe_cases import (  # noqa: E402,F401  (kinds of cases.json)
    moe_dp, moe_group, pp_gpt, pp_linear)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _fleet(dp=1, mp=1, sep=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": 1,
                        "sep_degree": sep}
    return fleet.init(strategy=s)


def _grad_leaf(a):
    t = pt.to_tensor(a)
    t.stop_gradient = False
    return t


# -- collectives (dp 4) --------------------------------------------------------

def collective(case, rank):
    g = dist.init_parallel_env({"dp": 4})
    dp = fleet.get_hybrid_communicate_group().get_data_parallel_group()
    n, out = 4, {}
    out["world"] = np.asarray([dist.get_world_size(), dist.get_rank(),
                               dist.get_rank(dp), g.nranks])
    t = pt.to_tensor(np.full((4, 3), 2.0, np.float32))
    handle = t._data
    dist.all_reduce(t)
    out["ar_sum"] = _np(t)
    out["ar_inplace"] = np.asarray([t._data is handle])
    t = pt.to_tensor(np.full((2,), 3.0, np.float32))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    out["ar_max"] = _np(t)
    for dt in ("float32", "int32"):
        x = np.arange(16).reshape(8, 2).astype(dt)
        ops = ("SUM", "MAX", "MIN", "PROD", "AVG") if dt == "float32" \
            else ("SUM", "MAX", "MIN")
        for op in ops:
            t = pt.to_tensor(x[2 * rank:2 * rank + 2])
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=dp)
            out[f"ar_shard_{op}_{dt}"] = _np(t)
    lst = []
    dist.all_gather(lst, pt.to_tensor(np.arange(6, dtype=np.float32)
                                      .reshape(2, 3)))
    out["ag_rep"] = np.stack([_np(o) for o in lst])
    x = np.arange(16, dtype=np.float32).reshape(16, 1)
    out["ag_shard"] = _np(dist.all_gather(pt.to_tensor(x[4 * rank:
                                                         4 * rank + 4]),
                                          group=dp).wait())
    out["rs"] = _np(dist.reduce_scatter(
        pt.to_tensor(np.ones((8, 2), np.float32))).wait())
    o = pt.to_tensor(np.zeros((2, 2), np.float32))
    dist.reduce_scatter(o, [pt.to_tensor(np.full((2, 2), float(rank + j),
                                                 np.float32))
                            for j in range(n)], op=dist.ReduceOp.MAX)
    out["rs_list_max"] = _np(o)
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    t = pt.to_tensor(x[2 * rank:2 * rank + 2])
    dist.broadcast(t, src=2, group=dp)
    out["bc"] = _np(t)
    x = np.arange(16, dtype=np.float32)
    out["a2a"] = _np(dist.alltoall_single(pt.to_tensor(x[4 * rank:
                                                          4 * rank + 4]),
                                          group=dp).wait())
    ins = [j + 1 for j in range(n)]
    outs = [rank + 1] * n
    src = (100 * rank + np.arange(sum(ins))).astype(np.float32)
    buf = pt.to_tensor(np.zeros(sum(outs), np.float32))
    dist.alltoall_single(pt.to_tensor(src), buf, ins, outs, group=dp)
    out["a2a_split"] = _np(buf)
    t = pt.to_tensor(np.zeros(2, np.float32))
    parts = [pt.to_tensor(np.full(2, 10.0 * j + 1, np.float32))
             for j in range(n)] if rank == 1 else None
    dist.scatter(t, parts, src=1, group=dp)
    out["scatter"] = _np(t)
    t = pt.to_tensor(np.full(3, rank + 1.0, np.float32))
    dist.reduce(t, dst=1, group=dp)
    out["reduce"] = _np(t)
    t = pt.to_tensor(np.full(3, 2.0, np.float32))
    dist.reduce(t, dst=1, group=dp)
    out["reduce_rep"] = _np(t)
    got = []
    dist.alltoall(got, [pt.to_tensor(np.full(2, 10.0 * rank + j,
                                             np.float32))
                        for j in range(n)], group=dp)
    out["a2a_list"] = np.stack([_np(o) for o in got])
    sendt = pt.to_tensor(np.full(3, 7.0 + rank, np.float32))
    recvt = pt.to_tensor(np.zeros(3, np.float32))
    tasks = [dist.isend(sendt, (rank + 1) % n, group=dp),
             dist.irecv(recvt, (rank - 1) % n, group=dp)]
    for task in tasks:
        task.wait()
    out["ring"] = _np(recvt)
    t = pt.to_tensor(np.full(2, 5.0 + rank, np.float32))
    if rank == 0:
        dist.send(t, dst=3, group=dp)
    elif rank == 3:
        dist.recv(t, src=0, group=dp)
    out["p2p"] = _np(t)
    objs = []
    dist.all_gather_object(objs, {"r": rank})
    out["objects"] = np.asarray([o["r"] for o in objs])
    t = pt.to_tensor(np.full(2, 1.0, np.float32))
    task = dist.all_reduce(t, sync_op=False)
    res = task.wait()
    out["async"] = np.asarray([task.is_completed(), res is t])
    out["async_value"] = _np(t)
    dist.barrier()
    return out


# -- fleet layers ------------------------------------------------------------

def fleet_tp(case, rank):
    """The tensor-parallel cases of tests/test_fleet_tp.py and the
    sequence-parallel ones, at mp 4."""
    _fleet(mp=4)
    out = {}
    a = C.tp_arrays(0, {"w": (16, 32), "b": (32,), "x": (8, 16)})
    col = fleet.ColumnParallelLinear(16, 32, gather_output=True)
    col.set_state_dict(layer_shards_from_global({"weight": a["w"],
                                                 "bias": a["b"]}, col, "cpu"))
    x = _grad_leaf(a["x"])
    y = col(x)
    y.sum().backward()
    out.update(col_y=_np(y), col_wg=_np(col.weight.grad),
               col_bg=_np(col.bias.grad), col_xg=_np(x.grad))
    a = C.tp_arrays(1, {"w1": (16, 32), "w2": (32, 16), "x": (4, 16)})
    c = fleet.ColumnParallelLinear(16, 32, has_bias=False,
                                   gather_output=False)
    r = fleet.RowParallelLinear(32, 16, has_bias=False,
                                input_is_parallel=True)
    c.set_state_dict(layer_shards_from_global({"weight": a["w1"]}, c, "cpu"))
    r.set_state_dict(layer_shards_from_global({"weight": a["w2"]}, r, "cpu"))
    x = _grad_leaf(a["x"])
    y = r(c(x))
    y.sum().backward()
    out.update(pair_y=_np(y), pair_w1g=_np(c.weight.grad),
               pair_w2g=_np(r.weight.grad), pair_xg=_np(x.grad))
    a = C.tp_arrays(5, {"w": (32, 16), "b": (16,), "x": (4, 32)})
    r = fleet.RowParallelLinear(32, 16, input_is_parallel=False)
    r.set_state_dict(layer_shards_from_global({"weight": a["w"],
                                               "bias": a["b"]}, r, "cpu"))
    x = _grad_leaf(a["x"])
    y = r(x)
    (y * y).sum().backward()
    out.update(row_y=_np(y), row_wg=_np(r.weight.grad),
               row_bg=_np(r.bias.grad), row_xg=_np(x.grad))
    rng = np.random.RandomState(2)
    table = rng.randn(64, 8).astype(np.float32)
    ids = rng.randint(0, 64, size=(4, 6))
    emb = fleet.VocabParallelEmbedding(64, 8)
    emb.set_state_dict(layer_shards_from_global({"weight": table}, emb,
                                                "cpu"))
    y = emb(pt.to_tensor(ids))
    (y * y).sum().backward()
    out.update(emb_y=_np(y), emb_g=_np(emb.weight.grad))
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 64).astype(np.float32)
    labels = rng.randint(0, 64, size=(4,))
    labels[2] = -100
    t = _grad_leaf(logits[:, 16 * rank:16 * rank + 16])
    loss = fleet.ParallelCrossEntropy()(t, pt.to_tensor(labels))
    (loss * pt.to_tensor(np.arange(1, 5, dtype=np.float32))).sum() \
        .backward()
    out.update(ce_loss=_np(loss), ce_g=_np(t.grad))
    out.update(_sequence_parallel(rank))
    return out


def _sequence_parallel(rank):
    from paddle_tpu_torch.distributed.fleet import sequence_parallel_utils \
        as spu

    out = {}
    a = C.tp_arrays(0, {"w1": (16, 32), "w2": (32, 16), "x": (8, 2, 16)})
    col = spu.ColumnSequenceParallelLinear(16, 32, has_bias=False)
    row = spu.RowSequenceParallelLinear(32, 16, has_bias=False)
    col.set_state_dict(layer_shards_from_global({"weight": a["w1"]}, col,
                                                "cpu"))
    row.set_state_dict(layer_shards_from_global({"weight": a["w2"]}, row,
                                                "cpu"))
    x = _grad_leaf(a["x"])
    y = spu.GatherOp.apply(row(col(spu.ScatterOp.apply(x))))
    y.sum().backward()
    out.update(sp_y=_np(y), sp_w1g=_np(col.weight.grad),
               sp_w2g=_np(row.weight.grad), sp_xg=_np(x.grad))
    # LayerNorm on the sequence-split activations: its gradients sum
    # over mp through the hook
    a = C.tp_arrays(4, {"x": (8, 2, 16), "gamma": (16,), "beta": (16,),
                        "dy": (8, 2, 16)})
    lns = []
    for hooked in (True, False):
        ln = pt.nn.LayerNorm(16)
        ln.set_state_dict({"weight": pt.to_tensor(a["gamma"]),
                           "bias": pt.to_tensor(a["beta"])})
        for p in ln.parameters():
            spu.mark_as_sequence_parallel_parameter(p)
        if hooked:
            marked = spu.register_sequence_parallel_allreduce_hooks(ln)
            out["sp_hooked"] = np.asarray([len(marked)])
        x = _grad_leaf(a["x"])
        y = spu.GatherOp.apply(ln(spu.ScatterOp.apply(x)))
        (y * pt.to_tensor(a["dy"])).sum().backward()
        lns.append(ln)
        out[f"ln_{'hook' if hooked else 'plain'}_wg"] = _np(ln.weight.grad)
        out[f"ln_{'hook' if hooked else 'plain'}_bg"] = _np(ln.bias.grad)
        out["ln_y"] = _np(y)
        out["ln_xg"] = _np(x.grad)
    return out


def rng_tracker(case, rank):
    """The tracker's streams at dp 2 x mp 2."""
    hcg = _fleet(dp=2, mp=2)
    from paddle_tpu_torch.distributed.fleet.random import (
        get_rng_state_tracker, model_parallel_random_seed)

    model_parallel_random_seed(1234)
    tr = get_rng_state_tracker()
    out = {"coords": np.asarray([hcg.get_data_parallel_rank(),
                                 hcg.get_model_parallel_rank()])}
    with tr.rng_state("local_seed"):
        out["local"] = _np(pt.randn([4]))
        out["local2"] = _np(pt.randn([4]))
    with tr.rng_state("global_seed"):
        out["global"] = _np(pt.randn([4]))
    out["default"] = _np(pt.randn([4]))
    saved = tr.get_states_tracker()
    with tr.rng_state("local_seed"):
        a = _np(pt.randn([4]))
    tr.set_states_tracker(saved)
    with tr.rng_state("local_seed"):
        b = _np(pt.randn([4]))
    out["replay"] = np.stack([a, b])
    return out


def sep(case, rank):
    """tests/test_moe_sp_sep.py's segment-parallel case at sep 4."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        concat_sequence, split_sequence)

    _fleet(sep=4)
    a = C.tp_arrays(6, {"w": (8, 8), "b": (8,), "x": (2, 8, 8)})
    model = pt.nn.Linear(8, 8)
    model.set_state_dict({"weight": pt.to_tensor(a["w"]),
                          "bias": pt.to_tensor(a["b"])})
    wrapped = fleet.distributed_model(model)
    x = _grad_leaf(a["x"])
    y = concat_sequence(wrapped(split_sequence(x, axis=1)), axis=1)
    (y * y).sum().backward()
    return {"kind": np.asarray(type(wrapped).__name__), "y": _np(y),
            "wg": _np(model.weight.grad), "bg": _np(model.bias.grad),
            "xg": _np(x.grad)}


# -- DataParallel and the hybrid optimizer (dp 2 x mp 2) ------------------------

def _dp_rows(a, hcg):
    n, r = hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank()
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def bert_dp(case, rank):
    """BertForPretraining under DataParallel, 3 AdamW steps; then the
    same from the same state with buckets of ``small_mb`` MB."""
    from paddle_tpu_torch.models import bert as tb

    hcg = _fleet(dp=2, mp=2)
    init = C.unflat_state("params", C.load_inputs(case["root"],
                                                  case["name"]))
    ids, tt, mlm, nsp = (_dp_rows(a, hcg) for a in C.bert_batch(
        **case["batch"]))
    out = {}
    for tag, mb in (("", 25), ("small_", case["small_mb"])):
        model = tb.BertForPretraining(tb.BertConfig(**case["cfg"]))
        model.set_state_dict({k: pt.to_tensor(v) for k, v in init.items()})
        dp = dist.DataParallel(model, comm_buffer_size=mb,
                               last_comm_buffer_size=mb)
        crit = tb.BertPretrainingCriterion(case["cfg"]["vocab_size"])
        opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=dp.parameters())
        batch = [pt.to_tensor(a) for a in (ids, tt, mlm, nsp)]
        losses = []
        for _ in range(case["steps"]):
            loss = crit(*dp(*batch[:2]), *batch[2:])
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        out[tag + "losses"] = np.asarray(losses)
        out[tag + "stats"] = np.asarray([
            len(dp._buckets), dp.stats["steps"], dp.stats["allreduce_calls"],
            dp.stats["allreduce_bytes"],
            sum(p._data.numel() * p._data.element_size()
                for p in model.parameters())])
        for k, v in _state(model).items():
            out[f"{tag}params/{k}"] = v
    return out


def _mlp(seed):
    a = C.tp_arrays(seed, {"w1": (8, 16), "b1": (16,), "w2": (16, 4),
                           "b2": (4,), "w3": (4, 4)})
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.GELU(),
                           pt.nn.Linear(16, 4))
    net.set_state_dict({"0.weight": pt.to_tensor(a["w1"]),
                        "0.bias": pt.to_tensor(a["b1"]),
                        "2.weight": pt.to_tensor(a["w2"]),
                        "2.bias": pt.to_tensor(a["b2"])})
    return net, a


def dp_small(case, rank):
    """no_sync accumulation, unused parameters, the sum loss and AMP's
    found-inf under DataParallel at dp 2."""
    hcg = _fleet(dp=2, mp=2)
    r = hcg.get_data_parallel_rank()
    out = {}
    xs = C.tp_arrays(7, {"x0": (4, 8), "x1": (4, 8)})
    # no_sync: micro-batch 0 accumulates locally, micro-batch 1 syncs
    net, _ = _mlp(8)
    dp = dist.DataParallel(net)
    with dp.no_sync():
        (dp(pt.to_tensor(_dp_rows(xs["x0"], hcg))) ** 2).mean().backward()
    out["nosync_local"] = _np(net[0].weight.grad)
    (dp(pt.to_tensor(_dp_rows(xs["x1"], hcg))) ** 2).mean().backward()
    for i, p in enumerate(net.parameters()):
        out[f"nosync_g{i}"] = _np(p.grad)
    out["nosync_steps"] = np.asarray([dp.stats["steps"]])
    # a layer no backward reaches: refused, then synced as zeros
    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = _mlp(8)[0]
            self.extra = pt.nn.Linear(4, 4)
            self.extra.set_state_dict({
                "weight": pt.to_tensor(np.eye(4, dtype=np.float32)),
                "bias": pt.to_tensor(np.ones(4, np.float32))})

        def forward(self, x, branch=False):
            y = self.body(x)
            return self.extra(y) if branch else y

    x = pt.to_tensor(_dp_rows(xs["x0"], hcg))
    strict = dist.DataParallel(Net())
    try:
        (strict(x) ** 2).mean().backward()
        out["unused_refused"] = np.asarray([0])
    except RuntimeError as e:
        out["unused_refused"] = np.asarray([int("find_unused" in str(e))])
    model = Net()
    loose = dist.DataParallel(model, find_unused_parameters=True)
    (loose(x) ** 2).mean().backward()
    for i, p in enumerate(model.parameters()):
        out[f"unused_g{i}"] = _np(p.grad)
    # a branch only dp rank 1 takes
    model = Net()
    loose = dist.DataParallel(model, find_unused_parameters=True)
    (loose(x, branch=r == 1) ** 2).mean().backward()
    for i, p in enumerate(model.parameters()):
        out[f"branch_g{i}"] = _np(p.grad)
    # the sum loss: Paddle's average over dp
    lin = pt.nn.Linear(8, 4)
    a = C.tp_arrays(9, {"w": (8, 4), "b": (4,)})
    lin.set_state_dict({"weight": pt.to_tensor(a["w"]),
                        "bias": pt.to_tensor(a["b"])})
    dp = dist.DataParallel(lin)
    (dp(pt.to_tensor(_dp_rows(xs["x0"], hcg))) ** 2).sum().backward()
    out["sum_wg"] = _np(lin.weight.grad)
    out["sum_bg"] = _np(lin.bias.grad)
    # AMP: an inf in dp rank 1's no_sync gradient reaches every rank
    net, _ = _mlp(8)
    dp = dist.DataParallel(net)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    before = _np(net[0].weight)
    with dp.no_sync():
        scaler.scale((dp(pt.to_tensor(_dp_rows(xs["x0"], hcg))) ** 2)
                     .mean()).backward()
    if r == 1:
        net[0].weight._data.grad[0, 0] = float("inf")
    scaler.scale((dp(pt.to_tensor(_dp_rows(xs["x1"], hcg))) ** 2)
                 .mean()).backward()
    scaler.step(opt)
    scaler.update()
    out["amp_skip"] = np.asarray([scaler._found_inf,
                                  scaler.get_loss_scaling(),
                                  float(np.array_equal(_np(net[0].weight),
                                                       before))])
    opt.clear_grad()
    scaler.scale((dp(pt.to_tensor(_dp_rows(xs["x1"], hcg))) ** 2)
                 .mean()).backward()
    scaler.step(opt)
    scaler.update()
    out["amp_take"] = np.asarray([scaler._found_inf,
                                  scaler.get_loss_scaling()])
    out["amp_w"] = _np(net[0].weight)
    return out


def mp_gpt(case, rank):
    """The mp-Layer GPT at dp 2 x mp 2 through distributed_model and
    distributed_optimizer (AdamW, ClipGradByGlobalNorm)."""
    import torch_mp_gpt as G

    hcg = _fleet(dp=2, mp=2)
    cfg = G.MPGPTConfig(**case["cfg"])
    init = C.unflat_state("params", C.load_inputs(case["root"],
                                                  case["name"]))
    pm = G.build(pt, cfg)
    pm.set_state_dict(layer_shards_from_global(init, pm, "cpu"))
    model = fleet.distributed_model(pm)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=case["lr"], parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(case["clip"])))
    tok, lab = (_dp_rows(a, hcg) for a in G.batch(cfg, case["batch"]))
    losses, norms = [], []
    for _ in range(case["steps"]):
        loss = model.loss(pt.to_tensor(tok), pt.to_tensor(lab))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        norms.append(float(opt._inner_opt._grad_clip.last_norm))
    out = {"kind": np.asarray(type(model).__name__),
           "losses": np.asarray(losses), "norms": np.asarray(norms)}
    for k, v in layer_global_state(pm).items():
        out[f"params/{k}"] = v
    return out


def main() -> int:
    root = sys.argv[1]
    pt.set_device("cpu")
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed.launch import init_from_env

    assert init_from_env(device="cpu"), "no launcher environment"
    rank = tdist.get_rank()
    torch.set_num_threads(1)
    with open(os.path.join(root, "cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        case["root"] = root
        out = globals()[case["kind"]](case, rank)
        np.savez(os.path.join(root, f"{case['name']}.r{rank}.npz"), **out)
        tdist.barrier()
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
