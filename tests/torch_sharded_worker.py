"""Worker of the sharded-step tests: one gloo rank of the port's
``make_sharded_train_step``, started by the port's launcher
(``paddle_tpu_torch.distributed.launch.launch_procs``).

    python tests/torch_sharded_worker.py DIR

``DIR/cases.json`` lists the cases; for each, ``DIR/<name>.in.npz``
holds the JAX package's initial parameters and AdamW state and the
global batch. The rank runs the case's steps from that state on the
case's mesh and writes ``DIR/<name>.r<rank>.npz``: its losses and, on
every rank, the whole parameters (reference order) gathered from the
blocks and, with ``moment1``, the first moments after step 1 gathered
alike; ``schedule`` sets the pipelined step's. A case with ``count`` also writes how many times the forward
called each training kernel's wrapper (``KERNELS``; on the CPU they
run their plain versions), and ``ce_kernels`` routes the cross-entropy
through K4/K5's wrappers on the CPU too, where the model keeps them to
CUDA; it also counts the ppermute sends of the step (ring attention's
k / v rotations, the pipeline's exchanges). A case of kind
``quant_allreduce`` runs ``dist_allreduce_quant`` on the case's inputs
instead; kind ``checkpoint`` saves and loads a sharded state
(tests/test_torch_sharded_checkpoint.py); kind ``pipeline`` runs
``pipeline_blocks_fn`` alone and kind ``ring`` ``ring_attention`` alone
(tests/test_torch_pipeline.py, tests/test_torch_ring.py); kind
``transport`` runs ``ppermute`` and ``all_to_all_dim``
(tests/test_torch_ring.py); kind ``topology`` builds a
``HybridCommunicateGroup`` (tests/test_torch_topology.py); kind
``build`` builds a step without running it.
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.core.flags import GLOBAL_FLAGS  # noqa: E402
from paddle_tpu_torch.distributed.launch import init_from_env  # noqa: E402
from paddle_tpu_torch.distributed.process_mesh import build_mesh  # noqa: E402
from paddle_tpu_torch.distributed.sharding import (  # noqa: E402
    gather_tree, shard_array_over)
from paddle_tpu_torch.models.gpt import GPTConfig  # noqa: E402
from paddle_tpu_torch.parallel.train_step import (  # noqa: E402
    make_sharded_train_step)
from paddle_tpu_torch.utils.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax)

BF16 = "::bf16"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unpack(npz, prefix: str) -> dict:
    """The nested tree under ``prefix/`` of a packed npz, as numpy
    leaves (bf16 leaves as torch tensors)."""
    out: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        name = key[len(prefix) + 1:]
        a = npz[key]
        if name.endswith(BF16):
            name = name[:-len(BF16)]
            a = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        d = out
        parts = name.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = a
    return out


def pack(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            pack(v, key, out)
        elif v.dtype == torch.bfloat16:
            out[key + BF16] = v.detach().cpu().view(torch.int16).numpy()
        else:
            out[key] = v.detach().cpu().numpy()
    return out


def _tensors(tree):
    """numpy leaves -> tensors (bf16 ones already are)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.array(tree))


# (module, name) of every training kernel's wrapper the sharded forward
# calls, by the name its count is written under
KERNELS = {"fused_norm_epilogue": ("gpt", "fused_norm_epilogue"),
           "fused_bias_act": ("gpt", "fused_bias_gelu"),
           "fused_ce_fwd": ("fused_ce", "fused_ce_fwd"),
           "fused_ce_bwd": ("fused_ce", "fused_ce_bwd")}


@contextlib.contextmanager
def counting_kernels(case: dict):
    """With the case's ``count``: each of ``KERNELS`` wrapped with a
    counter (K4/K5 in both modules that call them) while the block runs;
    yields the counts ({} without ``count``). With ``ce_kernels`` the
    model's cross-entropy gate stops asking for CUDA."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import fused_ce

    from paddle_tpu_torch.distributed.autograd_collectives import ppermute

    counts, saved = {}, []
    sends = ppermute.sends
    if case.get("count"):
        counts = dict.fromkeys(KERNELS, 0)
        mods = {"gpt": [gpt], "fused_ce": [gpt, fused_ce]}

        def counted(key, fn):
            def wrapper(*a, **kw):
                counts[key] += 1
                return fn(*a, **kw)
            return wrapper

        for key, (mod, name) in KERNELS.items():
            for m in mods[mod]:
                saved.append((m, name, getattr(m, name)))
                setattr(m, name, counted(key, getattr(m, name)))
    if case.get("ce_kernels"):
        saved.append((gpt, "_ce_kernels", gpt._ce_kernels))
        gpt._ce_kernels = lambda x, n, v, cfg: fused_ce.fused_ce_supported(
            n, cfg.hidden, v, cfg.dtype)
    try:
        yield counts
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        if case.get("count"):
            counts["ppermute_sends"] = ppermute.sends - sends


def run_step_case(case: dict, root: str, rank: int) -> None:
    name = case["name"]
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    cfg_kw = dict(case["cfg"])
    cfg_kw["dtype"] = DTYPES[cfg_kw.pop("dtype", "float32")]
    cfg = GPTConfig(**cfg_kw)
    mesh = build_mesh(tuple(case["mesh"]), ("dp", "pp", "mp"))
    GLOBAL_FLAGS.set("dist_allreduce_quant", bool(case.get("quant")))
    try:
        step, _, _ = make_sharded_train_step(cfg, mesh, device="cpu",
                                             **case["step"])
        if "schedule" in case:
            step.pipe.schedule = case["schedule"]
        params = params_from_jax(_tensors(unpack(npz, "params")), "cpu",
                                 mesh=mesh, cfg=cfg)
        opt = opt_state_from_jax(_tensors(unpack(npz, "opt")), "cpu",
                                 mesh=mesh, cfg=cfg,
                                 zero1=case["step"].get("zero1", True))
        if case.get("zero3"):
            params = {k: _map(lambda a: shard_array_over(a, mesh, "dp"), v)
                      for k, v in params.items()}
        tok, lab = npz["tokens"], npz["labels"]
        losses, m1 = [], {}
        with counting_kernels(case) as counts:
            for i in range(case["steps"]):
                loss, params, opt = step(params, opt, tok, lab)
                losses.append(loss.item())
                if i == 0 and case.get("moment1"):
                    # copies: the next step writes the moments in place
                    m1 = {k: v.copy() for k, v in pack(
                        gather_tree(opt["m"], mesh), "m1", {}).items()}
    finally:
        GLOBAL_FLAGS.set("dist_allreduce_quant", False)
    out = pack(gather_tree(params, mesh), "params", m1)
    out["losses"] = np.asarray(losses, np.float64)
    for key, n in counts.items():
        out[f"count/{key}"] = np.asarray(n)
    np.savez(os.path.join(root, f"{name}.r{rank}.npz"), **out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def run_quant_case(case: dict, root: str, rank: int) -> None:
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.autograd_collectives import \
        dist_allreduce_quant

    name = case["name"]
    n = case["n"]
    group = dist.new_group(list(range(n)))
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    if rank < n:
        xs = torch.from_numpy(npz["xs"])
        out = dist_allreduce_quant(xs[rank], group, mean=case["mean"])
        np.savez(os.path.join(root, f"{name}.r{rank}.npz"),
                 out=out.numpy())


def _zeros_like(tree):
    """A state of the same layout (DTensor blocks and their column
    order), zero-filled."""
    from paddle_tpu_torch.distributed.sharding import REF_COLUMNS

    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    out = tree.clone()
    (out._local_tensor if hasattr(out, "_local_tensor") else out).zero_()
    if hasattr(tree, REF_COLUMNS):
        setattr(out, REF_COLUMNS, getattr(tree, REF_COLUMNS))
    return out


def run_checkpoint_case(case: dict, root: str, rank: int) -> None:
    """The reference's sharded state, converted, saved by every rank
    under ``<name>/port``; a zero state of the same layout loaded from
    the reference's ``<name>/jax`` and written whole."""
    from paddle_tpu_torch.distributed import checkpoint as tck

    name = case["name"]
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    cfg = GPTConfig(**case["cfg"], dtype=torch.float32)
    mesh = build_mesh(tuple(case["mesh"]), ("dp", "pp", "mp"))
    state = {"params": params_from_jax(_tensors(unpack(npz, "params")),
                                       "cpu", mesh=mesh, cfg=cfg),
             "opt": opt_state_from_jax(_tensors(unpack(npz, "opt")), "cpu",
                                       mesh=mesh, cfg=cfg)}
    tck.save_state_dict(state, os.path.join(root, name, "port"))
    target = _zeros_like(state)
    tck.load_state_dict(target, os.path.join(root, name, "jax"))
    whole = gather_tree(target, mesh)
    out = pack(whole["params"], "params", {})
    pack(whole["opt"], "opt", out)
    np.savez(os.path.join(root, f"{name}.r{rank}.npz"), **out)


def _stage_slice(a, mesh, axis="pp"):
    """This rank's block of a stacked leaf over ``axis``."""
    n = mesh.shape[axis]
    k = a.shape[0] // n
    i = mesh.axis_index(axis)
    return a[i * k:(i + 1) * k]


def run_pipeline_case(case: dict, root: str, rank: int) -> None:
    """``pipeline_blocks_fn`` alone on the reference's weights: (1) as a
    function of the blocks and x, the output and the gradients of the
    blocks and of x under the loss after the blocks (final LayerNorm,
    tied head, cross-entropy: ``tail``); (2) inside ``loss_fn(...,
    blocks_fn=)``, the loss and every gradient; (3) the host-driven
    schedule (``run``) with that loss a microbatch at a time, the
    gradients of the blocks and of x, and the peak stash."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.pipeline import pipeline_blocks_fn

    name = case["name"]
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    cfg = GPTConfig(**case["cfg"], dtype=torch.float32)
    mesh = build_mesh((1, case["pp"], 1), ("dp", "pp", "mp"))
    mesh.device_mesh
    params = _tensors(unpack(npz, "params"))
    blocks = {k: _stage_slice(v, mesh).clone() for k, v in
              params["blocks"].items()}
    toks = torch.from_numpy(npz["tokens"]).long()
    labs = torch.from_numpy(npz["labels"]).long()
    x0 = torch.from_numpy(npz["x0"])
    M = case["M"]
    B, T = toks.shape

    def stage_fn(sp, x):
        for i in range(sp["ln1_g"].shape[0]):
            x = gpt.block_apply({k: v[i] for k, v in sp.items()}, x, cfg)
        return x

    def tail(y, rows=slice(None)):
        h = gpt._layer_norm(y, params["lnf_g"], params["lnf_b"], cfg.eps)
        return gpt._chunked_ce_total(h, params["wte"].t(), labs[rows],
                                     512) / (B * T)

    bfn = pipeline_blocks_fn(stage_fn, mesh, M, schedule=case["schedule"])
    out = {}
    # (1) the function
    leaves = {k: v.clone().requires_grad_(True) for k, v in blocks.items()}
    x = x0.clone().requires_grad_(True)
    y = bfn(leaves, x)
    got = torch.autograd.grad(tail(y), [x] + list(leaves.values()))
    out["y"], out["gx"] = y.detach().numpy(), got[0].numpy()
    for k, g in zip(leaves, got[1:]):
        out[f"gb/{k}"] = g.numpy()
    # (2) inside loss_fn
    local = dict(params, blocks=blocks)
    local = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in local.items()}
    loss = gpt.loss_fn(local, toks, labs, cfg, blocks_fn=bfn)
    flat = [(k, v) for k, v in local.items() if not isinstance(v, dict)] + \
        [(f"blocks/{k}", v) for k, v in local["blocks"].items()]
    got = torch.autograd.grad(loss, [v for _, v in flat])
    out["loss"] = np.asarray(loss.item(), np.float64)
    for (k, _), g in zip(flat, got):
        out[f"g/{k}"] = g.numpy()
    # (3) the schedule with a tail per microbatch
    mb = B // M

    def tail_grad(j, yj):
        yd = yj.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(tail(yd, slice(j * mb, (j + 1) * mb)),
                                       yd)[0]

    xs = list(x0.reshape(M, mb, T, cfg.hidden)) \
        if bfn.stage == 0 else None
    dx, grads = bfn.run(blocks, xs, tail_grad if bfn.stage == case["pp"] - 1
                        else None, like=torch.empty(mb, T, cfg.hidden))
    if dx is not None:
        out["run/gx"] = torch.cat(dx).numpy()
    for k, g in grads.items():
        out[f"run/gb/{k}"] = g.numpy()
    out["run/peak_stash"] = np.asarray(bfn.peak_stash)
    np.savez(os.path.join(root, f"{name}.r{rank}.npz"), **out)


def run_ring_case(case: dict, root: str, rank: int) -> None:
    """``ring_attention`` alone on the reference's q, k, v (this rank's
    sequence chunk over the "sep" mesh): the output chunk and, from the
    reference's cotangent, the gradients of q, k and v."""
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    name = case["name"]
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    cp = case["cp"]
    mesh = build_mesh((cp,), ("sep",))
    mesh.device_mesh
    i, n = mesh.axis_index("sep"), npz["q"].shape[1] // cp
    q, k, v, do = (torch.from_numpy(npz[key][:, i * n:(i + 1) * n].copy())
                   for key in ("q", "k", "v", "do"))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = ring_attention(q, k, v, mesh, axis="sep", causal=case["causal"])
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    np.savez(os.path.join(root, f"{name}.r{rank}.npz"),
             o=o.detach().numpy(), dq=dq.numpy(), dk=dk.numpy(),
             dv=dv.numpy())


def run_build_case(case: dict, root: str, rank: int) -> None:
    """``make_sharded_train_step`` on the case's mesh, built and not
    run: the step's class, its pipeline (stages, microbatches, this
    rank's stage) and the shape of this rank's qkv_w block."""
    from paddle_tpu_torch.distributed.sharding import to_local

    cfg = GPTConfig(**case["cfg"], dtype=torch.float32)
    mesh = build_mesh(tuple(case["mesh"]), ("dp", "pp", "mp"))
    step, params, _ = make_sharded_train_step(cfg, mesh, device="cpu",
                                              **case["step"])
    pipe = step.pipe
    np.savez(os.path.join(root, f"{case['name']}.r{rank}.npz"),
             kind=np.asarray(type(step).__name__),
             pipe=np.asarray([pipe.n_stages, pipe.n_micro, pipe.stage]),
             qkv_w_local=np.asarray(
                 to_local(params["blocks"]["qkv_w"]).shape))


def run_transport_case(case: dict, root: str, rank: int) -> None:
    """``ppermute`` (a shift without wrap-around) and ``all_to_all_dim``
    over every rank, forward and backward, on tensors that name their
    rank: the values and gradients each rank ends with."""
    from paddle_tpu_torch.distributed.autograd_collectives import (
        all_to_all_dim, ppermute)

    mesh = build_mesh((case["n"],), ("x",))
    g = mesh.group("x")
    n = case["n"]
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = ppermute(x, g, [(i, i + 1) for i in range(n - 1)])
    (dx,) = torch.autograd.grad((y * (rank + 1)).sum(), x)
    # [B, T, h] held whole over T and split over h: rank r's heads
    a = (torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n, 3)
         + 100 * rank).requires_grad_(True)
    b = all_to_all_dim(a, 1, 2, g)
    (da,) = torch.autograd.grad((b * torch.arange(b.numel()).reshape(
        b.shape)).sum(), a)
    np.savez(os.path.join(root, f"{case['name']}.r{rank}.npz"),
             y=y.detach().numpy(), dx=dx.numpy(), b=b.detach().numpy(),
             da=da.numpy())


def run_topology_case(case: dict, root: str, rank: int) -> None:
    """A ``HybridCommunicateGroup`` over the case's five dims: each axis
    group's size and members, and this rank's coordinates."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import topology as tp

    hcg = tp.HybridCommunicateGroup(tp.CommunicateTopology(
        dims=case["dims"]))
    out = {}
    for name, g in (("dp", hcg.get_data_parallel_group()),
                    ("pp", hcg.get_pipe_parallel_group()),
                    ("sharding", hcg.get_sharding_parallel_group()),
                    ("sep", hcg.get_sep_parallel_group()),
                    ("mp", hcg.get_model_parallel_group()),
                    ("check", hcg.get_check_parallel_group())):
        out[f"{name}/nranks"] = np.asarray(g.nranks)
        out[f"{name}/ranks"] = np.asarray(g.ranks)
        pg = g.process_group
        out[f"{name}/pg_size"] = np.asarray(
            1 if pg is None else dist.get_world_size(pg))
        t = torch.ones(1)
        if pg is not None:
            dist.all_reduce(t, group=pg)
        out[f"{name}/sum"] = t.numpy()
    out["rank"] = np.asarray([hcg.get_global_rank(),
                              hcg.get_data_parallel_rank(),
                              hcg.get_stage_id(),
                              hcg.get_sharding_parallel_rank(),
                              hcg.get_sep_parallel_rank(),
                              hcg.get_model_parallel_rank()])
    np.savez(os.path.join(root, f"{case['name']}.r{rank}.npz"), **out)


def main() -> int:
    root = sys.argv[1]
    assert init_from_env(device="cpu"), "no launcher environment"
    import torch.distributed as dist

    rank = dist.get_rank()
    torch.set_num_threads(1)
    with open(os.path.join(root, "cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        kind = case.get("kind", "step")
        if kind == "step":
            run_step_case(case, root, rank)
        elif kind == "quant_allreduce":
            run_quant_case(case, root, rank)
        elif kind == "checkpoint":
            run_checkpoint_case(case, root, rank)
        elif kind == "pipeline":
            run_pipeline_case(case, root, rank)
        elif kind == "ring":
            run_ring_case(case, root, rank)
        elif kind == "transport":
            run_transport_case(case, root, rank)
        elif kind == "build":
            run_build_case(case, root, rank)
        elif kind == "topology":
            run_topology_case(case, root, rank)
        dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
