"""Worker of the sharded-step tests: one gloo rank of the port's
``make_sharded_train_step``, started by the port's launcher
(``paddle_tpu_torch.distributed.launch.launch_procs``).

    python tests/torch_sharded_worker.py DIR

``DIR/cases.json`` lists the cases; for each, ``DIR/<name>.in.npz``
holds the JAX package's initial parameters and AdamW state and the
global batch. The rank runs the case's steps from that state on the
case's mesh and writes ``DIR/<name>.r<rank>.npz``: its losses and, on
every rank, the whole parameters (reference order) gathered from the
blocks. A case with ``count`` also writes how many times the forward
called each training kernel's wrapper (``KERNELS``; on the CPU they
run their plain versions), and ``ce_kernels`` routes the cross-entropy
through K4/K5's wrappers on the CPU too, where the model keeps them to
CUDA. A case of kind ``quant_allreduce`` runs ``dist_allreduce_quant``
on the case's inputs instead; kind ``checkpoint`` saves and loads a
sharded state (tests/test_torch_sharded_checkpoint.py).
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

    counts, saved = {}, []
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
        params = params_from_jax(_tensors(unpack(npz, "params")), "cpu",
                                 mesh=mesh, cfg=cfg)
        opt = opt_state_from_jax(_tensors(unpack(npz, "opt")), "cpu",
                                 mesh=mesh, cfg=cfg,
                                 zero1=case["step"].get("zero1", True))
        if case.get("zero3"):
            params = {k: _map(lambda a: shard_array_over(a, mesh, "dp"), v)
                      for k, v in params.items()}
        tok, lab = npz["tokens"], npz["labels"]
        losses = []
        with counting_kernels(case) as counts:
            for _ in range(case["steps"]):
                loss, params, opt = step(params, opt, tok, lab)
                losses.append(loss.item())
    finally:
        GLOBAL_FLAGS.set("dist_allreduce_quant", False)
    out = pack(gather_tree(params, mesh), "params", {})
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
        dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
