"""paddle_tpu_torch.distributed (the port's copy of the reference's
``paddle_tpu/distributed/``): the collective API on the port's
``Tensor`` (``collective``: each rank a process, the reference's global
results the concatenation of the ranks' blocks), the parallel
environment and ``DataParallel`` (``parallel``), ``spawn``, and the
fleet (``fleet``: the hybrid-parallel facade, the tensor-, sequence- and
segment-parallel Layers, recompute, the RNG tracker, the hybrid
optimizer; loaded on first use). Beside them the training runtime's
plane: the rendezvous store, format-v2 checkpoints that both packages
read, the comm and step watchdogs, the process launcher and elastic
supervision; sharded training's mesh (``process_mesh``), placements
(``placement``), ZeRO layouts (``sharding``) and autograd collectives
(``autograd_collectives``); and the hybrid topology (``topology``).
The auto-parallel names (``shard_tensor``, ``reshard``, ...) and
``compat.py`` are a later slice."""

from .collective import (Group, ReduceOp, Task, all_gather,
                         all_gather_object, all_reduce, alltoall,
                         alltoall_single, barrier, broadcast, get_group,
                         irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send)
from .parallel import (DataParallel, ParallelEnv, get_rank, get_world_size,
                       init_parallel_env, is_initialized)
from .placement import Partial, Placement, Replicate, Shard
from .process_mesh import ProcessMesh, build_mesh, get_mesh, set_mesh
from .topology import ParallelMode

__all__ = [
    # collectives
    "Group", "ReduceOp", "Task", "new_group", "get_group", "all_reduce",
    "all_gather", "all_gather_object", "reduce_scatter", "reduce",
    "broadcast", "scatter", "alltoall", "alltoall_single", "send", "recv",
    "isend", "irecv", "barrier",
    # environment
    "init_parallel_env", "get_rank", "get_world_size", "is_initialized",
    "ParallelEnv", "DataParallel", "spawn", "launch", "ParallelMode",
    # meshes and placements
    "Partial", "Placement", "Replicate", "Shard", "ProcessMesh",
    "build_mesh", "get_mesh", "set_mesh",
    "fleet",
]


def __getattr__(name):
    if name == "fleet":
        import importlib

        mod = importlib.import_module(".fleet", __name__)
        globals()["fleet"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _spawned(rank, func, args, nprocs, port, device):
    import os

    os.environ.update({"PADDLE_MASTER": f"127.0.0.1:{port}",
                       "PADDLE_TRAINERS_NUM": str(nprocs),
                       "PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_LOCAL_RANK": str(rank)})
    if device is not None:
        from ..core.device import set_device

        set_device(device)
    init_parallel_env(device=device)
    return func(*args)


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          device=None, **kwargs):
    """Start ``nprocs`` processes (one a card by default, at least one),
    each joining the world through ``init_parallel_env`` and running
    ``func(*args)`` (reference: python/paddle/distributed/spawn.py:463;
    the reference's single controller runs ``func`` once on the whole
    mesh). ``device`` is where each rank's tensors go ("cpu" for gloo
    ranks on the host). With ``join`` it returns once every rank has
    exited (None); without, torch.multiprocessing's context."""
    import torch
    import torch.multiprocessing as mp

    from .launch import _free_port

    if nprocs < 1:
        nprocs = max(1, torch.cuda.device_count())
    return mp.spawn(_spawned, args=(func, args, nprocs, _free_port(),
                                    device),
                    nprocs=nprocs, join=join)


def launch():
    from .launch import main

    return main()
