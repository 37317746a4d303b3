"""The parallel environment and ``DataParallel`` (the port's copy of
paddle_tpu/distributed/parallel.py).

``init_parallel_env`` joins the launcher's world (``launch.py::
init_from_env``: gloo for CPU tensors; on the card nccl when each rank
has a card of its own, gloo when ranks share one) and builds the hybrid
topology from ``mesh_dims`` over it, as the reference's does over its
devices.

The reference's ``DataParallel`` keeps one logical copy of every
parameter and lets XLA reduce the gradients of its dp-sharded batch.
Here each rank is a process with a copy of its own, so the wrapper does
what Paddle's EagerReducer does (reference's ancestor
fluid/distributed/collective/reducer.h:88): at wrap time it broadcasts
parameters and buffers from the group's rank 0; a hook on every
trainable leaf (but an MoE expert that the group's ranks hold apart:
``held_apart``), run when its gradient is accumulated, fills buckets of
``comm_buffer_size`` MB (the last, holding the first registered leaves,
of ``last_comm_buffer_size``), and a full bucket's flat gradient is
all-reduced asynchronously, in bucket order on every rank; a callback
queued on the autograd engine waits for every bucket, divides by the
group's size and writes the average back into each ``.grad`` before
``backward()`` returns. Averaging is Paddle's rule: for a mean-reduced
loss over equal per-rank batches it is the gradient of the loss over
the global batch, which is what the reference computes; for a
sum-reduced loss the reference's gradient is dp times Paddle's (ROADMAP
Queue 3, defect J).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from .collective import Group, _pg, all_reduce, broadcast
from .topology import (HYBRID_AXES, CommunicateTopology,
                       HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "DataParallel",
           "MetaParallelBase"]

_DEFAULT_GROUP: Optional[Group] = None
_ALIAS = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
          "mp": "model"}


def _ensure_default_group() -> Group:
    if _DEFAULT_GROUP is None:
        init_parallel_env()
    return _DEFAULT_GROUP


def is_initialized() -> bool:
    return _DEFAULT_GROUP is not None


def _join(device=None) -> int:
    """Join the launcher's world if the process has not; its size (1
    without a launcher)."""
    import torch.distributed as dist

    from .launch import init_from_env

    if not (dist.is_available() and dist.is_initialized()):
        if device is None:
            from ..core.device import get_device

            device = "cpu" if get_device() == "cpu" else "cuda"
        init_from_env(device)
    return dist.get_world_size() if dist.is_initialized() else 1


def init_parallel_env(mesh_dims: Optional[dict] = None,
                      device=None) -> Group:
    """Join the world and set the hybrid topology. ``mesh_dims`` maps an
    axis (short or long name) to its degree, e.g. ``{"dp": 2, "mp":
    2}``; the others are 1, and without ``mesh_dims`` dp takes every
    rank. The degrees' product must be the world's size: every rank is
    a process of its own. Returns the default group (every axis)."""
    global _DEFAULT_GROUP
    if _DEFAULT_GROUP is not None and mesh_dims is None:
        return _DEFAULT_GROUP
    world = _join(device)
    degrees = {n: 1 for n in HYBRID_AXES}
    if mesh_dims:
        for k, v in mesh_dims.items():
            degrees[_ALIAS.get(k, k)] = int(v)
        used = int(np.prod(list(degrees.values())))
        if used != world:
            raise ValueError(f"mesh {degrees} needs {used} ranks, the world "
                             f"has {world}")
    else:
        degrees["data"] = world
    hcg = HybridCommunicateGroup(CommunicateTopology(
        HYBRID_AXES, [degrees[n] for n in HYBRID_AXES]))
    set_hybrid_communicate_group(hcg)
    _DEFAULT_GROUP = Group(hcg.mesh, tuple(hcg.mesh.axis_names), gid=0,
                           name="default")
    return _DEFAULT_GROUP


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank (in ``group`` when given); 0 in a one-process
    run, as the reference's single controller answers."""
    from .process_mesh import this_rank

    return this_rank() if group is None else group.rank


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    if _DEFAULT_GROUP is not None:
        return _DEFAULT_GROUP.nranks
    import torch.distributed as dist

    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


class ParallelEnv:
    """reference: python/paddle/base/dygraph/parallel_helper ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else 0

    dev_id = device_id


def held_apart(p, group) -> bool:
    """Whether the ranks of ``group`` hold different copies of ``p``: an
    MoE expert (``moe_group`` set by ``MoELayer``) whose moe group spans
    ``group``. Such a leaf is neither broadcast nor averaged over
    ``group``. An expert whose moe group meets ``group`` in this rank
    alone (a moe group over mp, ``group`` the dp group) is replicated
    over ``group``, and synced as any parameter. A moe group that holds
    some of ``group``'s ranks but not all is refused: its experts would
    be averaged over a subgroup, which nothing here builds."""
    moe = getattr(p, "moe_group", None)
    if moe is None:
        return False
    ranks, mine = set(group.ranks), set(moe.ranks)
    if ranks <= mine:
        return True
    if len(ranks & mine) == 1:
        return False
    raise ValueError(
        f"an MoE expert of moe group {sorted(mine)} under group "
        f"{sorted(ranks)}: the moe group must hold all of the group's "
        f"ranks (experts apart) or only this rank of it (experts "
        f"replicated)")


def broadcast_parameters(layers, group, distributed_too: bool) -> None:
    """Every parameter (the ``is_distributed`` ones only with
    ``distributed_too``; never one the group's ranks hold apart) and
    buffer of ``layers`` from ``group``'s rank 0 to its other ranks: one
    logical copy, as the reference's."""
    if _pg(group) is None:
        return
    for p in layers.parameters():
        if held_apart(p, group):
            continue
        if distributed_too or not getattr(p, "is_distributed", False):
            broadcast(p, src=0, group=group)
    for b in layers.buffers():
        if b is not None:
            broadcast(b, src=0, group=group)


class MetaParallelBase:
    """What the parallel model wrappers share (``DataParallel`` and the
    fleet's meta-parallel ones): the call and the wrapped Layer's
    surface."""

    def __init__(self, layers, hcg, strategy=None):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    def __getattr__(self, name):
        if name == "_layers":
            raise AttributeError(name)
        return getattr(self._layers, name)


class _Bucket:
    __slots__ = ("params", "ready", "work", "flat", "nbytes")

    def __init__(self, params):
        self.params = params
        self.ready = set()
        self.work = None
        self.flat = None
        self.nbytes = sum(p._data.numel() * p._data.element_size()
                          for p in params)


def _buckets(params, comm_mb: float, last_mb: float) -> list:
    """Buckets in registration order, a dtype at a time: the first of a
    dtype up to ``last_mb`` MB, the others up to ``comm_mb`` (a bucket
    closes once it reaches its size); returned in reverse, the order the
    backward fills them."""
    open_, out, first = {}, [], set()
    for p in params:
        dt = p._data.dtype
        b = open_.setdefault(dt, [])
        b.append(p)
        limit = comm_mb if dt in first else last_mb
        if sum(q._data.numel() * q._data.element_size()
               for q in b) >= limit * 2 ** 20:
            out.append(b)
            first.add(dt)
            open_[dt] = []
    out.extend(b for b in open_.values() if b)
    return [_Bucket(b) for b in reversed(out)]


class DataParallel(MetaParallelBase):
    """Data-parallel model wrapper (reference: distributed/parallel.py:123;
    Paddle's distributed/parallel.py:219 with its EagerReducer).

    ``stats`` counts, since the last reset: ``steps`` (synced
    backwards), ``allreduce_bytes`` and ``allreduce_calls`` (the
    buckets' all-reduces) and ``wait_ms`` (host time spent waiting for
    them in the backward's callback)."""

    def __init__(self, layers, strategy=None, comm_buffer_size: float = 25,
                 last_comm_buffer_size: float = 1,
                 find_unused_parameters: bool = False,
                 group: Optional[Group] = None):
        hcg = get_hybrid_communicate_group()
        super().__init__(layers, hcg, strategy)
        self.group = group or (hcg.get_data_parallel_group()
                               if hcg is not None else
                               _ensure_default_group())
        self.find_unused_parameters = find_unused_parameters
        self._pg = _pg(self.group)
        self._grad_sync_enabled = True
        self._pending = False
        self.stats = {"steps": 0, "allreduce_bytes": 0, "allreduce_calls": 0,
                      "wait_ms": 0.0}
        broadcast_parameters(layers, self.group, distributed_too=True)
        self._params = [p for p in layers.parameters()
                        if not p.stop_gradient
                        and not held_apart(p, self.group)]
        self._buckets = _buckets(self._params, comm_buffer_size,
                                 last_comm_buffer_size)
        self._where = {}
        for i, b in enumerate(self._buckets):
            for p in b.params:
                self._where[id(p)] = i
        self._next = 0
        self._hooked = {}
        self._register_hooks()

    def _register_hooks(self) -> None:
        """A post-accumulate hook on each leaf's current buffer (the
        optimizers write in place; a leaf rebound since, by ``set_value``
        of another shape or an AMP cast, is hooked again)."""
        for p in self._params:
            d = p._data
            if self._hooked.get(id(p)) is d:
                continue
            d.register_post_accumulate_grad_hook(
                lambda t, p=p: self._ready(p))
            self._hooked[id(p)] = d

    # -- the backward ----------------------------------------------------------
    def _ready(self, p) -> None:
        if not self._grad_sync_enabled or self._pg is None:
            return
        if not self._pending:
            self._pending = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        b = self._buckets[self._where[id(p)]]
        b.ready.add(id(p))
        self._launch_ready()

    def _launch(self, b: _Bucket) -> None:
        grads = []
        for p in b.params:
            g = p._data.grad
            grads.append(torch.zeros_like(p._data).reshape(-1) if g is None
                         else g.detach().reshape(-1))
        b.flat = torch.cat(grads)
        b.work = all_reduce(b.flat, group=self.group, sync_op=False)
        self.stats["allreduce_bytes"] += b.nbytes
        self.stats["allreduce_calls"] += 1

    def _launch_ready(self) -> None:
        """Launch the full buckets in bucket order (every rank issues its
        all-reduces in the same order, whatever order its gradients came
        in)."""
        while self._next < len(self._buckets):
            b = self._buckets[self._next]
            if len(b.ready) < len(b.params):
                return
            self._launch(b)
            self._next += 1

    def _finish(self) -> None:
        t0 = time.perf_counter()
        try:
            missing = [p for b in self._buckets[self._next:]
                       for p in b.params if id(p) not in b.ready]
            if missing and not self.find_unused_parameters:
                raise RuntimeError(
                    f"DataParallel: {len(missing)} trainable parameters got "
                    "no gradient in this backward; pass "
                    "find_unused_parameters=True to sync them as zeros")
            for b in self._buckets[self._next:]:
                self._launch(b)
            n = self.group.nranks
            for b in self._buckets:
                b.work.wait()
                b.flat.div_(n)
                off = 0
                for p in b.params:
                    d = p._data
                    k = d.numel()
                    avg = b.flat[off:off + k].view(d.shape)
                    if d.grad is None:
                        d.grad = avg.clone()
                    else:
                        d.grad.copy_(avg)
                    off += k
            self.stats["steps"] += 1
        finally:
            self._reset()
            self.stats["wait_ms"] += (time.perf_counter() - t0) * 1e3

    def _reset(self) -> None:
        self._pending = False
        self._next = 0
        for b in self._buckets:
            b.ready.clear()
            b.work = b.flat = None

    # -- the user's calls ------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        if self._pending:               # a backward that never finished
            self._reset()
        self._register_hooks()
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside accumulate gradients locally; the next synced
        backward all-reduces the accumulated sums."""
        old = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = old

    def scale_batch(self, t):
        """This rank's dim-0 block of a global batch (``t`` a Tensor or an
        array; the reference shards dim 0 over dp)."""
        from ..core.tensor import Tensor, as_torch

        n, r = self.group.nranks, self.group.rank
        data = t._data if isinstance(t, Tensor) else as_torch(t)
        if data.shape[0] % n:
            raise ValueError(f"scale_batch: dim 0 of {tuple(data.shape)} is "
                             f"not a multiple of {n} ranks")
        k = data.shape[0] // n
        block = data[r * k:(r + 1) * k]
        if isinstance(t, Tensor):
            return Tensor(block, stop_gradient=t.stop_gradient)
        return Tensor(block)
