"""Communication groups and the eager collective API (the port's copy of
paddle_tpu/distributed/collective.py: ``Group``, ``new_group``,
``get_group``, ``ReduceOp``, ``Task`` and the collectives on the
reference's ``Tensor``).

A :class:`Group` is one or more named axes of a mesh (the port's
``process_mesh.Mesh``): the ranks that share this process's coordinates
on every other axis. Where the reference's single controller has no
process of its own in a group, here every rank is one: ``rank`` is this
process's index in its group (0 on rank 0 and in a one-process run, as
the reference returns), and ``process_group`` the ``torch.distributed``
group over those ranks, made the first time it is asked for (every rank
must ask in the same order, as for any new group; None for a group of
one rank).

**The correspondence rule.** The reference's tensors are global: a
tensor "sharded over dp" is one array, and rank r's part is the r-th
block of its sharded dim; XLA moves the blocks. Here rank r holds that
block alone, and a replicated tensor is a whole copy on every rank. So
the reference's result of a collective is the concatenation of the
ranks' results along the sharded dim, and a replicated result equals
each rank's:

- ``all_reduce`` of a replicated tensor sums n equal copies (the
  reference multiplies by n); of a sharded one, every rank gets the
  reduction of the blocks (the reference's blocks, each replaced by it);
- ``all_gather(t)`` concatenates the ranks' tensors along dim 0 (the
  reference's tensor made whole); ``all_gather(list, t)`` lists them;
- ``reduce_scatter`` of an [n k, ...] tensor leaves rank r the r-th
  [k, ...] block of the sum (the reference's dim-0-sharded result): 8
  identical [8, 2] tensors give rank r its row of 8s;
- ``broadcast`` from group rank ``src`` gives every rank src's tensor
  (the reference's block ``src`` repeated);
- ``scatter`` gives rank r the r-th tensor of src's list (the
  reference's concatenation, sharded over dim 0);
- ``alltoall_single`` sends rank r's j-th dim-0 chunk to rank j, which
  concatenates what arrives in rank order: the reference's [n n] block
  transpose of the global vector, rank r receiving column r;
- ``send`` / ``recv`` move a tensor from one rank to another (the
  reference pairs them in program order on one host).

``src`` and ``dst`` are ranks in the group, as the reference's (its
index into the group's blocks). Each collective takes the port's
``Tensor`` (or a torch tensor) and works in place where the reference
does. ``sync_op=False`` returns a pending :class:`Task`; ``wait()`` ends
it. ``AVG`` is a sum divided by n. Over gloo (ranks that share a card:
NCCL refuses two ranks on one device) the collectives hand CUDA tensors
to gloo, which copies them through the host itself; ``send`` / ``recv``
would hand its sockets a device pointer, so there the tensor travels
through pinned host memory explicitly, counted with the pipeline's
copies in ``autograd_collectives.ppermute.staged_copies`` /
``staged_bytes``. ``chip_smoke.py``'s phase ``dp_mp`` runs every
collective of this module on CUDA tensors over gloo, the split
all-to-all with uneven splits included. A collective that fails raises;
nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .autograd_collectives import _note_staged
from .process_mesh import Mesh, build_mesh, this_rank

__all__ = ["Group", "ReduceOp", "Task", "new_group", "get_group",
           "all_reduce", "all_gather", "all_gather_object",
           "reduce_scatter", "reduce", "broadcast", "scatter", "alltoall",
           "alltoall_single", "send", "recv", "isend", "irecv", "barrier"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communicator over the named mesh axes ``axis_names``;
    ``nranks`` is the product of their sizes."""

    def __init__(self, mesh: Mesh, axis_names: Sequence[str], gid: int = 0,
                 name: str = ""):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.id = gid
        self.name = name or f"group_{'_'.join(self.axis_names)}"
        self._pg = None

    @property
    def nranks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axis_names]))

    @property
    def world_size(self) -> int:
        return self.nranks

    def _members(self) -> np.ndarray:
        """[groups, nranks]: the mesh's ranks with the group's axes last,
        one row a group (row-major over the group's axes)."""
        names = self.mesh.axis_names
        mine = [names.index(a) for a in self.axis_names]
        rest = [i for i in range(len(names)) if i not in mine]
        return np.transpose(self.mesh.devices, rest + mine).reshape(
            -1, self.nranks)

    @property
    def ranks(self) -> list:
        """The global ranks of this process's group, in group order."""
        rows = self._members()
        return [int(r) for r in rows[np.argwhere(rows == this_rank())[0][0]]]

    @property
    def rank(self) -> int:
        """This process's index in its group."""
        return self.ranks.index(this_rank())

    def is_member(self) -> bool:
        return this_rank() in self.ranks

    def get_group_rank(self, rank: int) -> int:
        """The index of global ``rank`` in this process's group; -1 if
        it is not in it."""
        ranks = self.ranks
        return ranks.index(rank) if rank in ranks else -1

    @property
    def process_group(self):
        """The ``torch.distributed`` group of this process's group
        (None: one rank)."""
        if self.nranks == 1:
            return None
        if self._pg is None:
            if len(self.axis_names) == 1:
                self._pg = self.mesh.group(self.axis_names[0])
            else:
                import torch.distributed as dist

                self.mesh.device_mesh           # the axes' groups first
                self._pg, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in self._members()])
        return self._pg

    def __repr__(self):
        return f"Group(axes={self.axis_names}, nranks={self.nranks})"


_GROUPS: dict = {}
_NEXT_GID = [1]


def _default_mesh() -> Mesh:
    """The hybrid topology's mesh where one is set, else one axis over
    the joined group's ranks (one rank without a group)."""
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.mesh
    import torch.distributed as dist

    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    return build_mesh((n,), ("world",))


def new_group(ranks=None, backend=None, axis_names=None,
              mesh: Optional[Mesh] = None) -> Group:
    """A communicator over mesh axes: ``axis_names`` of ``mesh`` (by
    default the hybrid topology's mesh, or one axis over every rank);
    every axis of the mesh without ``axis_names``. As the reference's,
    groups are mesh-axis aligned: ``ranks`` and ``backend`` are accepted
    for the signature and not read."""
    mesh = mesh if mesh is not None else _default_mesh()
    axis_names = tuple(axis_names) if axis_names else tuple(mesh.axis_names)
    g = Group(mesh, axis_names, gid=_NEXT_GID[0])
    _NEXT_GID[0] += 1
    _GROUPS[g.id] = g
    return g


def get_group(gid: int) -> Optional[Group]:
    return _GROUPS.get(gid)


# ---------------------------------------------------------------------------
# Eager collectives
# ---------------------------------------------------------------------------

class Task:
    """A collective's handle (reference: ProcessGroup::Task). ``wait()``
    waits for the ``torch.distributed`` work (none: already done), then
    finishes the result (the host copy back, the average's divide) and
    returns it."""

    def __init__(self, result, works=(), finish=None,
                 name: str = "collective"):
        self._result = result
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._name = name

    def wait(self):
        from .comm_watchdog import comm_task_manager

        if self._works or self._finish is not None:
            tid = comm_task_manager.register(self._name)
            try:
                for w in self._works:
                    w.wait()
                self._works = []
                if self._finish is not None:
                    finish, self._finish = self._finish, None
                    finish()
            finally:
                comm_task_manager.complete(tid)
        return self._result

    def is_completed(self) -> bool:
        return not self._works and self._finish is None


def _resolve(group: Optional[Group]) -> Group:
    if group is not None:
        return group
    from . import parallel

    return parallel._ensure_default_group()


def _pg(g: Group):
    """The process group ``g``'s collectives run over: its own, or, for
    a group of one rank in a joined world of one rank, the world's (a
    copy through the backend, so that one rank exercises it too); None
    runs them as the identity."""
    pg = g.process_group
    if pg is None and g.nranks == 1:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() == 1:
            return dist.group.WORLD
    return pg


def _torch(t) -> torch.Tensor:
    return t._data if hasattr(t, "_data") else t


def _wrap(data, like=None):
    from ..core.tensor import Tensor

    if like is not None and not isinstance(like, Tensor):
        return data
    return Tensor(data, stop_gradient=True)


def _global(pg, group_rank: int) -> int:
    import torch.distributed as dist

    return dist.get_global_rank(pg, group_rank)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (counted)."""
    h = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    h.copy_(t)
    _note_staged(h)
    return h


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=True)


def _back(dst: torch.Tensor, h: torch.Tensor) -> None:
    _note_staged(h)
    dst.copy_(h)


def _torch_op(op: str):
    import torch.distributed as dist

    ops = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
           ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
           ReduceOp.PROD: dist.ReduceOp.PRODUCT}
    if op not in ops:
        raise ValueError(f"unknown reduce op {op!r}")
    return ops[op]


def _average(buf: torch.Tensor, op: str, n: int) -> None:
    if op == ReduceOp.AVG:
        if buf.is_floating_point() or buf.is_complex():
            buf.div_(n)
        else:
            buf.copy_(torch.div(buf, n, rounding_mode="trunc"))


def _done(result, works, finish, name, sync_op):
    task = Task(result, works, finish, name)
    if sync_op:
        task.wait()
    return task


def _write(tensor, data: torch.Tensor) -> None:
    """``data`` into ``tensor`` in place (same shape), else rebinds it."""
    d = _torch(tensor)
    if d.shape == data.shape and d.dtype == data.dtype:
        with torch.no_grad():
            d.copy_(data)
    else:
        tensor._bump(data)


def all_reduce(tensor, op: str = ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True) -> Task:
    """Reduce ``tensor`` over the group's ranks, in place on every rank
    (reference communication/all_reduce.py:29)."""
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    d = _torch(tensor)
    if pg is None:
        return Task(tensor, name="all_reduce")
    buf = d.detach()
    inplace = buf.is_contiguous()
    if not inplace:
        buf = buf.contiguous()
    work = dist.all_reduce(buf, op=_torch_op(op), group=pg, async_op=True)

    def finish():
        _average(buf, op, g.nranks)
        if not inplace:
            with torch.no_grad():
                d.copy_(buf)

    return _done(tensor, [work], finish, "all_reduce", sync_op)


def all_gather(tensor_list, tensor=None, group: Optional[Group] = None,
               sync_op: bool = True) -> Task:
    """AllGather (reference communication/all_gather.py). Two forms:
    ``all_gather(out_list, t)`` appends every rank's ``t`` to
    ``out_list`` in group order; ``all_gather(t)``'s task returns the
    ranks' tensors concatenated along dim 0 (the reference's tensor made
    whole)."""
    import torch.distributed as dist

    g = _resolve(group)
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    d = _torch(tensor).detach().contiguous()
    shape = tuple(d.shape)
    x = d.reshape(1) if d.dim() == 0 else d
    pg = _pg(g)
    n = g.nranks
    # the ranks' tensors one after another along dim 0
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=d.dtype, device=d.device)
    works = []
    if pg is None:
        out.copy_(x)
    else:
        works.append(dist.all_gather_into_tensor(out, x, group=pg,
                                                 async_op=True))
    if tensor_list is not None:
        def finish():
            tensor_list.extend(_wrap(p.reshape(shape).clone(), tensor)
                               for p in out.chunk(n))

        return _done(tensor_list, works, finish, "all_gather", sync_op)
    return _done(_wrap(out, tensor), works, None, "all_gather", sync_op)


def all_gather_object(obj_list, obj, group: Optional[Group] = None):
    """Every rank's ``obj``, in group order, appended to ``obj_list``."""
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    if pg is None:
        obj_list.append(obj)
        return
    got = [None] * g.nranks
    dist.all_gather_object(got, obj, group=pg)
    obj_list.extend(got)


def reduce_scatter(tensor, tensor_or_tensor_list=None,
                   op: str = ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True) -> Task:
    """ReduceScatter (reference communication/reduce_scatter.py): the
    input (``tensor_or_tensor_list``, a tensor or a list concatenated
    along dim 0; ``tensor`` itself without it) is reduced over the group
    and rank r keeps its r-th dim-0 block, written into ``tensor`` when
    an input is given, else the task's result."""
    import torch.distributed as dist

    g = _resolve(group)
    src = tensor if tensor_or_tensor_list is None else tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        x = torch.cat([_torch(t).detach() for t in src], 0)
    else:
        x = _torch(src).detach().contiguous()
    n = g.nranks
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} is not "
                         f"a multiple of {n} ranks")
    pg = _pg(g)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    works = []
    if pg is None:
        out.copy_(x)
    else:
        works.append(dist.reduce_scatter_tensor(out, x, op=_torch_op(op),
                                                group=pg, async_op=True))
    into = tensor_or_tensor_list is not None
    result = tensor if into else _wrap(out, tensor)

    def finish():
        _average(out, op, n)
        if into:
            _write(tensor, out)

    return _done(result, works, finish, "reduce_scatter", sync_op)


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """Reduce over the group into group rank ``dst``'s ``tensor``; the
    other ranks' tensors are left as they were."""
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    if pg is None:
        return Task(tensor, name="reduce")
    d = _torch(tensor)
    # a copy: gloo leaves partial sums in the other ranks' buffers
    buf = d.detach().contiguous().clone()
    work = dist.reduce(buf, _global(pg, dst), op=_torch_op(op), group=pg,
                       async_op=True)
    mine = g.rank == dst

    def finish():
        if mine:
            _average(buf, op, g.nranks)
            with torch.no_grad():
                d.copy_(buf)

    return _done(tensor, [work], finish, "reduce", sync_op)


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True) -> Task:
    """Every rank's ``tensor`` becomes group rank ``src``'s, in place."""
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    if pg is None:
        return Task(tensor, name="broadcast")
    d = _torch(tensor)
    buf = d.detach()
    inplace = buf.is_contiguous()
    if not inplace:
        buf = buf.contiguous()
    work = dist.broadcast(buf, _global(pg, src), group=pg, async_op=True)

    def finish():
        if not inplace:
            with torch.no_grad():
                d.copy_(buf)

    return _done(tensor, [work], finish, "broadcast", sync_op)


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """Rank r's ``tensor`` becomes the r-th of group rank ``src``'s
    ``tensor_list`` (read on ``src`` only)."""
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    d = _torch(tensor)
    if pg is None:
        if tensor_list is not None:
            _write(tensor, _torch(tensor_list[0]).detach())
        return Task(tensor, name="scatter")
    me = g.rank == src
    if me and (tensor_list is None or len(tensor_list) != g.nranks):
        raise ValueError(f"scatter: the source needs a list of {g.nranks} "
                         "tensors")
    out = torch.empty_like(d.detach())
    parts = [_torch(t).detach().contiguous() for t in tensor_list] \
        if me else None
    work = dist.scatter(out, parts, src=_global(pg, src), group=pg,
                        async_op=True)

    def finish():
        _write(tensor, out)

    return _done(tensor, [work], finish, "scatter", sync_op)


def alltoall(out_tensor_list, in_tensor_list=None,
             group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """AllToAll (reference communication/all_to_all.py): the j-th tensor
    of rank r's ``in_tensor_list`` goes to rank j, whose output list
    holds, at position r, what rank r sent it. With one list argument
    the task returns the output list."""
    g = _resolve(group)
    if in_tensor_list is None:
        in_tensor_list, out_tensor_list = out_tensor_list, None
    ins = [_torch(t).detach().contiguous() for t in in_tensor_list]
    n = g.nranks
    if len(ins) != n:
        raise ValueError(f"alltoall: {len(ins)} tensors for {n} ranks")
    shape = ins[0].shape
    if any(t.shape != shape for t in ins):
        raise ValueError("alltoall: the tensors of the list differ in shape")
    flat = torch.stack(ins, 0)
    task = alltoall_single(flat, group=g, sync_op=False)
    like = in_tensor_list[0]

    def finish():
        got = task.wait()
        outs = [_wrap(got[i].clone(), like) for i in range(n)]
        if out_tensor_list is not None:
            out_tensor_list.extend(outs)
        else:
            result[:] = outs

    result = out_tensor_list if out_tensor_list is not None else []
    return _done(result, [], finish, "alltoall", sync_op)


def alltoall_single(tensor, output=None, in_split_sizes=None,
                    out_split_sizes=None, group: Optional[Group] = None,
                    sync_op: bool = True) -> Task:
    """All-to-all on one tensor (reference alltoall_single, :469): rank
    r's dim 0, split by ``in_split_sizes`` (equal parts by default),
    sends its j-th chunk to rank j, which concatenates the chunks it
    receives in rank order (``out_split_sizes`` rows from each). Written
    into ``output`` when given, else the task's result."""
    import torch.distributed as dist

    g = _resolve(group)
    x = _torch(tensor).detach().contiguous()
    n = g.nranks
    ins = list(in_split_sizes) if in_split_sizes is not None else None
    outs = list(out_split_sizes) if out_split_sizes is not None else None
    if ins is None and x.shape[0] % n:
        raise ValueError(f"alltoall_single: dim 0 of {tuple(x.shape)} is "
                         f"not a multiple of {n} ranks")
    rows = sum(outs) if outs is not None else (
        x.shape[0] if ins is None else None)
    if rows is None:
        raise ValueError("alltoall_single: out_split_sizes is needed with "
                         "in_split_sizes")
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    pg = _pg(g)
    works = []
    if pg is None:
        out.copy_(x)
    else:
        works.append(dist.all_to_all_single(out, x, outs, ins, group=pg,
                                            async_op=True))
    result = output if output is not None else _wrap(out, tensor)

    def finish():
        if output is not None:
            _write(output, out)

    return _done(result, works, finish, "alltoall_single", sync_op)


def _p2p(tensor, peer: int, group, recv: bool, sync_op: bool) -> Task:
    import torch.distributed as dist

    g = _resolve(group)
    pg = _pg(g)
    if pg is None:
        raise ValueError("send / recv need a group of more than one rank")
    d = _torch(tensor)
    buf = d.detach().contiguous()
    name = "recv" if recv else "send"
    host = None
    if buf.is_cuda and dist.get_backend(pg) == "gloo":
        # gloo's point-to-point hands its socket a device pointer (the
        # sending rank aborts); its collectives take CUDA tensors
        host = _host_like(buf) if recv else _host(buf)
    fn = dist.irecv if recv else dist.isend
    work = fn(buf if host is None else host, _global(pg, peer), group=pg)

    def finish():
        if recv:
            if host is not None:
                _back(buf, host)
            if buf.data_ptr() != d.data_ptr():
                with torch.no_grad():
                    d.copy_(buf)

    return _done(tensor, [work], finish, name, sync_op)


def send(tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> Task:
    """Send ``tensor`` to group rank ``dst``."""
    return _p2p(tensor, dst, group, recv=False, sync_op=sync_op)


def recv(tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> Task:
    """Receive group rank ``src``'s tensor into ``tensor``."""
    return _p2p(tensor, src, group, recv=True, sync_op=sync_op)


def isend(tensor, dst: int = 0, group: Optional[Group] = None) -> Task:
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src: int = 0, group: Optional[Group] = None) -> Task:
    return recv(tensor, src, group, sync_op=False)


def barrier(group: Optional[Group] = None) -> None:
    """Wait for this rank's device work, then for every rank of the
    group."""
    import torch.distributed as dist

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    g = _resolve(group)
    pg = _pg(g)
    if pg is not None:
        dist.barrier(group=pg)
