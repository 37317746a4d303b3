"""Collectives on the autograd tape, and the int8-wire all-reduce (the
port's copy of paddle_tpu/distributed/autograd_collectives.py).

The sharded training step computes on each rank's blocks and moves data
between ranks with explicit collectives. Each one here is a
``torch.autograd.Function`` whose backward is its forward's adjoint
(all-reduce <-> all-reduce, all-gather <-> reduce-scatter), so that a
rank's gradient is that of the sum over ranks of their objectives: the
step gives each rank the part of the global loss its own tokens carry,
and no Megatron-style identity regions are needed. Every function is the
identity when its group is None (an axis of one rank).

The fleet's tensor-parallel Layers are Megatron's instead: every mp rank
repeats the computation around a parallel product, so a collective's
backward is the transpose for that repeated computation (Paddle's mp
ops): ``c_identity`` passes its input and sums the gradient over the
group, ``mp_allreduce`` sums and passes the gradient, ``c_split`` keeps
this rank's block and all-gathers the gradient, ``c_concat``
all-gathers and keeps the gradient's block. Every all-reduce of the
module goes through ``_reduce``.

``ppermute`` is the transport of the pipeline and of ring attention
(the counterpart of ``lax.ppermute``): each rank of a group sends to the
rank a permutation names and receives from the rank that names it, all
of it posted at once (``batch_isend_irecv``), so that neighbours never
wait on each other's blocking pair. Gloo moves no device memory point
to point: on a gloo group a CUDA tensor is copied to the host, sent,
received on the host and copied back, and ``ppermute.staged_copies`` /
``ppermute.staged_bytes`` count those copies. The group's backend
decides the path, never a failure. ``all_to_all_dim`` moves a tensor
from one split dim to another (ring attention's heads <-> sequence).

``reshard_op``, ``scatter_axis`` and ``gather_axis`` act on the
reference's ``Tensor`` and come with the Paddle API slice.
"""

from __future__ import annotations

import torch

__all__ = ["dist_allreduce_quant", "QUANT_SYNC_PP_REFUSAL",
           "all_reduce_sum", "all_gather_dim", "reduce_scatter_dim",
           "c_identity", "mp_allreduce", "c_split", "c_concat",
           "ppermute", "all_to_all_dim"]

# the reference's message, word for word: make_sharded_train_step raises
# it for dist_allreduce_quant on a pp > 1 mesh
QUANT_SYNC_PP_REFUSAL = ("dist_allreduce_quant does not support pp>1 "
                         "meshes; use a dp(*mp) mesh or disable the flag")


def _world(group) -> int:
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, on every rank."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order."""
    return x if group is None else _AllGatherDim.apply(x, dim, group)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum over the group."""
    return x if group is None else _ReduceScatterDim.apply(x, dim, group)


def _group_rank(group) -> int:
    import torch.distributed as dist

    return dist.get_group_rank(group, dist.get_rank())


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, _group_rank(group) * k, k).contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


def c_identity(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over the group (the input of a
    column-parallel product)."""
    return x if group is None else _CIdentity.apply(x, group)


def mp_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks; the gradient passed as it is (the
    partial outputs of a row-parallel product)."""
    return x if group is None else _MpAllReduce.apply(x, group)


def c_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim``; the gradient all-gathered."""
    return x if group is None else _CSplit.apply(x, dim % x.dim(), group)


def c_concat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``; this rank's block of
    the gradient."""
    return x if group is None else _CConcat.apply(x, dim % x.dim(), group)




def _send_recv(x: torch.Tensor, group, perm, tag: int = 0) -> torch.Tensor:
    """The raw permutation (no autograd): ``perm`` lists (source, dest)
    pairs of group ranks; a rank that no pair sends to gets zeros."""
    import torch.distributed as dist

    me = _group_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {me} appears twice in {perm}")
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    out = torch.zeros(x.shape, dtype=x.dtype,
                      device="cpu" if staged else x.device)
    if not dst and not src:
        return out.to(x.device)
    ops = []
    if dst:
        buf = x.detach().contiguous()
        if staged:
            buf = buf.cpu()
            _note_staged(buf)
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, dst[0]), group,
                              tag))
    if src:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src[0]), group,
                              tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    ppermute.sends += len(dst)
    if staged:
        if src:
            _note_staged(out)
        out = out.to(x.device)
    return out


def _note_staged(t: torch.Tensor) -> None:
    ppermute.staged_copies += 1
    ppermute.staged_bytes += t.numel() * t.element_size()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, tag):
        ctx.group, ctx.perm, ctx.tag = group, perm, tag
        return _send_recv(x, group, perm, tag)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _send_recv(g, ctx.group, back, ctx.tag), None, None, None


def ppermute(x: torch.Tensor, group, perm, tag: int = 0) -> torch.Tensor:
    """``lax.ppermute`` over a process group: ``perm`` is a list of
    (source, dest) pairs of group ranks; every rank of the group calls
    it with the same ``perm``. A rank receives the tensor of the pair
    that names it as dest, zeros where none does. The backward is the
    reverse permutation. Counts ``ppermute.sends`` (tensors this rank
    sent) and, on gloo with CUDA tensors, the host copies."""
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, [tuple(p) for p in perm], tag)


ppermute.sends = ppermute.staged_copies = ppermute.staged_bytes = 0


def _all_to_all(x: torch.Tensor, split: int, cat: int, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    parts = x.movedim(split, 0)
    parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:]))
    src = parts.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    # out[i]: rank i's block of this rank's part of ``split``; put the
    # blocks side by side along ``cat``
    out = out.movedim(1, split + 1)            # [n, ... split dim back ...]
    return torch.cat(list(out), dim=cat).contiguous()


class _AllToAllDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, cat, group):
        ctx.split, ctx.cat, ctx.group = split, cat, group
        return _all_to_all(x, split, cat, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.cat, ctx.split, ctx.group), None, None, \
            None


def all_to_all_dim(x: torch.Tensor, split: int, cat: int, group):
    """Split ``x`` along ``split`` into one block a rank, send block i to
    rank i, and concatenate what arrives along ``cat`` in rank order:
    a tensor held whole along ``split`` and split along ``cat`` comes out
    split along ``split`` and whole along ``cat``. Its adjoint is the
    move back."""
    return x if group is None else _AllToAllDim.apply(x, split, cat, group)


def dist_allreduce_quant(x: torch.Tensor, group=None, *, mean: bool = False,
                         axis_size: int | None = None) -> torch.Tensor:
    """int8-on-the-wire all-reduce over ``group`` (the EQuARX recipe):
    both phases of a reduce-scatter + all-gather all-reduce move int8
    payloads with one fp32 absmax scale a chunk. Every step is the
    reference's as XLA compiles it inside its jitted region, so that the
    bits are the same: the scales by reciprocal (``reciprocal=True``), the
    sum as a chain of fused multiply-adds.

    Phase 1: each rank splits ``x`` into n chunks, quantizes each against
    its own absmax (``ops/quant.py::absmax_quantize_int8``) and sends
    chunk j to rank j (``all_to_all``); rank j sums the n dequantized
    versions of its chunk in fp32, in source-rank order. Phase 2: it
    re-quantizes the sum (after the divide, with ``mean``) and all-gathers
    it, so that every rank dequantizes the same bytes: the result is
    identical on every rank. With n == 1 ``x`` is returned untouched."""
    import torch.distributed as dist

    from ..ops.quant import absmax_quantize_int8

    n = int(axis_size) if axis_size is not None else _world(group)
    if n == 1:
        return x
    flat = x.float().reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = absmax_quantize_int8(flat.reshape(n, -1), axis=-1,
                                reciprocal=True)
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_in, q.contiguous(), group=group)
    dist.all_to_all_single(s_in, s.contiguous(), group=group)
    # the reference's sum, as XLA compiles it: a chain of fused
    # multiply-adds from 0 in source-rank order. The product of an int8
    # and an fp32 scale is exact in fp64, so one fp64 add a term rounded
    # to fp32 is the FMA (it could differ only where the fp64 sum lands
    # on an fp32 tie, ~2^-29 of sums)
    red = torch.zeros(q_in.shape[1:], dtype=torch.float32, device=x.device)
    for i in range(n):
        red = (red.double() + q_in[i].double() * s_in[i].double()).float()
    if mean:
        red = red / n
    q2, s2 = absmax_quantize_int8(red[None, :], axis=-1, reciprocal=True)
    qg = torch.empty((n,) + tuple(q2.shape[1:]), dtype=q2.dtype,
                     device=q2.device)
    sg = torch.empty((n, 1), dtype=s2.dtype, device=s2.device)
    dist.all_gather_into_tensor(qg, q2.contiguous(), group=group)
    dist.all_gather_into_tensor(sg, s2.contiguous(), group=group)
    out = (qg.float() * sg).reshape(-1)[:size]
    return out.reshape(x.shape).to(x.dtype)
