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

``reshard_op``, ``scatter_axis`` and ``gather_axis`` act on the
reference's ``Tensor`` and come with the Paddle API slice.
"""

from __future__ import annotations

import torch

__all__ = ["dist_allreduce_quant", "QUANT_SYNC_PP_REFUSAL",
           "all_reduce_sum", "all_gather_dim", "reduce_scatter_dim"]

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
