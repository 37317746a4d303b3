"""``global_scatter`` / ``global_gather``: the count-driven all-to-all of
expert parallelism (the port's copy of
paddle_tpu/distributed/utils/moe_utils.py; Paddle's
distributed/utils/moe_utils.py:20,153).

The reference's ranks are views of one array, so both are its checked
identity. Here the rows really cross ranks: ``local_count[i]`` rows of
``x`` (grouped by destination, rank-major) go to expert ``i % n_expert``
on rank ``i // n_expert``; ``global_count[i]`` rows arrive for this
rank's expert ``i % n_expert`` from rank ``i // n_expert``. One
``collective.alltoall_single`` with ``in_split_sizes`` /
``out_split_sizes`` moves them, and the received rows are regrouped by
expert (expert-major, then source rank), Paddle's output order.
``global_gather`` is the inverse; each is the other's backward. With
one rank both are the reference's: the identity once the row totals
agree (``ValueError`` otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor

__all__ = ["global_scatter", "global_gather"]

# exchanges and the bytes that left this rank, over every call
STATS = {"calls": 0, "bytes": 0}


def _counts(t) -> list:
    a = getattr(t, "_data", t)
    if isinstance(a, torch.Tensor):
        return [int(v) for v in a.detach().reshape(-1).cpu().tolist()]
    return [int(v) for v in np.asarray(a).reshape(-1)]


def _group(group):
    """``group``, the port's default group where None and one is set, or
    None (one rank)."""
    if group is not None:
        return group if group.nranks > 1 else None
    from .. import parallel

    g = parallel._DEFAULT_GROUP
    return g if g is not None and g.nranks > 1 else None


def _expert_order(gc: list, n: int, device) -> torch.Tensor:
    """Rows received rank-major (rank j's rows for this rank's experts in
    expert order) as indices in expert-major order."""
    E = len(gc) // n
    starts = np.concatenate([[0], np.cumsum(gc)[:-1]]).astype(np.int64)
    idx = [np.arange(starts[j * E + i], starts[j * E + i] + gc[j * E + i])
           for i in range(E) for j in range(n)]
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _exchange(x: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """The rows of ``x`` split by ``send`` to the group's ranks, those
    arriving (``recv`` from each) concatenated in rank order."""
    from ..collective import alltoall_single

    x = x.contiguous()
    STATS["calls"] += 1
    STATS["bytes"] += sum(send) * x[0:1].numel() * x.element_size()
    return alltoall_single(x, None, send, recv, group=group).wait()


def _scatter(x, lc, gc, group):
    if group is None:
        if sum(lc) != sum(gc):
            raise ValueError("local_count and global_count row totals "
                             "differ")
        return x
    n = group.nranks
    E = len(lc) // n
    if x.shape[0] != sum(lc):
        raise ValueError(f"global_scatter: {x.shape[0]} rows, local_count "
                         f"sums to {sum(lc)}")
    send = [sum(lc[j * E:(j + 1) * E]) for j in range(n)]
    recv = [sum(gc[j * E:(j + 1) * E]) for j in range(n)]
    got = _exchange(x, send, recv, group)
    return got[_expert_order(gc, n, x.device)]


def _gather(x, lc, gc, group):
    if group is None:
        if sum(lc) != sum(gc):
            raise ValueError("local_count and global_count row totals "
                             "differ")
        return x
    n = group.nranks
    E = len(lc) // n
    if x.shape[0] != sum(gc):
        raise ValueError(f"global_gather: {x.shape[0]} rows, global_count "
                         f"sums to {sum(gc)}")
    back = torch.empty_like(x)
    back[_expert_order(gc, n, x.device)] = x
    send = [sum(gc[j * E:(j + 1) * E]) for j in range(n)]
    recv = [sum(lc[j * E:(j + 1) * E]) for j in range(n)]
    return _exchange(back, send, recv, group)


class _GlobalScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lc, gc, group):
        ctx.args = (lc, gc, group)
        return _scatter(x, lc, gc, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), *ctx.args), None, None, None


class _GlobalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lc, gc, group):
        ctx.args = (lc, gc, group)
        return _gather(x, lc, gc, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.contiguous(), *ctx.args), None, None, None


def _apply(fn, x, local_count, global_count, group):
    d = getattr(x, "_data", None)
    out = fn.apply(d if d is not None else torch.as_tensor(x),
                   _counts(local_count), _counts(global_count),
                   _group(group))
    if d is None:
        return out
    return Tensor(out, stop_gradient=not out.requires_grad)


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream: bool = True):
    """Rows of ``x`` grouped by destination (rank, expert) to the rows
    this rank's experts receive, grouped by expert then source rank
    (reference moe_utils.py:29)."""
    return _apply(_GlobalScatter, x, local_count, global_count, group)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream: bool = True):
    """The inverse of ``global_scatter`` (reference moe_utils.py:45)."""
    return _apply(_GlobalGather, x, local_count, global_count, group)
