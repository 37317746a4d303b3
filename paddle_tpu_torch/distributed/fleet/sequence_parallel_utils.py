"""Megatron-style sequence parallelism (the port's copy of
paddle_tpu/distributed/fleet/sequence_parallel_utils.py; reference
python/paddle/distributed/fleet/utils/sequence_parallel_utils.py:
ScatterOp / GatherOp / AllGatherOp / ReduceScatterOp :85-140,
ColumnSequenceParallelLinear:427, RowSequenceParallelLinear:562).

Between tensor-parallel blocks the activations are split along the
sequence dim (dim 0, [s, b, h]) over mp. The reference reshards a
global array and XLA reduces partial sums where its products make them;
here every rank holds its block and each op is an autograd pair of
``autograd_collectives`` over the mp group, as Paddle's: ``ScatterOp``
splits (``c_split``: backward all-gather), ``GatherOp`` all-gathers
(``c_concat``: backward split), ``AllGatherOp`` all-gathers in front of
a column-parallel product, whose input gradient is a partial sum on
each rank (``all_gather_dim``: backward reduce-scatter), and
``ReduceScatterOp`` sums a row-parallel product's partial outputs and
keeps this rank's block (``reduce_scatter_dim``: backward all-gather),
where the reference's only reshards. A parameter applied to the split
activations (a LayerNorm's, a row layer's bias) gets its gradient from
this rank's tokens alone: ``mark_as_sequence_parallel_parameter`` marks
it and ``register_sequence_parallel_allreduce_hooks`` sums its gradient
over mp, where the reference's hook is a no-op.
"""

from __future__ import annotations

from ...core.tensor import Tensor
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from ..autograd_collectives import (all_gather_dim, c_concat, c_split,
                                    reduce_scatter_dim)
from ..collective import _pg, all_reduce
from .mp_layers import _mp_group, _on, _shard_param

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "mark_as_sequence_parallel_parameter",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
    "register_sequence_parallel_allreduce_hooks",
]


class ScatterOp:
    """This rank's block of the sequence dim, dim 0 of [s, b, h] as the
    reference's (backward: all-gather)."""

    @staticmethod
    def apply(x: Tensor, axis: int = 0) -> Tensor:
        return _on(c_split, x, axis, _mp_group())


class GatherOp:
    """The sequence dim all-gathered (backward: this rank's block)."""

    @staticmethod
    def apply(x: Tensor, axis: int = 0) -> Tensor:
        return _on(c_concat, x, axis, _mp_group())


class AllGatherOp:
    """The sequence dim all-gathered; the backward sums the ranks'
    partial gradients and keeps this rank's block (reduce-scatter)."""

    @staticmethod
    def apply(x: Tensor, axis: int = 0) -> Tensor:
        return _on(all_gather_dim, x, axis, _mp_group())


class ReduceScatterOp:
    """The ranks' partial sums summed, this rank's block of the sequence
    dim kept (backward: all-gather)."""

    @staticmethod
    def apply(x: Tensor, axis: int = 0) -> Tensor:
        return _on(reduce_scatter_dim, x, axis, _mp_group())


def mark_as_sequence_parallel_parameter(param):
    param.is_sequence_parallel = True
    param.sequence_parallel = True


def is_sequence_parallel_parameter(param) -> bool:
    return bool(getattr(param, "is_sequence_parallel", False))


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps: int = 1,
        fuse_sequence_parallel_allreduce: bool = False):
    """Sum the gradient of every parameter marked by
    ``mark_as_sequence_parallel_parameter`` over mp, once every
    ``accumulation_steps`` backwards (after it is accumulated). Returns
    the marked parameters (none over one mp rank)."""
    group = _mp_group()
    if accumulation_steps <= 0 or _pg(group) is None:
        return []
    params = [p for p in model.parameters()
              if is_sequence_parallel_parameter(p) and not p.stop_gradient]
    counts = {}

    def hook(t, p):
        counts[id(p)] = counts.get(id(p), 0) + 1
        if counts[id(p)] % accumulation_steps == 0:
            all_reduce(t.grad, group=group)

    for p in params:
        p._data.register_post_accumulate_grad_hook(
            lambda t, p=p: hook(t, p))
    return params


class ColumnSequenceParallelLinear(Layer):
    """A column-parallel linear on a sequence-split input: the sequence
    all-gathered (``AllGatherOp``), then this rank's output columns
    (weight [in, out / mp], the bias split alike)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, name=None,
                 mp_group=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, 1, self._group)
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self.bias is not None:
            _shard_param(self.bias, 0, self._group)
        self.gather_output = gather_output

    def forward(self, x):
        x = AllGatherOp.apply(x)
        y = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            y = _on(c_concat, y, -1, self._group)
        return y


class RowSequenceParallelLinear(Layer):
    """A row-parallel linear whose output is reduce-scattered along the
    sequence (weight [in / mp, out]); the replicated bias is added after
    the reduce-scatter, to this rank's tokens, and is marked as a
    sequence-parallel parameter."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, name=None,
                 mp_group=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, 0, self._group)
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        y = ReduceScatterOp.apply(F.linear(x, self.weight))
        if self.bias is not None:
            y = y + self.bias.astype(y.dtype)
        return y
