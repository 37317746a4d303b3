"""Tensor-parallel (model-parallel) layers (the port's copy of
paddle_tpu/distributed/fleet/mp_layers.py; reference
python/paddle/distributed/fleet/layers/mpu/mp_layers.py:
VocabParallelEmbedding:47, ColumnParallelLinear:334,
RowParallelLinear:541, ParallelCrossEntropy:742).

The reference keeps each parameter global, annotated with a sharding
over the "mp" axis, and XLA partitions the products and inserts the
collectives. Here every rank holds its own block of a sharded parameter
(``is_distributed`` True over more than one rank, ``split_axis`` the
dim it is split on) and the collectives are explicit, as in Paddle:
``autograd_collectives``' Megatron pairs, whose backward is the
forward's transpose for a computation every mp rank repeats
(``c_identity``, ``mp_allreduce``, ``c_split``, ``c_concat``). A layer
draws its parameter at the global shape from the port's generator and
keeps its block, so that the same seed gives every mp degree the same
global weights.
"""

from __future__ import annotations

import torch

from ...core.tensor import Tensor
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from ..autograd_collectives import c_concat, c_identity, c_split, mp_allreduce
from ..collective import ReduceOp, _pg, all_reduce
from ..topology import get_hybrid_communicate_group

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _mp_group(group=None):
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("fleet.init(strategy) must run before building "
                           "tensor-parallel layers")
    return hcg.get_model_parallel_group()


def _shard_param(param, axis: int, group):
    """Keep this rank's block of ``param`` along ``axis`` (in place)."""
    n = group.nranks
    size = param._data.shape[axis]
    if size % n:
        raise ValueError(f"dim {axis} of {list(param._data.shape)} does not "
                         f"split over {n} model-parallel ranks")
    k = size // n
    if n > 1:
        param._bump(param._data.detach().narrow(axis, group.rank * k, k)
                    .clone())
    param.is_distributed = n > 1
    param.split_axis = axis
    return param


def _on(fn, x: Tensor, *args) -> Tensor:
    """``autograd_collectives``' ``fn`` on ``x``'s data over ``args``
    (the last one a Group, passed as its process group)."""
    *rest, group = args
    out = fn(x._data, *rest, _pg(group))
    return x if out is x._data else Tensor(
        out, stop_gradient=not out.requires_grad)


class VocabParallelEmbedding(Layer):
    """Embedding with the vocabulary split over mp: rank r holds rows
    r V / mp onward, looks up the ids in its range (the others masked to
    row 0 and their rows zeroed) and the ranks' rows are summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, 0, self._group)
        self.vocab_start = self._group.rank * self.weight.shape[0] \
            if self.weight.is_distributed else 0

    def forward(self, x):
        if not self.weight.is_distributed:
            return F.embedding(x, self.weight)
        per = self.weight.shape[0]
        ids = x._data.to(torch.int64)
        local = ids - self.vocab_start
        miss = (local < 0) | (local >= per)
        out = F.embedding(Tensor(torch.where(miss, 0, local)), self.weight)
        out = out * Tensor((~miss)[..., None].to(out.dtype))
        return _on(mp_allreduce, out, self._group)


class ColumnParallelLinear(Layer):
    """Linear with the output features split over mp: weight [in, out /
    mp] (columns r out / mp onward), the bias split alike. The input
    passes as it is and its gradient is summed over mp;
    ``gather_output`` concatenates the ranks' outputs (the gradient
    split back)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, 1, self._group)
        if has_bias:
            self.bias = self.create_parameter([out_features], attr=None,
                                              is_bias=True)
            _shard_param(self.bias, 0, self._group)
        else:
            self.bias = None
        self.gather_output = gather_output

    def forward(self, x):
        x = _on(c_identity, x, self._group)
        y = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            y = _on(c_concat, y, -1, self._group)
        return y


class RowParallelLinear(Layer):
    """Linear with the input features split over mp: weight [in / mp,
    out]. The partial products are summed over mp, then the replicated
    bias is added once. ``input_is_parallel=False`` takes this rank's
    slice of a whole input (its gradient gathered back)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, 0, self._group)
        if has_bias:
            self.bias = self.create_parameter([out_features], attr=None,
                                              is_bias=True)
        else:
            self.bias = None
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        if not self.input_is_parallel:
            x = _on(c_split, x, -1, self._group)
        y = F.linear(x, self.weight)
        y = _on(mp_allreduce, y, self._group)
        if self.bias is not None:
            y = y + self.bias.astype(y.dtype)
        return y


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross-entropy over logits whose classes are split over
    mp (Paddle's c_softmax_with_cross_entropy): the local maximum, then
    its all-reduce MAX; the sum of exponentials, all-reduced; the target
    logit where this rank holds the label, all-reduced. The backward is
    softmax minus one-hot on the local slab."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        per = x.shape[-1]
        m = x.max(-1).values.contiguous()
        all_reduce(m, op=ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        s = e.sum(-1).contiguous()
        all_reduce(s, group=group)
        local = label - group.rank * per
        hit = (local >= 0) & (local < per)
        safe = torch.where(hit, local, 0)
        picked = torch.gather(x, -1, safe[..., None])[..., 0]
        picked = torch.where(hit, picked, 0.0).contiguous()
        all_reduce(picked, group=group)
        valid = label != ignore_index
        loss = torch.where(valid, torch.log(s) + m - picked, 0.0)
        ctx.save_for_backward(e / s[..., None], safe, hit & valid, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        p, safe, hit, valid = ctx.saved_tensors
        grad = p.scatter_add(-1, safe[..., None], -hit.float()[..., None])
        grad = grad * torch.where(valid, g, 0.0)[..., None]
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy on logits split over mp along the class
    dim; ``reduction="none"``, rows at ``ignore_index`` 0; the output has
    the label's shape (a trailing 1 dropped), as the reference's
    ``F.cross_entropy``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        lbl = label._data if isinstance(label, Tensor) else \
            torch.as_tensor(label, device=input._data.device)
        if lbl.dim() == input.ndim and lbl.shape[-1] == 1:
            lbl = lbl[..., 0]
        lbl = lbl.to(torch.int64)
        if _pg(self._group) is None:
            return F.cross_entropy(input, Tensor(lbl), reduction="none",
                                   ignore_index=self.ignore_index)
        out = _VocabParallelCE.apply(input._data, lbl, self._group,
                                     self.ignore_index)
        return Tensor(out, stop_gradient=not out.requires_grad)
