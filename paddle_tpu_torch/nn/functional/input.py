"""Input functionals: one_hot, embedding (port of
paddle_tpu/nn/functional/input.py).

``embedding`` is a row gather whose backward scatter-adds into the
table, as the reference's. Indices keep their integer type (the
reference truncates them to int32); they follow ``jnp.take``'s rules: a
negative index counts from the end, one outside [-n, n) reads NaN.
"""

from __future__ import annotations

import torch

from ...core.dispatch import op
from ...core.tensor import Tensor, as_torch

__all__ = ["one_hot", "embedding", "embedding_renorm_"]


@op("one_hot", differentiable=False)
def one_hot(x, num_classes: int):
    # an index outside [0, num_classes) is a row of zeros, as in JAX
    idx = x.to(torch.int64)
    classes = torch.arange(num_classes, device=idx.device)
    return (idx[..., None] == classes).to(torch.float32)


@op("embedding", amp="cast")
def embedding(x, weight, padding_idx=None, sparse: bool = False):
    idx = x.to(torch.int64)
    n = weight.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    valid = (wrapped >= 0) & (wrapped < n)
    out = weight[torch.clamp(wrapped, 0, n - 1)]
    # no host sync to ask whether any index is out of range
    out = torch.where(valid[..., None], out,
                      torch.full((), float("nan"), dtype=out.dtype,
                                 device=out.device))
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((idx != padding_idx)[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def embedding_renorm_(weight, x, max_norm, norm_type=2.0):
    """Scale each embedding row that ``x`` references and whose
    ``norm_type``-norm exceeds ``max_norm`` down to it, in place; rows
    not referenced are untouched. Returns the weight."""
    w = weight._data if isinstance(weight, Tensor) else as_torch(weight)
    idx = (x._data if isinstance(x, Tensor) else as_torch(
        x, device=w.device)).to(torch.int64).reshape(-1)
    with torch.no_grad():
        rows = w[idx]
        norms = torch.sum(torch.abs(rows) ** norm_type,
                          dim=-1) ** (1.0 / norm_type)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                            torch.ones_like(norms))
        full = torch.ones((w.shape[0],), dtype=w.dtype, device=w.device)
        full = full.index_reduce(0, idx, scale.to(w.dtype), "amin")
        new_w = w * full[:, None]
    if isinstance(weight, Tensor):
        weight.set_value(new_w)
        return weight
    return new_w
