"""ZeRO sharding and the layout helpers of sharded state (the port's
copy of paddle_tpu/distributed/sharding.py's placement rules).

A sharded leaf is a ``DTensor`` on the mesh's ``DeviceMesh``: each rank
holds the block of the global tensor its coordinates select, dim by dim
(a dim split over an axis of size n gives rank i its i-th n-th). The
rules that place ZeRO state (:func:`shard_spec_over`: of the dims not
yet sharded, the largest the axis divides) are the reference's, so that
both packages put every moment and master in the same place.

The helpers below move a leaf between layouts with plain collectives
(all-gather along a dim, then a slice), outside autograd: the sharded
train step uses them to materialize ZeRO-3 parameters, to bring
gradients to the optimizer's layout and to write updates back.
``apply_zero_sharding`` and ``group_sharded_parallel`` drive the
reference's ``Optimizer`` classes and come with the Paddle API slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .autograd_collectives import _gather
from .placement import P, spec_entries, spec_of, to_placements

__all__ = ["shard_array_over", "shard_spec_over", "local_shard",
           "gather_full", "reshard", "as_dtensor", "to_local",
           "axis_of_dim", "gather_tree", "REF_COLUMNS"]

# A DTensor whose last dim the port holds in another order than the
# reference carries, under this attribute, the reference's index of each
# of its global columns (the fused qkv projection over mp: each rank's
# heads' q, k and v side by side). The checkpoint writes such a leaf in
# the reference's order, and gather_tree returns it so.
REF_COLUMNS = "ref_columns"


def _shardable_dim(shape, axis_size: int) -> Optional[int]:
    """Largest dim the axis size divides (the first of equals)."""
    best, best_d = None, None
    for d, s in enumerate(shape):
        if s % axis_size == 0 and s >= axis_size:
            if best is None or s > best:
                best, best_d = s, d
    return best_d


def shard_spec_over(shape, cur_spec, mesh, axis: str) -> Optional[P]:
    """The spec that adds ``axis`` on the largest divisible dim of
    ``shape`` not already sharded; None leaves the leaf as it is (axis of
    size 1, already sharded over it, or no dim divisible)."""
    axis_size = mesh.shape[axis]
    if axis_size == 1:
        return None
    entries = [None] * len(shape)
    if cur_spec is not None:
        for d, e in enumerate(cur_spec):
            entries[d] = e
            names = e if isinstance(e, tuple) else (e,) if e else ()
            if axis in names:
                return None
    free_shape = [s if entries[d] is None else 0 for d, s in enumerate(shape)]
    d = _shardable_dim(free_shape, axis_size)
    if d is None:
        return None
    entries[d] = (axis,) if not entries[d] else tuple(entries[d]) + (axis,)
    return P(*entries)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """The rank's block of a ``DTensor`` (the tensor itself otherwise),
    sharing its storage: in-place writes reach the DTensor."""
    if hasattr(t, "_local_tensor"):
        return t._local_tensor
    return t


def axis_of_dim(spec, ndim: int) -> list:
    """Per dim, its one mesh axis or None (the port's layouts split a dim
    over at most one axis)."""
    out = []
    for names in spec_entries(spec, ndim):
        if len(names) > 1:
            raise NotImplementedError(f"a dim split over several axes "
                                      f"({names})")
        out.append(names[0] if names else None)
    return out


def local_shard(full: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """The block of the global ``full`` that the rank at ``coords`` (this
    rank by default) holds under ``spec``."""
    if mesh.size == 1:
        return full
    coords = mesh.coords() if coords is None else coords
    out = full
    for d, axis in enumerate(axis_of_dim(spec, full.dim())):
        if axis is not None and mesh.shape[axis] > 1:
            n = full.shape[d] // mesh.shape[axis]
            out = out.narrow(d, coords[axis] * n, n)
    return out


def gather_full(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block (all-gather along each
    sharded dim); every rank returns it."""
    out = local
    for d, axis in enumerate(axis_of_dim(spec, local.dim())):
        if axis is not None and mesh.shape[axis] > 1:
            out = _gather(out, d, mesh.group(axis))
    return out


def reshard(local: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """A block held under spec ``src`` as this rank's block under
    ``dst``: all-gather along the dims ``src`` splits and ``dst`` does
    not (or splits over another axis), then slice."""
    ndim = local.dim()
    a_src, a_dst = axis_of_dim(src, ndim), axis_of_dim(dst, ndim)
    if a_src == a_dst or mesh.size == 1:
        return local
    out = local
    for d, (s, t) in enumerate(zip(a_src, a_dst)):
        if s is not None and s != t and mesh.shape[s] > 1:
            out = _gather(out, d, mesh.group(s))
    coords = mesh.coords()
    for d, (s, t) in enumerate(zip(a_src, a_dst)):
        if t is not None and s != t and mesh.shape[t] > 1:
            n = out.shape[d] // mesh.shape[t]
            out = out.narrow(d, coords[t] * n, n)
    return out.contiguous()


def as_dtensor(local: torch.Tensor, spec, mesh, shape) -> torch.Tensor:
    """``local`` as this rank's block of a ``DTensor`` of global
    ``shape`` held under ``spec`` (the tensor itself on a one-rank
    mesh)."""
    if mesh.size == 1:
        return local
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh.device_mesh,
                              to_placements(spec, mesh, len(shape)),
                              run_check=False, shape=shape, stride=stride)


def shard_array_over(arr: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Shard a leaf's largest divisible free dim over ``axis``, keeping
    its other shardings: ZeRO-1 for optimizer state, ZeRO-3 for
    parameters (the train step then gathers them all before its forward
    and reduce-scatters their gradients)."""
    cur = spec_of(arr, mesh)
    spec = shard_spec_over(tuple(arr.shape), cur, mesh, axis)
    if spec is None:
        return arr
    local = local_shard(to_local(arr), _only(spec, axis, arr.dim()), mesh)
    out = as_dtensor(local.clone(), spec, mesh, tuple(arr.shape))
    if hasattr(arr, REF_COLUMNS):
        setattr(out, REF_COLUMNS, getattr(arr, REF_COLUMNS))
    return out


def gather_tree(tree, mesh):
    """The whole value of every leaf of a (nested dict) tree of sharded
    state, in the reference's order, on every rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or mesh.size == 1:
        return tree
    full = gather_full(to_local(tree), spec_of(tree, mesh), mesh)
    cols = getattr(tree, REF_COLUMNS, None)
    if cols is not None:
        out = torch.empty_like(full)
        out[..., cols.to(full.device)] = full
        full = out
    return full


def _only(spec, axis: str, ndim: int) -> P:
    """``spec`` restricted to one axis (the part a local slice adds)."""
    return P(*((axis,) if axis in names else None
               for names in spec_entries(spec, ndim)))
