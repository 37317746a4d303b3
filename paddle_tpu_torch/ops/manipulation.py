"""Shape, indexing and rearrangement ops (port of
paddle_tpu/ops/manipulation.py).

The data-dependent ops (masked_select, nonzero, unique,
unique_consecutive) are plain functions as in the reference. Indexing
follows numpy's rules as JAX's does, negative slice steps included.
"""

from __future__ import annotations

import builtins
from builtins import slice as _pyslice

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import op
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor


def _to_static_ints(v):
    if isinstance(v, (Tensor, torch.Tensor)):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return int(v)
    return [int(x.item() if isinstance(x, (Tensor, torch.Tensor)) else x)
            for x in v]


def _as_t(x, like):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=like.device)


@op("cast")
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@op("reshape")
def reshape(x, shape):
    s = _to_static_ints(shape)
    return torch.reshape(x, [s] if isinstance(s, int) else s)


@op("transpose")
def transpose(x, perm=None):
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(*[int(p) for p in perm])


@op("t")
def t(x):
    return x.permute(*range(x.dim())[::-1])


@op("moveaxis")
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op("swapaxes")
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@op("concat")
def concat(x, axis=0):
    return torch.cat(list(x), dim=int(axis))


@op("stack")
def stack(x, axis=0):
    return torch.stack(list(x), dim=axis)


@op("vstack")
def vstack(x):
    return torch.vstack(list(x))


@op("hstack")
def hstack(x):
    return torch.hstack(list(x))


def _equal_split(x, n, axis):
    if x.shape[axis] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} into {n}")
    return tuple(torch.tensor_split(x, n, dim=axis))


@op("split")
def split(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        return _equal_split(x, num_or_sections, axis)
    sections = _to_static_ints(num_or_sections)
    total = x.shape[axis]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections = [s if s != -1 else total - known for s in sections]
    return tuple(torch.split(x, sections, dim=axis))


@op("chunk")
def chunk(x, chunks, axis=0):
    return _equal_split(x, int(chunks), int(axis))


@op("unbind")
def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=axis))


@op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, axis) if axis else x
    return torch.squeeze(x, axis) if x.shape[axis] == 1 else x


@op("unsqueeze")
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


@op("flatten")
def flatten(x, start_axis=0, stop_axis=-1):
    ndim = x.dim()
    if ndim == 0:
        return torch.reshape(x, (1,))
    if start_axis < 0:
        start_axis += ndim
    if stop_axis < 0:
        stop_axis += ndim
    shape = tuple(x.shape)
    new_shape = (shape[:start_axis]
                 + (int(np.prod(shape[start_axis:stop_axis + 1])),)
                 + shape[stop_axis + 1:])
    return torch.reshape(x, new_shape)


@op("tile")
def tile(x, repeat_times):
    r = _to_static_ints(repeat_times)
    return torch.tile(x, [r] if isinstance(r, int) else r)


@op("expand")
def expand(x, shape):
    shape = _to_static_ints(shape)
    cur = list(x.shape)
    pad = len(shape) - len(cur)
    cur = [1] * pad + cur
    tgt = [c if s == -1 else s for s, c in zip(shape, cur)]
    return torch.broadcast_to(torch.reshape(x, cur), tgt)


@op("expand_as")
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, _to_static_ints(shape))


def broadcast_tensors(inputs):
    arrs = [i._data if isinstance(i, Tensor) else torch.as_tensor(i)
            for i in inputs]
    return [Tensor(a) for a in torch.broadcast_tensors(*arrs)]


@op("flip")
def flip(x, axis):
    return torch.flip(x, list(axis) if isinstance(axis, (list, tuple))
                      else [axis])


@op("roll")
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@op("_clone")
def _clone(x):
    return x.clone()


@op("_tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@op("_triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


# ---------------------------------------------------------------------------
# Gather / scatter family
# ---------------------------------------------------------------------------


def _long(i):
    return i.long() if isinstance(i, torch.Tensor) else torch.as_tensor(i)


@op("gather")
def gather(x, index, axis=0):
    idx = _long(index)
    if idx.dim() > 1:
        idx = idx.reshape(-1)
    if idx.dim() == 0:
        return torch.select(x, axis, int(idx))
    return torch.index_select(x, axis, idx)


@op("gather_nd")
def gather_nd(x, index):
    return x[tuple(_long(index).unbind(-1))]


@op("index_select")
def index_select(x, index, axis=0):
    return torch.index_select(x, axis, _long(index).reshape(-1))


@op("index_sample")
def index_sample(x, index):
    return torch.gather(x, -1, _long(index))


@op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True):
    indices = _long(indices)
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, shape)
    return torch.gather(arr, axis, indices)


def _along_index(arr, indices, axis):
    dims = arr.dim()
    idx = []
    for d in range(dims):
        if d == axis % dims:
            idx.append(indices)
        else:
            shape = [1] * dims
            shape[d] = arr.shape[d]
            idx.append(torch.arange(arr.shape[d], device=arr.device)
                       .reshape(shape).broadcast_to(indices.shape))
    return tuple(idx)


@op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    indices = _long(indices)
    values = torch.broadcast_to(_as_t(values, arr).to(arr.dtype),
                                indices.shape)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    if reduce not in ("assign", "add"):
        raise KeyError(reduce)
    return arr.index_put(_along_index(arr, indices, axis), values,
                         accumulate=reduce == "add")


@op("scatter")
def scatter(x, index, updates, overwrite=True):
    index = _long(index).reshape(-1)
    return x.index_put((index,), updates.to(x.dtype),
                       accumulate=not overwrite)


@op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(_long(index).unbind(-1)), updates.to(x.dtype),
                       accumulate=True)


@op("scatter_nd")
def scatter_nd(index, updates, shape):
    zeros = torch.zeros(_to_static_ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(tuple(_long(index).unbind(-1)), updates,
                           accumulate=True)


@op("index_add")
def index_add(x, index, axis, value):
    return torch.index_add(x, axis, _long(index), value.to(x.dtype))


@op("index_put")
def index_put(x, indices, value, accumulate=False):
    idx = tuple(_long(i) for i in indices)
    return x.index_put(idx, _as_t(value, x).to(x.dtype),
                       accumulate=accumulate)


@op("where")
def where(condition, x=None, y=None):
    if x is None and y is None:
        raise ValueError("use nonzero() for single-arg where")
    if not isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        x = _as_t(x, y).to(y.dtype)
    if not isinstance(y, torch.Tensor) and isinstance(x, torch.Tensor):
        y = _as_t(y, x).to(x.dtype)
    return torch.where(condition.bool(), x, y)


@op("masked_fill")
def masked_fill(x, mask, value):
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask.bool(), value, x)


@op("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False):
    n = builtins.min(x.shape[-2], x.shape[-1])
    i = torch.arange(n - builtins.abs(offset), device=x.device)
    rows = i + builtins.max(-offset, 0)
    cols = i + builtins.max(offset, 0)
    out = x.clone()
    out[..., rows, cols] = _as_t(value, x).to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Sorting / ranking
# ---------------------------------------------------------------------------


@op("sort")
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


@op("argsort", differentiable=False)
def argsort(x, axis=-1, descending=False):
    out = torch.argsort(x, dim=axis, stable=True)
    if descending:
        out = torch.flip(out, [axis])
    return out.long()


@op("topk")
def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    k = int(k)
    xs = torch.movedim(x, axis, -1)
    key = xs if largest else -xs
    # lax.top_k: descending values, ties to the lower index
    order = torch.argsort(-key, dim=-1, stable=True)[..., :k]
    vals = torch.gather(xs, -1, order)
    return torch.movedim(vals, -1, axis), torch.movedim(order, -1, axis)


@op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False):
    idxs = torch.argsort(x, dim=axis, stable=True)
    vals = torch.gather(x, axis, idxs)
    v = torch.select(vals, axis, k - 1)
    i = torch.select(idxs, axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i.long()


@op("mode")
def mode(x, axis=-1, keepdim=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    sorted_x = torch.gather(x, axis, idx)
    moved = torch.movedim(sorted_x, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    n = flat.shape[1]
    eq = flat[:, 1:] == flat[:, :-1]
    run_id = torch.cat([torch.zeros((flat.shape[0], 1), dtype=torch.int64,
                                    device=x.device),
                        torch.cumsum((~eq).long(), dim=1)], dim=1)
    counts = torch.zeros((flat.shape[0], n), dtype=torch.int64,
                         device=x.device).scatter_add_(
        1, run_id, torch.ones_like(run_id))
    best_run = torch.argmax(counts, dim=1)
    first = torch.argmax((run_id == best_run[:, None]).int(), dim=1)
    values = torch.gather(flat, 1, first[:, None])[:, 0]
    out_shape = moved.shape[:-1]
    values = values.reshape(out_shape)
    indices = torch.zeros(out_shape, dtype=torch.int64, device=x.device)
    if keepdim:
        values = values.unsqueeze(axis)
        indices = indices.unsqueeze(axis)
    return values, indices


@op("searchsorted", differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    seq = sorted_sequence
    if seq.dim() > 1:
        seq = seq.reshape(-1, seq.shape[-1])
        vals = values.reshape(-1, values.shape[-1])
        out = torch.searchsorted(seq.contiguous(), vals.contiguous(),
                                 right=right).reshape(values.shape)
    else:
        out = torch.searchsorted(seq.contiguous(), values, right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


@op("bucketize", differentiable=False)
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    out = torch.searchsorted(sorted_sequence.contiguous(), x, right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


# ---------------------------------------------------------------------------
# Data-dependent shapes (eager only)
# ---------------------------------------------------------------------------


def masked_select(x, mask):
    return Tensor(x._data[mask._data.bool()])


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(x._data, as_tuple=True)
    if as_tuple:
        return tuple(Tensor(n) for n in nz)
    return Tensor(torch.stack(nz, dim=1).long())


def _host_tensor(arr, device):
    return Tensor(torch.as_tensor(np.asarray(arr), device=device))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    arr = x.numpy()
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = x._data.device
    if not isinstance(res, tuple):
        return _host_tensor(res, dev)
    return tuple(_host_tensor(r, dev) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    arr = x.numpy()
    dev = x._data.device
    flat = arr if axis is not None else arr.reshape(-1)
    keep = np.ones(flat.shape[0] if axis is None else flat.shape[axis],
                   dtype=bool)
    cmp_axis = 0 if axis is None else axis
    moved = np.moveaxis(flat, cmp_axis, 0) if axis is not None else flat
    eq = (moved[1:] == moved[:-1])
    if eq.ndim > 1:
        eq = eq.reshape(eq.shape[0], -1).all(axis=1)
    keep[1:] = ~eq
    out = moved[keep] if axis is not None else flat[keep]
    if axis is not None:
        out = np.moveaxis(out, 0, cmp_axis)
    results = [_host_tensor(out, dev)]
    if return_inverse:
        results.append(_host_tensor(np.cumsum(keep) - 1, dev))
    if return_counts:
        idx = np.flatnonzero(keep)
        results.append(_host_tensor(np.diff(np.append(idx, keep.shape[0])),
                                    dev))
    return results[0] if len(results) == 1 else tuple(results)


# ---------------------------------------------------------------------------
# Padding / slicing
# ---------------------------------------------------------------------------

_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    pad = _to_static_ints(pad)
    ndim = x.dim()
    if len(pad) == 2 * ndim:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(ndim)]
    else:
        n_spatial = len(pad) // 2
        width = [(0, 0)] * (ndim - n_spatial) + [
            (pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        if data_format.endswith("C"):
            width = ([(0, 0)] + width[ndim - n_spatial:]
                     + [(0, 0)] * (ndim - n_spatial - 1))
    if mode == "constant":
        flat = []
        for lo, hi in reversed(width):
            flat += [lo, hi]
        return F.pad(x, flat, mode="constant", value=value)
    npmode = _PAD_MODES[mode]
    out = x
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=npmode)
            out = torch.index_select(out, d, torch.as_tensor(
                idx, device=x.device))
    return out


def _index_dim(x, d, s):
    """``x`` sliced along dim ``d`` by Python slice ``s`` (numpy rules,
    negative steps too)."""
    start, stop, step = s.indices(x.shape[d])
    if step > 0:
        return x[(_pyslice(None),) * d + (s,)]
    idx = torch.arange(start, stop, step, device=x.device)
    return torch.index_select(x, d, idx)


def _slice_dims(x, slices):
    out = x
    for d, s in slices:
        out = _index_dim(out, d, s)
    return out


@op("slice")
def slice(x, axes, starts, ends):  # noqa: A001
    return _slice_dims(x, [(ax % x.dim(), _pyslice(s, e)) for ax, s, e in
                           zip(axes, _to_static_ints(starts),
                               _to_static_ints(ends))])


@op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    return _slice_dims(x, [(ax % x.dim(), _pyslice(s, e, st))
                           for ax, s, e, st in zip(
                               axes, _to_static_ints(starts),
                               _to_static_ints(ends),
                               _to_static_ints(strides))])


@op("crop")
def crop(x, shape=None, offsets=None):
    shape = _to_static_ints(shape)
    offsets = _to_static_ints(offsets) if offsets is not None \
        else [0] * len(shape)
    idx = tuple(_pyslice(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return x[idx]


@op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


@op("as_strided")
def as_strided(x, shape, stride, offset=0):
    flat = x.reshape(-1)
    shape = _to_static_ints(shape)
    stride = _to_static_ints(stride)
    idx = np.zeros(shape, dtype=np.int64) + offset
    for d, (s, st) in enumerate(zip(shape, stride)):
        rs = [1] * len(shape)
        rs[d] = s
        idx = idx + (np.arange(s) * st).reshape(rs)
    return flat[torch.as_tensor(idx, device=x.device)]


# ---------------------------------------------------------------------------
# getitem / setitem used by Tensor.__getitem__ / __setitem__
# ---------------------------------------------------------------------------


def _unwrap_index(item):
    if isinstance(item, Tensor):
        return item._data
    if isinstance(item, tuple):
        return tuple(_unwrap_index(i) for i in item)
    if isinstance(item, list):
        return torch.as_tensor(np.asarray(item))
    if isinstance(item, np.ndarray):
        return torch.as_tensor(item)
    return item


def _torch_index(x, item):
    """A numpy-style index as torch takes it: (x', index) with integer
    arrays as int64 on ``x``'s device, and each slice with a negative
    step turned into a positive one on ``x`` flipped along that dim."""
    items = item if isinstance(item, tuple) else (item,)

    def consumed(i):
        if i is None or i is Ellipsis:
            return 0
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            return i.dim()
        return 1

    n_real = builtins.sum(consumed(i) for i in items)
    out, flips = [], []
    dim = 0
    for i in items:
        if i is Ellipsis:
            out.append(i)
            dim += x.dim() - n_real
            continue
        if isinstance(i, torch.Tensor):
            i = i.to(x.device) if i.dtype == torch.bool else \
                i.to(device=x.device, dtype=torch.int64)
        elif isinstance(i, _pyslice) and i.step is not None and i.step < 0:
            n = x.shape[dim]
            start, stop, step = i.indices(n)
            flips.append(dim)
            i = _pyslice(n - 1 - start, n - 1 - stop, -step)
        out.append(i)
        dim += consumed(i)
    if flips:
        x = torch.flip(x, flips)
    return x, (tuple(out) if isinstance(item, tuple) else out[0])


def _index(x, item):
    x2, idx = _torch_index(x, item)
    return x2[idx]


@op("getitem")
def _getitem(x, item):
    return _index(x, item)


@op("tensor_getitem")
def _tensor_getitem(x, *idx_arrays, template=None):
    it = iter(idx_arrays)
    rebuilt = tuple(next(it) if e is None else e for e in template)
    return _index(x, rebuilt if len(rebuilt) > 1 else rebuilt[0])


def getitem(x, item):
    """Differentiable __getitem__ supporting Tensor indices."""
    if isinstance(item, Tensor):
        return _getitem_with_tensors(x, (item,))
    if isinstance(item, tuple) and builtins.any(isinstance(i, Tensor)
                                                for i in item):
        return _getitem_with_tensors(x, item)
    return _getitem(x, _unwrap_index(item))


def _getitem_with_tensors(x, items):
    tensor_idx = [i for i in items if isinstance(i, Tensor)]
    template = tuple(None if isinstance(i, Tensor) else _unwrap_index(i)
                     for i in items)
    return _tensor_getitem(x, *tensor_idx, template=template)


def _set_index(x, item, value):
    """``x`` with ``x[item] = value`` written into a copy: the positions
    the index selects (numpy's rules) get the broadcast value."""
    pos = _index(torch.arange(x.numel(), device=x.device).reshape(x.shape),
                 item)
    v = torch.broadcast_to(_as_t(value, x).to(x.dtype), pos.shape)
    return x.reshape(-1).index_put((pos.reshape(-1),),
                                   v.reshape(-1)).reshape(x.shape)


@op("setitem")
def setitem(x, item, value):
    return _set_index(x, item, value)


# ---------------------------------------------------------------------------
# diag_embed, unstack, sequence_mask, shard_index, temporal_shift
# ---------------------------------------------------------------------------


@op("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    x = input
    n = x.shape[-1] + builtins.abs(offset)
    base = torch.zeros(tuple(x.shape[:-1]) + (n, n), dtype=x.dtype,
                       device=x.device)
    idx = torch.arange(x.shape[-1], device=x.device)
    if offset >= 0:
        out = _put_diag(base, idx, idx + offset, x)
    else:
        out = _put_diag(base, idx - offset, idx, x)
    nd = out.dim()
    d1 = dim1 % nd
    d2 = dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
        if d1 < d2:
            perm.insert(d1, nd - 2)
            perm.insert(d2, nd - 1)
        else:
            perm.insert(d2, nd - 1)
            perm.insert(d1, nd - 2)
        out = out.permute(*perm)
    return out


def _put_diag(base, rows, cols, x):
    out = base.clone()
    out[..., rows, cols] = x
    return out


def unstack(x, axis=0, num=None):
    """Split along axis into a list of tensors (reference unstack)."""
    n = num if num is not None else x.shape[axis]

    @op("unstack")
    def _unstack(x):
        return tuple(torch.squeeze(s, axis)
                     for s in torch.tensor_split(x, n, dim=axis))

    return list(_unstack(x))


@op("sequence_mask", differentiable=False)
def _sequence_mask_impl(x, maxlen: int, dtype: str):
    mask = torch.arange(maxlen, device=x.device)[None, :] < \
        torch.reshape(x, (-1, 1))
    return mask.reshape(tuple(x.shape) + (maxlen,)).to(convert_dtype(dtype))


def sequence_mask(x, maxlen=None, dtype="int64"):
    """lengths -> [.., maxlen] 0/1 mask (reference sequence_mask)."""
    if maxlen is None:
        data = x._data if hasattr(x, "_data") else torch.as_tensor(x)
        maxlen = int(data.max().item()) if data.numel() else 0
    return _sequence_mask_impl(x, maxlen=int(maxlen), dtype=dtype)


@op("shard_index", differentiable=False)
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") == \
        shard_id
    return torch.where(in_shard, torch.remainder(input, shard_size),
                       torch.full_like(input, ignore_value))


@op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    NT, C, H, W = x.shape
    N = NT // seg_num
    v = x.reshape(N, seg_num, C, H, W)
    c1 = int(C * shift_ratio)
    c2 = int(C * 2 * shift_ratio)
    fwd = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]),
                     v[:, :-1, c1:c2]], 1)
    keep = v[:, :, c2:]
    out = torch.cat([fwd, bwd, keep], dim=2).reshape(NT, C, H, W)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


@op("numel", differentiable=False)
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@op("is_empty", differentiable=False)
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


__all__ = sorted(n for n, v in list(globals().items())
                 if not n.startswith("_") and callable(v)
                 and getattr(v, "__module__", None) == __name__)
