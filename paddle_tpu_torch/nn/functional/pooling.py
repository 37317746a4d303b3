"""Pooling functionals (port of paddle_tpu/nn/functional/pooling.py).

The reference lowers to ``lax.reduce_window``, outside any Pallas
kernel; the port pads with ``F.pad`` and calls torch's pooling with no
padding of its own, so that the reference's window rules hold where
torch's differ:

- ``ceil_mode`` extends the high pad by ``s - rem`` when the padded
  extent leaves a remainder ``rem`` (torch's ceil rule also drops a last
  window that starts in the padding);
- max pooling pads with -inf (``iinfo.min`` for integers, which go
  through strided windows: torch's max pooling takes no integer input
  on the card);
- average pooling sums (``divisor_override=1``) and divides by the
  count of input cells in the window when ``exclusive``, else by
  ``prod(k)``, the ceil extension included;
- ``return_mask`` is the flat index into the unpadded spatial extent of
  the window's first maximum;
- adaptive pooling reshapes where the window divides the extent, else
  takes the reference's ``floor`` / ``ceil`` window bounds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import op

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _tuple_n(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _pad_pairs(padding, n):
    if isinstance(padding, str):
        raise ValueError("string padding resolved by caller")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def _geometry(sp_shape, kernel, stride, padding, n, ceil_mode):
    """(k, s, [(lo, hi)] with the ceil extension) over the spatial dims."""
    k = _tuple_n(kernel, n)
    s = _tuple_n(stride if stride is not None else kernel, n)
    p = _pad_pairs(padding, n)
    pads = []
    for i in range(n):
        lo, hi = p[i]
        if ceil_mode:
            rem = (sp_shape[i] + lo + hi - k[i]) % s[i]
            if rem != 0:
                hi += s[i] - rem
        pads.append((lo, hi))
    return k, s, pads


def _flat_pad(pairs):
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _windows(x, k, s, n):
    """[N, C, *out, *k] strided windows of channel-first ``x``."""
    for i in range(n):
        x = x.unfold(2 + i, k[i], s[i])
    return x


def _sum_pool(x, k, s, n):
    """Window sums of channel-first, already padded ``x``: 1-D through
    2-D (avg_pool1d has no divisor_override)."""
    if n == 1:
        return TF.avg_pool2d(x.unsqueeze(2), (1,) + k, (1,) + s,
                             divisor_override=1).squeeze(2)
    fn = TF.avg_pool2d if n == 2 else TF.avg_pool3d
    return fn(x, k, s, divisor_override=1)


def _pool(x, kernel, stride, padding, n, channel_last, kind, ceil_mode=False,
          exclusive=True):
    if channel_last:
        x = x.permute(0, n + 1, *range(1, n + 1))
    k, s, pads = _geometry(x.shape[2:], kernel, stride, padding, n,
                           ceil_mode)
    flat = _flat_pad(pads)
    if kind == "max":
        if x.dtype.is_floating_point:
            out = _MAX[n](TF.pad(x, flat, value=-float("inf")), k, s)
        else:
            lo = torch.iinfo(x.dtype).min
            w = _windows(TF.pad(x, flat, value=lo), k, s, n)
            out = w.amax(dim=tuple(range(-n, 0)))
    else:
        summed = _sum_pool(TF.pad(x, flat), k, s, n)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = summed / _sum_pool(TF.pad(ones, flat), k, s, n)
        else:
            out = summed / float(np.prod(k))
    if channel_last:
        out = out.permute(0, *range(2, n + 2), 1)
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format, "max",
                    ceil_mode, return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, data_format, "max",
                    ceil_mode, return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, data_format, "max",
                    ceil_mode, return_mask=return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format, "avg",
                    ceil_mode, exclusive=exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, data_format, "avg",
                    ceil_mode, exclusive=exclusive,
                    divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, data_format, "avg",
                    ceil_mode, exclusive=exclusive,
                    divisor_override=divisor_override)


def _pool_nd(x, kernel, stride, padding, n, data_format, kind, ceil_mode,
             exclusive=True, return_mask=False, divisor_override=None):
    channel_last = data_format in ("NLC", "NHWC", "NDHWC")

    opname = f"{kind}_pool{n}d"

    @op(opname)
    def _impl(xx):
        out = _pool(xx, kernel, stride, padding, n, channel_last, kind,
                    ceil_mode, exclusive)
        if kind == "avg" and divisor_override is not None:
            k = _tuple_n(kernel, n)
            out = out * (float(np.prod(k)) / float(divisor_override))
        return out.to(xx.dtype)

    out = _impl(x)
    if return_mask:
        idx = _pool_argmax(x, kernel, stride, padding, n, channel_last,
                           ceil_mode)
        return out, idx
    return out


def _pool_argmax(x, kernel, stride, padding, n, channel_last, ceil_mode):
    """The flat index, into the unpadded spatial extent, of each window's
    first maximum (int32), over the same windows as the pooled output:
    the ceil extension included. (The reference's mask leaves the ceil
    extension out, so its mask has fewer windows than its output there:
    ROADMAP Queue 3, defect E.)"""

    @op("max_pool_mask", differentiable=False)
    def _impl(xx):
        if channel_last:
            xx = xx.permute(0, n + 1, *range(1, n + 1))
        sp = tuple(xx.shape[2:])
        k, s, pads = _geometry(sp, kernel, stride, padding, n, ceil_mode)
        flat = _flat_pad(pads)
        xp = TF.pad(xx.float(), flat, value=-float("inf"))
        _, idx = _MAX[n](xp, k, s, return_indices=True)
        # index into the padded extent -> index into the unpadded one
        padded = xp.shape[2:]
        out = torch.zeros_like(idx)
        rest = idx
        for i in reversed(range(n)):
            coord = rest % padded[i] - pads[i][0]
            rest = rest // padded[i]
            out = out + coord * int(np.prod(sp[i + 1:]))
        out = out.to(torch.int32)
        if channel_last:
            out = out.permute(0, *range(2, n + 2), 1)
        return out

    return _impl(x)


def _adaptive_pool(x, output_size, n, data_format, kind):
    channel_last = data_format in ("NLC", "NHWC", "NDHWC")
    out_sizes = _tuple_n(output_size, n)
    sp_axes = list(range(1, 1 + n)) if channel_last else \
        list(range(2, 2 + n))

    @op(f"adaptive_{kind}_pool{n}d")
    def _impl(xx):
        out = xx
        for i, ax in enumerate(sp_axes):
            out = _adaptive_axis(out, ax, out_sizes[i], kind)
        return out

    return _impl(x)


def _reduce(x, axis, kind):
    return torch.amax(x, dim=axis) if kind == "max" else \
        torch.mean(x, dim=axis)


def _adaptive_axis(x, axis, out_size, kind):
    in_size = x.shape[axis]
    if out_size is None or out_size == in_size:
        return x
    if in_size % out_size == 0:
        # uniform windows: reshape + reduce
        k = in_size // out_size
        xr = x.reshape(tuple(x.shape[:axis]) + (out_size, k)
                       + tuple(x.shape[axis + 1:]))
        return _reduce(xr, axis + 1, kind)
    # non-uniform: per-output-window slices
    starts = [int(np.floor(i * in_size / out_size)) for i in range(out_size)]
    ends = [int(np.ceil((i + 1) * in_size / out_size))
            for i in range(out_size)]
    pieces = [_reduce(x.narrow(axis, s, e - s), axis, kind)
              for s, e in zip(starts, ends)]
    return torch.stack(pieces, dim=axis)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, "NCDHW", "max")
