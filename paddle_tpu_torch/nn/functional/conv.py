"""Convolution functionals (port of paddle_tpu/nn/functional/conv.py).

The reference lowers to ``lax.conv_general_dilated``, outside any Pallas
kernel; the port calls torch's convolutions (cuDNN on the card) with the
reference's padding rules, which torch's own arguments do not all
express:

- ``padding="SAME"`` pads ``max((ceil(in / s) - 1) s + eff_k - in, 0)``
  in all, ``// 2`` low and the rest high, at any stride (torch's "same"
  refuses stride > 1);
- padding pairs may differ low and high (padded here with ``F.pad``);
- the transposed conv is the full transposed convolution (no padding)
  cropped by each pair and extended by ``output_padding`` on the high
  side (zeros beyond the full output), then cut to ``output_size``;
  its ``"SAME"`` is ``eff_k // 2`` on both sides, the reference's rule.

Weights keep the reference's layouts: ``[out, in / groups, *k]``, and
``[in, out / groups, *k]`` for the transposed conv (torch's own). The
channel-last forms (NLC, NHWC, NDHWC) permute to channel-first and back.
"""

from __future__ import annotations

import torch.nn.functional as TF

from ...core.dispatch import op

__all__ = [
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple_n(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    return v


def _padding_n(padding, n):
    """Normalize paddle padding (int | str | list) to [(lo, hi)] * n, or
    'SAME' / 'VALID'."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        # [before1, after1, before2, after2, ...]
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if len(padding) == n and all(isinstance(p, (list, tuple))
                                 for p in padding):
        return [tuple(p) for p in padding]
    raise ValueError(f"unsupported padding {padding!r}")


def _channel_last(data_format) -> bool:
    return data_format in ("NLC", "NHWC", "NDHWC")


def _to_cf(x, n):
    return x.permute(0, n + 1, *range(1, n + 1))


def _to_cl(x, n):
    return x.permute(0, *range(2, n + 2), 1)


def _flat_pad(pairs):
    """[(lo, hi)] over the spatial dims as F.pad's list (last dim first)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _add_bias(out, bias, n):
    if bias is None:
        return out
    return out + bias.reshape((1, -1) + (1,) * n)


def _conv_impl(x, weight, bias, stride, padding, dilation, groups, n,
               data_format):
    cl = _channel_last(data_format)
    if cl:
        x = _to_cf(x, n)
    strides = _tuple_n(stride, n)
    dil = _tuple_n(dilation, n)
    pad = _padding_n(padding, n)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        k = weight.shape[2:]
        pad = []
        for i in range(n):
            size = x.shape[2 + i]
            eff_k = dil[i] * (k[i] - 1) + 1
            total = max((-(-size // strides[i]) - 1) * strides[i] + eff_k
                        - size, 0)
            pad.append((total // 2, total - total // 2))
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x = TF.pad(x, _flat_pad(pad))
        sym = 0
    out = _add_bias(_CONV[n](x, weight, None, strides, sym, dil, groups),
                    bias, n)
    return _to_cl(out, n) if cl else out


@op("conv1d", amp="cast")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 1,
                      data_format)


@op("conv2d", amp="cast")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 2,
                      data_format)


@op("conv3d", amp="cast")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 3,
                      data_format)


def _conv_transpose_impl(x, weight, bias, stride, padding, output_padding,
                         dilation, groups, n, data_format, output_size=None):
    cl = _channel_last(data_format)
    if cl:
        x = _to_cf(x, n)
    strides = _tuple_n(stride, n)
    dil = _tuple_n(dilation, n)
    opad = _tuple_n(output_padding, n)
    pad = _padding_n(padding, n)
    k = weight.shape[2:]
    eff_k = [dil[i] * (k[i] - 1) + 1 for i in range(n)]
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = [(eff_k[i] // 2, eff_k[i] // 2) for i in range(n)]
    full = _CONV_T[n](x, weight, None, strides, 0, 0, groups, dil)
    # crop lo / hi, then output_padding zeros past the full output's end
    # (F.pad takes a negative pad as a crop)
    out = TF.pad(full, _flat_pad([(-lo, opad[i] - hi)
                                  for i, (lo, hi) in enumerate(pad)]))
    if output_size is not None:
        sizes = _tuple_n(output_size, n)
        out = out[(slice(None), slice(None))
                  + tuple(slice(0, s) for s in sizes)]
    out = _add_bias(out, bias, n)
    return _to_cl(out, n) if cl else out


@op("conv1d_transpose", amp="cast")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 1,
                                data_format, output_size)


@op("conv2d_transpose", amp="cast")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW"):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 2,
                                data_format, output_size)


@op("conv3d_transpose", amp="cast")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 3,
                                data_format, output_size)
