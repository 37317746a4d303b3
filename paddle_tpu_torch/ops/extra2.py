"""The op library's long tail, part two: stacking and splitting, the
scatter-into views, predicates, the remaining math, ``view``, and the
in-place family (port of paddle_tpu/ops/extra2.py).

The in-place variants (``x.add_(y)``, ``paddle.sinc_(x)``) are built by
``ops/__init__.py``'s ``make_inplace_wrapper`` over the names of
``INPLACE_SOURCES`` (the reference's list) that the namespace has. The
random fills draw from the package's generator: the reference's
distributions, torch's bits.
"""

from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from ..core import random as prandom
from ..core.dispatch import op
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_torch
from .extra import _nanquantile
from .linalg import _linspace

__all__ = [
    "add_n", "broadcast_shape", "cartesian_prod", "combinations",
    "column_stack", "row_stack", "dstack", "hsplit", "vsplit", "dsplit",
    "tensor_split", "diagonal_scatter", "select_scatter", "slice_scatter",
    "frexp", "ldexp", "histogram_bin_edges", "histogramdd", "isin",
    "isneginf", "isposinf", "is_complex", "is_floating_point",
    "is_integer", "is_tensor", "log_normal", "multigammaln", "nanquantile",
    "polar", "randint_like", "rank", "reverse", "sgn", "sinc", "shape",
    "tolist", "vander", "view", "view_as", "unfold",
    "normal_", "bernoulli_", "cauchy_", "geometric_", "log_normal_",
    "bitwise_left_shift", "bitwise_right_shift", "check_shape",
]


def _data(t):
    return t._data if isinstance(t, Tensor) else as_torch(t)


def _gen(device):
    return prandom.default_generator().torch_generator(device)


@op("add_n")
def add_n(inputs):
    """Sum of a list of tensors (the reference's add_n)."""
    arrs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    out = arrs[0]
    for a in arrs[1:]:
        out = out + a
    return out


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op("cartesian_prod")
def cartesian_prod(xs):
    grids = torch.meshgrid(*[a.reshape(-1) for a in xs], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


@op("combinations")
def combinations(x, r: int = 2, with_replacement: bool = False):
    combo = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = torch.as_tensor(list(combo(range(x.shape[0]), r)),
                          dtype=torch.long, device=x.device).reshape(-1, r)
    return x[idx]


@op("column_stack")
def column_stack(xs):
    return torch.cat([a if a.ndim > 1 else a.reshape(-1, 1) for a in xs],
                     dim=1)


@op("row_stack")
def row_stack(xs):
    return torch.vstack(list(xs))


@op("dstack")
def dstack(xs):
    return torch.dstack(list(xs))


def _split(x, n, axis):
    """jnp.split: an int divides the axis evenly (or raises), a list
    gives the cut indices."""
    if isinstance(n, int):
        if x.shape[axis] % n:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(x, n, dim=axis))
    return tuple(torch.tensor_split(x, list(n), dim=axis))


@op("hsplit")
def _hsplit_impl(x, num_or_indices):
    return _split(x, num_or_indices, 1 if x.ndim > 1 else 0)


@op("vsplit")
def _vsplit_impl(x, num_or_indices):
    return _split(x, num_or_indices, 0)


@op("dsplit")
def _dsplit_impl(x, num_or_indices):
    return _split(x, num_or_indices, 2)


@op("tensor_split")
def _tensor_split_impl(x, num_or_indices, axis):
    n = num_or_indices if isinstance(num_or_indices, int) \
        else list(num_or_indices)
    return tuple(torch.tensor_split(x, n, dim=axis))


def hsplit(x, num_or_indices, name=None):
    return list(_hsplit_impl(x, num_or_indices))


def vsplit(x, num_or_indices, name=None):
    return list(_vsplit_impl(x, num_or_indices))


def dsplit(x, num_or_indices, name=None):
    return list(_dsplit_impl(x, num_or_indices))


def tensor_split(x, num_or_indices, axis=0, name=None):
    """Uneven splits allowed (the reference's tensor_split)."""
    return list(_tensor_split_impl(x, num_or_indices, axis))


@op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(x, offset, axis1, axis2)
    return torch.diagonal_scatter(x, torch.as_tensor(y).to(x.dtype)
                                  .expand(d.shape), offset, axis1, axis2)


@op("select_scatter")
def select_scatter(x, values, axis, index):
    idx = [slice(None)] * x.ndim
    idx[axis] = index.long() if isinstance(index, torch.Tensor) else index
    out = x.clone()
    out[tuple(idx)] = values
    return out


@op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    idx = [slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sd)
    out = x.clone()
    out[tuple(idx)] = value
    return out


@op("frexp")
def frexp(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@op("ldexp")
def ldexp(x, y):
    # x · 2^y in x's dtype; torch.ldexp's gradient takes 2^y in integer
    # arithmetic, 0 for a negative exponent
    e = y.to(torch.int32).to(x.dtype)
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         e)


@op("histogram_bin_edges", differentiable=False)
def histogram_bin_edges(input, bins=100, min=0.0, max=0.0,  # noqa: A002
                        name=None):
    if min == 0 and max == 0:
        lo, hi = input.min(), input.max()
    else:
        lo = torch.as_tensor(min, device=input.device)
        hi = torch.as_tensor(max, device=input.device)
    dt = input.dtype if input.dtype.is_floating_point else torch.float32
    return _linspace(lo.to(dt), hi.to(dt), bins + 1, dt).to(torch.float32)


def _np_linspace(lo, hi, num):
    """numpy's float64 linspace: start + i · step, the last point exact."""
    step = (hi - lo) / (num - 1)
    out = torch.arange(num, dtype=torch.float64, device=lo.device) * step \
        + lo
    out[-1] = hi
    return out


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """The reference's histogramdd (numpy's): float64 edges, a sample
    on a last edge counted in the last bin, float32 results."""
    xs = _data(x).to(torch.float64)
    xs = xs.reshape(-1, xs.shape[-1])
    n, D = xs.shape
    if isinstance(bins, (list, tuple)) and len(bins) and \
            not isinstance(bins[0], (int, np.integer)):
        edges = [_data(b).to(torch.float64) for b in bins]
    else:
        nb = [int(bins)] * D if isinstance(bins, (int, np.integer)) \
            else [int(b) for b in bins]
        edges = []
        for d in range(D):
            if ranges is not None:
                lo = torch.tensor(float(ranges[d][0]), dtype=torch.float64,
                                  device=xs.device)
                hi = torch.tensor(float(ranges[d][1]), dtype=torch.float64,
                                  device=xs.device)
            else:
                lo, hi = (xs[:, d].min(), xs[:, d].max()) if n else (
                    torch.zeros((), dtype=torch.float64, device=xs.device),
                    torch.ones((), dtype=torch.float64, device=xs.device))
                flat = lo == hi
                lo = torch.where(flat, lo - 0.5, lo)
                hi = torch.where(flat, hi + 0.5, hi)
            edges.append(_np_linspace(lo, hi, nb[d] + 1))
    sizes = [e.numel() + 1 for e in edges]
    flat_idx = torch.zeros(n, dtype=torch.long, device=xs.device)
    for d, e in enumerate(edges):
        idx = torch.searchsorted(e, xs[:, d].contiguous(), right=True)
        idx = idx - (xs[:, d] == e[-1]).long()
        flat_idx = flat_idx * sizes[d] + idx
    w = torch.ones(n, dtype=torch.float64, device=xs.device) \
        if weights is None else _data(weights).reshape(-1).to(torch.float64)
    total = int(np.prod(sizes))
    hist = torch.zeros(total, dtype=torch.float64, device=xs.device) \
        .index_add_(0, flat_idx, w).reshape(sizes)
    hist = hist[(slice(1, -1),) * D]
    if density:
        s = hist.sum()
        for d, e in enumerate(edges):
            shape = [1] * D
            shape[d] = -1
            hist = hist / torch.diff(e).reshape(shape)
        hist = hist / s
    return (Tensor(hist.to(torch.float32)),
            [Tensor(e.to(torch.float32)) for e in edges])


@op("isin", differentiable=False)
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, invert=invert)


@op("isneginf", differentiable=False)
def isneginf(x):
    return torch.isneginf(x)


@op("isposinf", differentiable=False)
def isposinf(x):
    return torch.isposinf(x)


def _dtype_of(x):
    return _data(x).dtype


def is_complex(x) -> bool:
    return _dtype_of(x).is_complex


def is_floating_point(x) -> bool:
    return _dtype_of(x).is_floating_point


def is_integer(x) -> bool:
    dt = _dtype_of(x)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def log_normal(mean=1.0, std=2.0, shape=None, dtype="float32", name=None):
    """exp(Normal(mean, std)) samples (the reference's log_normal)."""
    from ..core.device import current_device

    dev = current_device()
    z = torch.randn(tuple(shape or ()), dtype=convert_dtype(dtype),
                    device=dev, generator=_gen(dev))
    return Tensor(torch.exp(mean + std * z), stop_gradient=True)


@op("multigammaln")
def multigammaln(x, p: int):
    i = torch.arange(p, dtype=torch.float32, device=x.device)
    return (p * (p - 1) / 4.0) * _math.log(_math.pi) + \
        torch.sum(torch.lgamma(x[..., None] - i / 2.0), dim=-1)


@op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    from .math import _norm_axis

    return _nanquantile(x, q, _norm_axis(axis), keepdim, interpolation)


@op("polar")
def polar(abs, angle, name=None):  # noqa: A002
    return torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    from .creation import randint

    return randint(low, high, shape=tuple(x.shape),
                   dtype=dtype or str(x.dtype).replace("torch.", ""))


def rank(input):  # noqa: A002
    return Tensor(torch.tensor(len(input.shape), dtype=torch.int32,
                               device=_data(input).device),
                  stop_gradient=True)


@op("reverse")
def reverse(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@op("sgn")
def sgn(x):
    return torch.sgn(x)


@op("sinc")
def sinc(x):
    return torch.sinc(x)


def shape(input):  # noqa: A002
    """The runtime shape as an int32 tensor (the reference's shape op)."""
    return Tensor(torch.tensor(list(input.shape), dtype=torch.int32,
                               device=_data(input).device),
                  stop_gradient=True)


def tolist(x):
    return _data(x).tolist()


@op("vander")
def vander(x, n=None, increasing=False, name=None):
    m = x.shape[0] if n is None else n
    powers = torch.arange(m, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return x[:, None] ** powers[None, :]


@op("view_dtype")
def _view_dtype(x, dtype):
    """A bitcast: widening packs the last dimension, narrowing widens it
    (torch's ``Tensor.view(dtype)`` rule, the reference's)."""
    target = convert_dtype(dtype)
    ratio = torch.empty((), dtype=target).element_size()
    if ratio > x.element_size() and x.shape[-1] % (
            ratio // x.element_size()):
        raise ValueError(
            f"view: last dim {x.shape[-1]} not divisible by the width "
            f"ratio {ratio // x.element_size()}")
    return x.contiguous().view(target).clone()


def view(x, shape_or_dtype, name=None):
    """A reshape (shape) or a bitcast (dtype) of the same elements."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(list(shape_or_dtype))
    return _view_dtype(x, shape_or_dtype)


def view_as(x, other, name=None):
    return x.reshape(list(other.shape))


@op("tensor_unfold")
def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``: the window count at ``axis``, the
    window last (the reference's Tensor.unfold)."""
    return x.unfold(axis % x.ndim, size, step).clone()


# ---------------------------------------------------------------------------
# in-place variants: x.op_(...) == x rebound to op(x, ...)'s output (the
# reference generates them from ops.yaml ``inplace:`` entries); built by
# ops/__init__.py
# ---------------------------------------------------------------------------

INPLACE_SOURCES = (
    "abs", "acos", "asin", "atan", "atanh", "cast", "ceil", "clip",
    "copysign", "cos", "cosh", "cumprod", "cumsum", "digamma", "divide",
    "equal", "erf", "erfinv", "exp", "expm1", "fill", "flatten", "floor",
    "floor_divide", "floor_mod", "frac", "gammainc", "gammaincc",
    "gammaln", "gcd", "greater_equal", "greater_than", "hypot", "i0",
    "lcm", "ldexp", "less_equal", "less_than", "lgamma", "log", "log10",
    "log1p", "log2", "logical_and", "logical_not", "logical_or",
    "logical_xor", "logit", "masked_fill", "masked_scatter", "maximum",
    "minimum", "mod", "multiply", "nan_to_num", "neg", "pow", "reciprocal",
    "remainder", "renorm", "reshape", "round", "rsqrt", "scale", "scatter",
    "sigmoid", "sign", "sin", "sinh", "sqrt", "square", "squeeze",
    "subtract", "t", "tan", "tanh", "transpose", "tril", "triu", "trunc",
    "unsqueeze", "add", "bitwise_and", "bitwise_not",
    "bitwise_or", "bitwise_xor", "polygamma", "multigammaln", "sinc",
    "addmm", "bitwise_left_shift", "bitwise_right_shift",
)


# ---------------------------------------------------------------------------
# in-place random fills (reference: Tensor.normal_ / uniform_ / ...)
# ---------------------------------------------------------------------------

def _fill_inplace(x, arr):
    """Write the draw into ``x``. A leaf is written in place; a tape
    tensor is rebound, since the earlier computation no longer produces
    its value."""
    d = x._data
    arr = arr.to(d.dtype)
    if d.grad_fn is None:
        with torch.no_grad():
            d.copy_(arr)
        return x
    x._data = arr.detach().requires_grad_(d.requires_grad)
    x._hooked = None
    x._attach_hooks()
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    d = _data(x)
    z = torch.randn(d.shape, dtype=torch.float32, device=d.device,
                    generator=_gen(d.device))
    return _fill_inplace(x, mean + std * z)


def bernoulli_(x, p=0.5, name=None):
    d = _data(x)
    u = torch.rand(d.shape, device=d.device, generator=_gen(d.device))
    return _fill_inplace(x, (u < p).float())


def _open_uniform(d):
    u = torch.rand(d.shape, device=d.device, generator=_gen(d.device))
    return u * (1 - 2e-7) + 1e-7


def cauchy_(x, loc=0.0, scale=1.0, name=None):
    u = _open_uniform(_data(x))
    return _fill_inplace(x, loc + scale * torch.tan(_math.pi * (u - 0.5)))


def geometric_(x, probs=0.5, name=None):
    u = _open_uniform(_data(x))
    return _fill_inplace(
        x, torch.floor(torch.log(u) / _math.log1p(-probs)) + 1)


def log_normal_(x, mean=1.0, std=2.0, name=None):
    d = _data(x)
    z = torch.randn(d.shape, dtype=torch.float32, device=d.device,
                    generator=_gen(d.device))
    return _fill_inplace(x, torch.exp(mean + std * z))


@op("bitwise_left_shift", differentiable=False)
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(x, y)


@op("bitwise_right_shift", differentiable=False)
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    if is_arithmetic:
        return torch.bitwise_right_shift(x, y)
    # logical: the sign bits shifted in are masked off
    bits = torch.iinfo(x.dtype).bits
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    mask = (torch.ones_like(y) << (bits - y).clamp_max(bits - 1)) - 1
    return torch.where(y == 0, x, torch.bitwise_right_shift(x, y) & mask)


def check_shape(shape):
    """Validate a shape spec (the reference's check_shape)."""
    for d in shape:
        if not isinstance(d, (int, np.integer)) or (d < -1):
            raise ValueError(f"invalid shape entry {d}")
    return True
