"""Elementwise, reduction, scan and product ops (port of
paddle_tpu/ops/math.py).

Each op is a torch impl registered through the funnel
(core/dispatch.py), which supplies autograd, AMP and the NaN/Inf check.
The impls compute the reference's functions, JAX's semantics included:
``median`` averages the two middle values, ``imag`` of a real tensor is
0, a Python scalar operand takes the tensor's dtype where JAX's weak
typing does.
"""

from __future__ import annotations

import torch

from ..core.dispatch import op, register_split_vjp
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor


def _lift(x, like):
    """A Python scalar operand as a tensor beside ``like``, typed as JAX
    types a weak scalar: an int takes ``like``'s dtype, a float takes a
    floating ``like``'s dtype and float32 otherwise."""
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(like, torch.Tensor):
        return torch.as_tensor(x)
    if isinstance(x, bool):
        dt = like.dtype
    elif isinstance(x, int):
        dt = like.dtype if like.dtype != torch.bool else torch.int64
    elif isinstance(x, float):
        dt = like.dtype if (like.dtype.is_floating_point
                            or like.dtype.is_complex) else torch.float32
    else:
        dt = None
    return torch.as_tensor(x, dtype=dt, device=like.device)


def _pair(x, y):
    return _lift(x, y), _lift(y, x)


# ---------------------------------------------------------------------------
# Unary elementwise (differentiable)
# ---------------------------------------------------------------------------


def _float(x):
    return x if (x.dtype.is_floating_point or x.dtype.is_complex) \
        else x.to(torch.float32)


def _imag(x):
    return torch.imag(x) if x.is_complex() else x - x


def _angle(x):
    if x.is_complex():
        return torch.angle(x)
    x = _float(x)
    return torch.atan2(torch.zeros_like(x), x)


_UNARY = {
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "neg": torch.neg,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "trunc": torch.trunc,
    "frac": lambda x: x - torch.trunc(x),
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "sigmoid": torch.sigmoid,
    "reciprocal": lambda x: 1.0 / x,
    "square": torch.square,
    "sign": torch.sign,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "lgamma": torch.lgamma,
    "digamma": torch.digamma,
    "i0": lambda x: torch.special.i0e(x) * torch.exp(torch.abs(x)),
    "i1": lambda x: torch.special.i1e(x) * torch.exp(torch.abs(x)),
    "angle": _angle,
    "conj": lambda x: torch.conj(x).resolve_conj() if x.is_complex() else x,
    "real": lambda x: torch.real(x) if x.is_complex() else x,
    "imag": _imag,
    "deg2rad": lambda x: torch.deg2rad(_float(x)),
    "rad2deg": lambda x: torch.rad2deg(_float(x)),
    "logit": lambda x: torch.log(x / (1.0 - x)),
}

for _name, _fn in _UNARY.items():
    globals()[_name] = op(_name)(lambda x, _f=_fn: _f(x))

arcsin, arccos, arctan = asin, acos, atan  # noqa: F821
arcsinh, arccosh, arctanh = asinh, acosh, atanh  # noqa: F821

_UNARY_PRED = {
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "logical_not": torch.logical_not,
    "bitwise_not": torch.bitwise_not,
}
for _name, _fn in _UNARY_PRED.items():
    globals()[_name] = op(_name, differentiable=False)(
        lambda x, _f=_fn: _f(x))


# ---------------------------------------------------------------------------
# Binary elementwise
# ---------------------------------------------------------------------------


def _heaviside(x, y):
    x, y = _pair(x, y)
    return torch.where(x < 0, torch.zeros_like(y),
                       torch.where(x > 0, torch.ones_like(y), y))


def _divide(x, y):
    x, y = _pair(x, y)
    return torch.true_divide(x, y)


def _floor_divide(x, y):
    x, y = _pair(x, y)
    if x.dtype.is_floating_point or y.dtype.is_floating_point:
        return torch.div(x, y, rounding_mode="floor")
    return torch.floor_divide(x, y)


_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "divide": _divide,
    "pow": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "fmax": torch.fmax,
    "fmin": torch.fmin,
    "atan2": torch.atan2,
    "hypot": torch.hypot,
    "copysign": torch.copysign,
    "heaviside": _heaviside,
    "logaddexp": torch.logaddexp,
}
for _name, _fn in _BINARY.items():
    globals()[_name] = op(_name)(lambda x, y, _f=_fn: _f(*_pair(x, y)))

_BINARY_NONDIFF = {
    "nextafter": torch.nextafter,
    "floor_divide": _floor_divide,
    "mod": torch.remainder,
    "remainder": torch.remainder,
    "floor_mod": torch.remainder,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "gcd": torch.gcd,
    "lcm": torch.lcm,
}
for _name, _fn in _BINARY_NONDIFF.items():
    globals()[_name] = op(_name, differentiable=False)(
        lambda x, y, _f=_fn: _f(*_pair(x, y)))


@op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    return out


@op("clip")
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op("multiplex", differentiable=False)
def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


@op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def _norm_axis(axis):
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis if axis is None else int(axis)


def _dims(x, axis):
    """The reduced dims as a tuple (all of them for None)."""
    ax = _norm_axis(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _over(x, axis, keepdim):
    """``x`` with the reduced dims moved last and flattened into one:
    (x2 [..., n], the output shape)."""
    nd = x.dim()
    dims = sorted(d % nd for d in _dims(x, axis)) if nd else []
    rest = [d for d in range(nd) if d not in dims]
    x2 = x.permute(*rest, *dims).reshape(
        *[x.shape[d] for d in rest], -1)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(nd)]
    else:
        shape = [x.shape[d] for d in rest]
    return x2, shape


@op("sum")
def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    dt = convert_dtype(dtype)
    if x.dtype == torch.bool and dt is None:
        dt = torch.int32
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dt)


@op("mean")
def mean(x, axis=None, keepdim=False):
    return torch.mean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


@op("prod")
def prod(x, axis=None, keepdim=False, dtype=None):
    x2, shape = _over(x, axis, keepdim)
    return torch.prod(x2, -1, dtype=convert_dtype(dtype)).reshape(shape)


@op("max")
def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op("min")
def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax, amin = max, min


@op("std")
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op("var")
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim):
    x2, shape = _over(_float(x), axis, keepdim)
    out = torch.quantile(x2, q, dim=-1)
    if isinstance(q, (float, int)) or getattr(q, "dim", lambda: 1)() == 0:
        return out.reshape(shape)
    return out.reshape(out.shape[:1] + tuple(shape))


@op("median")
def median(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim)


@op("quantile")
def quantile(x, q, axis=None, keepdim=False):
    if not isinstance(q, torch.Tensor) and isinstance(q, (list, tuple)):
        q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    return _quantile(x, q, axis, keepdim)


@op("nanmean")
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


@op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=convert_dtype(dtype))


@op("logsumexp")
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(_float(x), dim=_dims(x, axis), keepdim=keepdim)


@op("all", differentiable=False)
def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


@op("any", differentiable=False)
def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape([1] * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(convert_dtype(dtype))


@op("argmax", differentiable=False)
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@op("argmin", differentiable=False)
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@op("count_nonzero", differentiable=False)
def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------


@op("cumsum")
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cumsum(x, int(axis), dtype=convert_dtype(dtype))


@op("cumprod")
def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return torch.cumprod(x, int(dim), dtype=convert_dtype(dtype))


@op("cummax", differentiable=False)
def cummax(x, axis=-1):
    return torch.cummax(x, int(axis)).values


@op("cummin", differentiable=False)
def cummin(x, axis=-1):
    return torch.cummin(x, int(axis)).values


@op("logcumsumexp")
def logcumsumexp(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x, int(axis))


@op("diff")
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


# ---------------------------------------------------------------------------
# Matrix products
# ---------------------------------------------------------------------------


@op("matmul", amp="cast")
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def _matmul_splits(arrays, wslots) -> bool:
    """An activation times a 2-D leaf parameter."""
    return 1 in wslots and arrays[1].dim() == 2 and arrays[0].dim() >= 2


@register_split_vjp("matmul", _matmul_splits)
def _matmul_split_vjp(arrays, wslots, kwargs, cots):
    """The zero-bubble split of ``matmul``'s backward for an activation
    times a 2-D parameter: dx now, dy deferred (reference
    ops/math.py:338)."""
    extras = kwargs.get("_positional_extras") or []
    tx = kwargs.get("transpose_x", extras[0] if len(extras) > 0 else False)
    ty = kwargs.get("transpose_y", extras[1] if len(extras) > 1 else False)
    x, y = arrays[0], arrays[1]
    g = cots[0]
    xm = x.transpose(-1, -2) if tx else x          # [..., m, k]
    ym = y.t() if ty else y                        # [k, n]
    dxm = torch.matmul(g, ym.t())                  # [..., m, k]
    dx = (dxm.transpose(-1, -2) if tx else dxm).to(x.dtype)

    def wgrad():
        g2 = g.reshape(-1, g.shape[-1])
        x2 = xm.reshape(-1, xm.shape[-1])
        dym = torch.matmul(x2.t(), g2)             # [k, n]
        return {1: (dym.t() if ty else dym).to(y.dtype)}

    return [dx, None], wgrad


mm = matmul


@op("dot", amp="cast")
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op("inner", amp="cast")
def inner(x, y):
    return torch.inner(x, y)


@op("outer", amp="cast")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op("addmm", amp="cast")
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@op("kron")
def kron(x, y):
    return torch.kron(x, y)


@op("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op("cross")
def cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@op("bmm", amp="cast")
def bmm(x, y):
    return torch.matmul(x, y)


@op("mv", amp="cast")
def mv(x, vec):
    return torch.matmul(x, vec)


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------


@op("isclose", differentiable=False)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@op("allclose", differentiable=False)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@op("equal_all", differentiable=False)
def equal_all(x, y):
    x, y = _pair(x, y)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.eq(x, y).all()


@op("increment")
def increment(x, value=1.0):
    return x + value


def accuracy(input, label, k=1):
    """Top-k accuracy (reference: paddle.metric.accuracy)."""
    topk_idx = torch.argsort(-input._data, dim=-1, stable=True)[..., :k]
    lbl = label._data.reshape(-1, 1)
    correct = torch.any(topk_idx == lbl, dim=-1)
    return Tensor(correct.float().mean())


# ---------------------------------------------------------------------------
# Special functions / norms
# ---------------------------------------------------------------------------


@op("gammaln")
def gammaln(x):
    return torch.lgamma(x)


class _RegGamma(torch.autograd.Function):
    """Regularized incomplete gamma, lower (P) or upper (Q). torch
    differentiates it with respect to x only; the derivative with
    respect to the shape ``a`` (which JAX's ``igamma_grad_a`` gives) is
    taken here as a central difference in float64, step 1e-5 a, whose
    error (about 1e-10 relative) is far below float32's."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        f = torch.special.gammaincc if upper else torch.special.gammainc
        return f(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        f = torch.special.gammaincc if ctx.upper else torch.special.gammainc
        a64, x64 = a.double(), x.double()
        h = 1e-5 * a64.abs().clamp_min(1e-3)
        da = (f(a64 + h, x64) - f(a64 - h, x64)) / (2 * h)
        dx = torch.exp((a64 - 1) * torch.log(x64) - x64 - torch.lgamma(a64))
        if ctx.upper:
            dx = -dx
        ga = (g.double() * da).to(a.dtype)
        gx = (g.double() * dx).to(x.dtype)
        return ga, gx, None


@op("gammainc")
def gammainc(x, y):
    x, y = torch.broadcast_tensors(*_pair(x, y))
    return _RegGamma.apply(x, y, False)


@op("gammaincc")
def gammaincc(x, y):
    x, y = torch.broadcast_tensors(*_pair(x, y))
    return _RegGamma.apply(x, y, True)


@op("i0e")
def i0e(x):
    return torch.special.i0e(x)


@op("i1e")
def i1e(x):
    return torch.special.i1e(x)


@op("p_norm")
def p_norm(x, porder=2.0, axis=None, epsilon=1e-12, keepdim=False,
           as_vector=False):
    ax = _norm_axis(axis)
    if as_vector or ax is None:
        x = x.reshape(-1)
        ax = 0
    if porder == float("inf"):
        return torch.amax(torch.abs(x), dim=ax, keepdim=keepdim)
    if porder == float("-inf"):
        return torch.amin(torch.abs(x), dim=ax, keepdim=keepdim)
    if porder == 0:
        return torch.sum((x != 0).to(x.dtype), dim=ax, keepdim=keepdim)
    s = torch.sum(torch.abs(x) ** porder, dim=ax, keepdim=keepdim)
    return s ** (1.0 / porder)


@op("clip_by_norm")
def clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@op("squared_l2_norm")
def squared_l2_norm(x):
    return torch.sum(torch.square(x)).reshape(())


@op("l1_norm")
def l1_norm(x):
    return torch.sum(torch.abs(x)).reshape(())


@op("reduce_as")
def reduce_as(x, target):
    tshape = tuple(target.shape)
    xshape = tuple(x.shape)
    nd = len(xshape) - len(tshape)
    axes = tuple(range(nd)) + tuple(
        nd + i for i, (a, b) in enumerate(zip(xshape[nd:], tshape))
        if b == 1 and a != 1)
    out = torch.sum(x, dim=axes) if axes else x
    return out.reshape(tshape)



__all__ = sorted(n for n, v in list(globals().items())
                 if not n.startswith("_") and callable(v)
                 and getattr(v, "__module__", None) == __name__)
