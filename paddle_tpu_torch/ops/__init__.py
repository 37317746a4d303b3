"""The eager op library: creation, math, manipulation, linalg, the long
tail (extra, extra2, parity), and the Tensor method install (port of
paddle_tpu/ops/__init__.py).

Every public op is exported here; the operator dunders, a hand-written
method table, the in-place variants (``x.add_(y)``) and every name of
the reference's method surface (``method_table.TENSOR_METHODS``) whose
function the port has are installed on ``Tensor``. The kernel wrappers
live in ``ops/kernels``.
"""

from __future__ import annotations

import torch as _torch

from ..core import autograd as _autograd
from ..core.tensor import Tensor
from . import creation, extra, extra2, linalg, manipulation, math, parity
from .creation import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .extra2 import *  # noqa: F401,F403
from .parity import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import slice  # noqa: F401,A004
from .math import abs, all, any, max, min, pow, sum  # noqa: F401,A004
from .method_table import TENSOR_METHODS


def make_inplace_wrapper(fn, name=None):
    """In-place variant of ``fn``: the op consumes an alias of the tensor
    before the write and the handle takes the result. A leaf is written
    in place (it keeps its identity); a leaf that requires grad refuses
    while grad is on."""

    def inplace(s, *a, **k):
        d = s._data
        if d.grad_fn is None and d.requires_grad and \
                _autograd.is_grad_enabled():
            raise RuntimeError(
                "in-place operation on a leaf tensor that requires grad "
                "is not allowed; wrap it in paddle_tpu_torch.no_grad() or "
                "use the out-of-place op")
        out = fn(Tensor(d, stop_gradient=not d.requires_grad), *a, **k)
        o = out._data
        if d.grad_fn is None and o.shape == d.shape and o.dtype == d.dtype \
                and not o.requires_grad:
            with _torch.no_grad():
                d.copy_(o)
        else:
            s._data = o
            s._hooked = None
            s._attach_hooks()
        return s

    inplace.__name__ = name or (getattr(fn, "__name__", "op") + "_")
    return inplace


def _install_inplace_variants(namespace: dict) -> None:
    """The in-place variants the reference generates
    (``extra2.INPLACE_SOURCES``), for the names the namespace has, and
    ``where_``."""
    for base in extra2.INPLACE_SOURCES:
        fn = namespace.get(base)
        if fn is not None:
            namespace[base + "_"] = make_inplace_wrapper(fn, base + "_")

    def where_(condition, x, y, name=None):
        return make_inplace_wrapper(
            lambda xx: manipulation.where(condition, xx, y), "where_")(x)

    namespace["where_"] = where_


_install_inplace_variants(globals())


def _setitem(s, item, value):
    """In-place write: a leaf is written in place outside the tape; a
    tape tensor takes the written copy, so gradients flow through the
    kept entries."""
    v = value._data if isinstance(value, Tensor) else value
    d = s._data
    item = manipulation._unwrap_index(item)
    if d.grad_fn is None:
        with _torch.no_grad():
            d.copy_(manipulation._set_index(d, item, v))
        return
    s._data = manipulation._set_index(d, item, v)


def _install_tensor_methods():
    T = Tensor

    T.__add__ = lambda s, o: math.add(s, o)
    T.__radd__ = lambda s, o: math.add(o, s)
    T.__sub__ = lambda s, o: math.subtract(s, o)
    T.__rsub__ = lambda s, o: math.subtract(o, s)
    T.__mul__ = lambda s, o: math.multiply(s, o)
    T.__rmul__ = lambda s, o: math.multiply(o, s)
    T.__truediv__ = lambda s, o: math.divide(s, o)
    T.__rtruediv__ = lambda s, o: math.divide(o, s)
    T.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    T.__rfloordiv__ = lambda s, o: math.floor_divide(o, s)
    T.__mod__ = lambda s, o: math.mod(s, o)
    T.__pow__ = lambda s, o: math.pow(s, o)
    T.__rpow__ = lambda s, o: math.pow(o, s)
    T.__matmul__ = lambda s, o: math.matmul(s, o)
    T.__rmatmul__ = lambda s, o: math.matmul(o, s)
    T.__neg__ = lambda s: math.neg(s)
    T.__abs__ = lambda s: math.abs(s)
    T.__invert__ = lambda s: math.logical_not(s)
    T.__eq__ = lambda s, o: math.equal(s, o)
    T.__ne__ = lambda s, o: math.not_equal(s, o)
    T.__lt__ = lambda s, o: math.less_than(s, o)
    T.__le__ = lambda s, o: math.less_equal(s, o)
    T.__gt__ = lambda s, o: math.greater_than(s, o)
    T.__ge__ = lambda s, o: math.greater_equal(s, o)
    T.__and__ = lambda s, o: math.logical_and(s, o)
    T.__or__ = lambda s, o: math.logical_or(s, o)
    T.__xor__ = lambda s, o: math.logical_xor(s, o)
    T.__getitem__ = lambda s, item: manipulation.getitem(s, item)
    T.__setitem__ = _setitem

    method_table = {
        "add": math.add, "subtract": math.subtract,
        "multiply": math.multiply, "divide": math.divide, "pow": math.pow,
        "matmul": math.matmul, "mm": math.matmul, "bmm": math.bmm,
        "dot": math.dot, "mv": math.mv, "exp": math.exp, "log": math.log,
        "log2": math.log2, "sqrt": math.sqrt, "rsqrt": math.rsqrt,
        "abs": math.abs, "floor": math.floor, "ceil": math.ceil,
        "round": math.round, "sign": math.sign, "sin": math.sin,
        "cos": math.cos, "tan": math.tan, "tanh": math.tanh,
        "sigmoid": math.sigmoid, "square": math.square, "erf": math.erf,
        "neg": math.neg, "reciprocal": math.reciprocal, "clip": math.clip,
        "scale": math.scale, "lerp": math.lerp,
        "sum": math.sum, "mean": math.mean, "prod": math.prod,
        "max": math.max, "min": math.min, "amax": math.amax,
        "amin": math.amin, "std": math.std, "var": math.var,
        "median": math.median, "logsumexp": math.logsumexp,
        "all": math.all, "any": math.any, "argmax": math.argmax,
        "argmin": math.argmin, "cumsum": math.cumsum,
        "cumprod": math.cumprod, "isnan": math.isnan, "isinf": math.isinf,
        "isfinite": math.isfinite, "equal": math.equal,
        "not_equal": math.not_equal, "less_than": math.less_than,
        "less_equal": math.less_equal, "greater_than": math.greater_than,
        "greater_equal": math.greater_equal,
        "logical_and": math.logical_and, "logical_or": math.logical_or,
        "logical_not": math.logical_not, "logical_xor": math.logical_xor,
        "maximum": math.maximum, "minimum": math.minimum,
        "allclose": math.allclose, "isclose": math.isclose,
        "equal_all": math.equal_all, "trace": math.trace,
        "kron": math.kron, "mod": math.mod, "remainder": math.remainder,
        "floor_divide": math.floor_divide,
        "cast": manipulation.cast, "astype": manipulation.cast,
        "transpose": manipulation.transpose, "t": manipulation.t,
        "squeeze": manipulation.squeeze,
        "unsqueeze": manipulation.unsqueeze,
        "flatten": manipulation.flatten, "tile": manipulation.tile,
        "expand": manipulation.expand, "expand_as": manipulation.expand_as,
        "broadcast_to": manipulation.broadcast_to,
        "flip": manipulation.flip, "roll": manipulation.roll,
        "gather": manipulation.gather, "gather_nd": manipulation.gather_nd,
        "scatter": manipulation.scatter,
        "index_select": manipulation.index_select,
        "index_sample": manipulation.index_sample,
        "take_along_axis": manipulation.take_along_axis,
        "put_along_axis": manipulation.put_along_axis,
        "masked_select": manipulation.masked_select,
        "masked_fill": manipulation.masked_fill,
        "nonzero": manipulation.nonzero, "unique": manipulation.unique,
        "sort": manipulation.sort, "argsort": manipulation.argsort,
        "topk": manipulation.topk, "split": manipulation.split,
        "chunk": manipulation.chunk, "unbind": manipulation.unbind,
        "pad": manipulation.pad,
        "repeat_interleave": manipulation.repeat_interleave,
        "tril": creation.tril, "triu": creation.triu,
        "where": manipulation.where, "clone": creation.clone,
        "norm": linalg.norm, "inverse": linalg.inverse,
        "cholesky": linalg.cholesky, "matrix_power": linalg.matrix_power,
        "det": linalg.det,
    }
    for name, fn in method_table.items():
        setattr(T, name, fn)

    def _reshape(s, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = shape[0]
        return manipulation.reshape(s, list(shape))

    T.reshape = _reshape
    T.reshape_ = lambda s, *shape: s.set_value(_reshape(s, *shape))

    for name in ("add", "subtract", "multiply", "scale", "clip"):
        setattr(T, name + "_", make_inplace_wrapper(method_table[name]))

    def _fill(s, fn):
        with _torch.no_grad():
            fn(s._data)
        return s

    T.zero_ = lambda s: _fill(s, lambda d: d.zero_())
    T.fill_ = lambda s, v: _fill(s, lambda d: d.fill_(v))
    T.exponential_ = lambda s, lam=1.0: creation.exponential_(s, lam)

    @property
    def _T(s):
        return manipulation.t(s) if s.ndim == 2 else \
            manipulation.transpose(s)

    T.T = _T

    def _item(s, *args):
        d = s._data
        return d[args].item() if args else d.item()

    T.item = _item


def _install_reference_method_surface() -> None:
    """Bind every reference Tensor-method name to the same-named function
    of this namespace (tensor first), unless Tensor already has it."""
    g = globals()
    for name in TENSOR_METHODS:
        if hasattr(Tensor, name):
            continue
        fn = g.get(name)
        if fn is None or not callable(fn) or isinstance(fn, type):
            continue

        def method(s, *a, _fn=fn, **k):
            return _fn(s, *a, **k)

        method.__name__ = name
        setattr(Tensor, name, method)


_install_tensor_methods()
_install_reference_method_surface()
# the reference's method names the port does not install: ``stft`` and
# ``istft`` (signal.py, not ported yet) and the eight the reference's own
# Tensor lacks (acosh_, asinh_, index_fill_, index_put_, lerp_,
# not_equal_, put_along_axis_, uniform_)
MISSING_METHODS = tuple(n for n in TENSOR_METHODS if not hasattr(Tensor, n))
