"""Every op of the port's ops/math.py and ops/manipulation.py, and every
function of ops/creation.py, against the reference's.

The cases come from the reference's own op contracts
(``artifacts/op_contracts.json``): each op's required arguments, the
array ones with the contract's shapes and dtypes (``case.in``, numpy
data from a seed, float data inside the op's domain, integer data in
[0, 2) so that it indexes every contract shape), the static ones with
the contract's values (``case.static``). Where a contract has no case
(``opaque``) or its case does not run on concrete data, the case is
written here. The bar: fp32 outputs within rtol 1e-6 (and 1e-6 of the
output's largest magnitude, for entries that cancel to ~0), integer and
boolean outputs exact, and, for a differentiable op, the vjp of a seeded
cotangent within rtol 1e-5. Each ported op's ``differentiable`` and AMP
policy equal the reference's registration, and the ported names are the
reference's.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dispatch import OpDef as RefOpDef
from paddle_tpu_torch.core.dispatch import OpDef as PortOpDef

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401

port.set_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
CONTRACTS = json.loads((ROOT / "artifacts" / "op_contracts.json")
                       .read_text())["ops"]
FWD_RTOL = 1e-6
VJP_RTOL = 1e-5


def _wrappers(mod):
    return {v.op_name: v for v in vars(mod).values()
            if hasattr(v, "op_name")
            and getattr(v, "__module__", None) == mod.__name__}


def _opdef(wrapper, cls):
    return next(c.cell_contents for c in wrapper.__closure__
                if isinstance(c.cell_contents, cls))


REF_OPS = {**_wrappers(ref.ops.math), **_wrappers(ref.ops.manipulation)}
PORT_OPS = {**_wrappers(port.ops.math), **_wrappers(port.ops.manipulation)}

# float data inside each op's domain (default: standard normal)
_POSITIVE = {"log", "log2", "log10", "log1p", "sqrt", "rsqrt", "gammainc",
             "gammaincc", "pow", "p_norm"}
# away from the roots of lgamma (1, 2) and digamma (1.46), where two
# independent approximations agree in absolute, not relative, terms
_GAMMA = {"lgamma", "gammaln", "digamma"}
_UNIT = {"asin", "acos", "atanh", "erfinv"}


def _data(name, spec, rng):
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", spec)
    dt, shape = m.group(1), tuple(int(s) for s in m.group(2).split(",") if s)
    if dt == "i32":
        return rng.integers(0, 2, shape).astype(np.int32)
    if name in _POSITIVE:
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if name in _GAMMA:
        return rng.uniform(2.5, 5.0, shape).astype(np.float32)
    if name in _UNIT:
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if name == "acosh":
        return rng.uniform(1.1, 3.0, shape).astype(np.float32)
    if name == "logit":
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _required(impl):
    import inspect

    out = []
    for p in inspect.signature(impl).parameters.values():
        if p.kind is p.VAR_POSITIONAL and not out:
            out += ["args0", "args1"]
        elif p.default is inspect.Parameter.empty and p.kind in (
                p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            out.append(p.name)
    return out


def _contract_case(name, rng):
    """(args, kwargs) templates: numpy arrays stand for tensors."""
    c = CONTRACTS[name]["case"]
    arrays = iter(_data(name, s, rng) for s in c["in"])
    static = {k: ast.literal_eval(v) for k, v in c["static"].items()}
    impl = _opdef(REF_OPS[name], RefOpDef).impl
    return [static[p] if p in static else next(arrays)
            for p in _required(impl)], {}


def _f(*shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _i(*vals):
    return np.asarray(vals, np.int32)


# Cases written here: the contract has none (opaque), or its abstract case
# does not run on data (a float index, a length-dependent section count).
MANUAL = {
    "multiplex": lambda: ([[_f(3, 2), _f(3, 2, seed=1)],
                           _i(1, 0, 1).reshape(3, 1)], {}),
    "moveaxis": lambda: ([_f(2, 3, 4), 0, 2], {}),
    "swapaxes": lambda: ([_f(2, 3, 4), 0, 2], {}),
    "scatter_nd_add": lambda: ([_f(4, 3), _i(1, 3, 1).reshape(3, 1),
                                _f(3, 3, seed=1)], {}),
    "scatter_nd": lambda: ([_i(0, 2).reshape(2, 1), _f(2, 3), [4, 3]], {}),
    "index_add": lambda: ([_f(4, 3), _i(0, 2, 2), 0, _f(3, 3, seed=1)], {}),
    "where": lambda: ([_f(2, 3) > 0, _f(2, 3, seed=1), _f(2, 3, seed=2)],
                      {}),
    "pad": lambda: ([_f(2, 3, 4), [1, 2, 0, 1]], {"mode": "reflect"}),
    "slice": lambda: ([_f(4, 5), [0, 1], [1, 1], [3, 4]], {}),
    "strided_slice": lambda: ([_f(4, 6), [0, 1], [3, 5], [0, 0], [-1, -2]],
                              {}),
    "crop": lambda: ([_f(4, 5), [2, 3], [1, 2]], {}),
    "as_strided": lambda: ([_f(12), [3, 2], [2, 3], 1], {}),
    "tensor_getitem": lambda: ([_f(4, 3), _i(3, 0, 1)],
                               {"template": (None, slice(0, 2))}),
    "temporal_shift": lambda: ([_f(4, 4, 2, 2), 2], {}),
    "put_along_axis": lambda: ([_f(3, 4), _i(1, 0, 2).reshape(3, 1),
                                _f(3, 1, seed=1), 1], {"reduce": "add"}),
    "scatter": lambda: ([_f(4, 3), _i(2, 0), _f(2, 3, seed=1)], {}),
    "getitem": lambda: ([_f(4, 5), (slice(None, None, -1), _i(0, 4, 2))],
                        {}),
    "setitem": lambda: ([_f(4, 5), (slice(1, 3), slice(None, None, -2)),
                         _f(2, 3, seed=1)], {}),
    "gather": lambda: ([_f(4, 3), _i(3, 1, 1)], {}),
    "index_sample": lambda: ([_f(3, 4), _i(0, 3, 1, 2, 0, 0).reshape(3, 2)],
                             {}),
    "gather_nd": lambda: ([_f(3, 4), _i(0, 1, 2, 3).reshape(2, 2)], {}),
    "fill_diagonal": lambda: ([_f(3, 4), 0.5], {"offset": 1}),
    "diag_embed": lambda: ([_f(2, 3)], {"offset": -1, "dim1": 0,
                                        "dim2": 2}),
    "cross": lambda: ([_f(4, 3), _f(4, 3, seed=1)], {}),
    "median": lambda: ([_f(3, 4)], {"axis": 1}),
    "quantile": lambda: ([_f(3, 5)], {"q": 0.3, "axis": 1}),
    "repeat_interleave": lambda: ([_f(3, 2), 2], {"axis": 0}),
    "kthvalue": lambda: ([_f(3, 5)], {"k": 2, "axis": 1}),
    "mode": lambda: ([np.asarray([[1, 2, 2, 3], [4, 4, 1, 1]],
                                 np.float32)], {}),
    "searchsorted": lambda: ([np.sort(_f(6)), _f(4, seed=1)], {}),
    "bucketize": lambda: ([_f(2, 3), np.sort(_f(5, seed=1))],
                          {"right": True}),
    "prod": lambda: ([_f(2, 3, 4)], {"axis": [0, 2]}),
    "logcumsumexp": lambda: ([_f(3, 4)], {"axis": 1}),
    "topk": lambda: ([_f(3, 5)], {"k": 2, "axis": 0, "largest": False}),
    "sequence_mask": lambda: ([_i(2, 0, 3)], {"maxlen": 4,
                                              "dtype": "int64"}),
    "shard_index": lambda: ([_i(0, 3, 5, 7, 9).reshape(5, 1), 10, 2, 1],
                            {}),
    "split": lambda: ([_f(5, 3), [2, -1]], {"axis": 0}),
    "flip": lambda: ([_f(2, 3, 4), [0, 2]], {}),
    "rot90": lambda: ([_f(3, 4)], {"k": -1}),
    "roll": lambda: ([_f(3, 4), 2], {}),
    "expand": lambda: ([_f(3, 1), [2, -1, 4]], {}),
    "unsqueeze": lambda: ([_f(2, 3), [0, 3]], {}),
    "squeeze": lambda: ([_f(2, 1, 3, 1)], {"axis": [1, 3]}),
    "clip": lambda: ([_f(3, 4)], {"min": -0.5, "max": 0.7}),
    "nan_to_num": lambda: ([np.asarray([1.0, np.nan, np.inf, -np.inf],
                                       np.float32)], {}),
    "matmul": lambda: ([_f(2, 4, 3), _f(5, 4, seed=1)],
                       {"transpose_x": True, "transpose_y": True}),
    "p_norm": lambda: ([_f(3, 4)], {"porder": 3.0, "axis": 1}),
    "cast": lambda: ([_f(2, 3) * 4], {"dtype": "int32"}),
}


def _case(name):
    if name in MANUAL:
        return MANUAL[name]()
    return _contract_case(name, np.random.default_rng(abs(hash(name)) % 997))


def _tensorize(pkg, obj, grads: list):
    """numpy float arrays -> Tensors that require grad (collected in
    ``grads``), other arrays -> Tensors; lists and tuples recursed."""
    if isinstance(obj, np.ndarray):
        floating = obj.dtype.kind == "f"
        t = pkg.to_tensor(obj, stop_gradient=not floating)
        if floating:
            grads.append(t)
        return t
    if isinstance(obj, list) and obj and isinstance(obj[0], np.ndarray):
        return [_tensorize(pkg, o, grads) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_tensorize(pkg, o, grads) for o in obj)
    return obj


def _run(pkg, fn, args, kwargs):
    leaves = []
    a = [_tensorize(pkg, x, leaves) for x in args]
    k = {n: _tensorize(pkg, v, leaves) for n, v in kwargs.items()}
    out = fn(*a, **k)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return outs, leaves


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def _assert_same(port_arr, ref_arr, rtol, what):
    ref_arr = np.asarray(ref_arr)
    assert port_arr.shape == ref_arr.shape, (what, port_arr.shape,
                                             ref_arr.shape)
    if ref_arr.dtype.kind in "fc":
        scale = float(np.nanmax(np.abs(ref_arr))) if ref_arr.size and \
            np.isfinite(ref_arr).any() else 0.0
        scale = 0.0 if not np.isfinite(scale) else scale
        np.testing.assert_allclose(port_arr.astype(np.float64),
                                   ref_arr.astype(np.float64), rtol=rtol,
                                   atol=rtol * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(port_arr.astype(np.int64),
                                      ref_arr.astype(np.int64),
                                      err_msg=what)


def test_ported_op_names_are_the_references():
    assert set(PORT_OPS) == set(REF_OPS)
    assert len(REF_OPS) == 199


@pytest.mark.parametrize("name", sorted(REF_OPS))
def test_op_against_reference(name):
    r = _opdef(REF_OPS[name], RefOpDef)
    p = _opdef(PORT_OPS[name], PortOpDef)
    assert (p.differentiable, p.amp_policy) == (r.differentiable,
                                                r.amp_policy)
    args, kwargs = _case(name)
    r_outs, r_in = _run(ref, REF_OPS[name], args, kwargs)
    p_outs, p_in = _run(port, PORT_OPS[name], args, kwargs)
    assert len(p_outs) == len(r_outs)
    for i, (po, ro) in enumerate(zip(p_outs, r_outs)):
        _assert_same(_np(po), _np(ro), FWD_RTOL, f"{name} output {i}")
    if not _opdef(REF_OPS[name], RefOpDef).differentiable or not r_in:
        return
    rng = np.random.default_rng(1)
    pairs = [(po, ro) for po, ro in zip(p_outs, r_outs)
             if np.asarray(ro.numpy()).dtype.kind == "f"
             and not ro.stop_gradient]
    if not pairs:
        return
    cots = [rng.standard_normal(tuple(ro.shape)).astype(np.float32)
            for _, ro in pairs]
    r_g = ref.grad([ro for _, ro in pairs], r_in,
                   [ref.to_tensor(c) for c in cots], allow_unused=True)
    p_g = port.grad([po for po, _ in pairs], p_in,
                    [port.to_tensor(c) for c in cots], allow_unused=True)
    for j, (pg, rg, x) in enumerate(zip(p_g, r_g, p_in)):
        zero = np.zeros(tuple(x.shape), np.float32)
        _assert_same(zero if pg is None else _np(pg),
                     zero if rg is None else _np(rg), VJP_RTOL,
                     f"{name} grad {j}")


def test_unstack():
    x = _f(3, 4)
    r_outs, r_in = _run(ref, ref.unstack, [x, 1], {})
    p_outs, p_in = _run(port, port.unstack, [x, 1], {})
    assert len(p_outs) == len(r_outs) == 4
    for po, ro in zip(p_outs, r_outs):
        _assert_same(_np(po), _np(ro), FWD_RTOL, "unstack")
    cot = [ref.to_tensor(np.full((3,), k, np.float32)) for k in range(4)]
    (rg,) = ref.grad(r_outs, r_in, cot)
    (pg,) = port.grad(p_outs, p_in,
                      [port.to_tensor(c.numpy()) for c in cot])
    _assert_same(_np(pg), _np(rg), VJP_RTOL, "unstack grad")


@pytest.mark.parametrize("name,args", [
    ("masked_select", lambda: [_f(3, 4), _f(3, 4, seed=1) > 0]),
    ("nonzero", lambda: [_i(0, 1, 2, 0, 3).reshape(5)]),
    ("unique", lambda: [_i(3, 1, 3, 0, 1)]),
    ("unique_consecutive", lambda: [_i(1, 1, 2, 2, 2, 1)]),
    ("broadcast_tensors", lambda: [[_f(3, 1), _f(1, 4)]]),
])
def test_data_dependent_functions(name, args):
    a = args()
    r, _ = _run(ref, getattr(ref, name), a, {})
    p, _ = _run(port, getattr(port, name), a, {})
    for po, ro in zip(p, r):
        _assert_same(_np(po), _np(ro), 0.0, name)


# -- creation ---------------------------------------------------------------

_DETERMINISTIC = {
    "to_tensor": lambda m: m.to_tensor([[1.5, 2.0], [3.0, -1.0]]),
    "tensor": lambda m: m.tensor([1, 2, 3], dtype="int32"),
    "zeros": lambda m: m.zeros([2, 3]),
    "ones": lambda m: m.ones([2, 3], dtype="int32"),
    "full": lambda m: m.full([2, 2], 3.5),
    "empty": lambda m: m.zeros_like(m.empty([2, 2])),
    "zeros_like": lambda m: m.zeros_like(m.ones([2, 3]), dtype="int32"),
    "ones_like": lambda m: m.ones_like(m.zeros([3])),
    "full_like": lambda m: m.full_like(m.zeros([2, 3]), -2.0),
    "empty_like": lambda m: m.zeros_like(m.empty_like(m.ones([2]))),
    "arange": lambda m: m.arange(1, 10, 2),
    "linspace": lambda m: m.linspace(0.5, 2.5, 9),
    "logspace": lambda m: m.logspace(0.0, 2.0, 5),
    "eye": lambda m: m.eye(3, 4),
    "diag": lambda m: m.diag(m.to_tensor([1.0, 2.0, 3.0]), 1, 5.0),
    "diagflat": lambda m: m.diagflat(m.to_tensor([[1.0, 2.0]]), -1),
    "tril": lambda m: m.tril(m.to_tensor(_f(3, 4)), 1),
    "triu": lambda m: m.triu(m.to_tensor(_f(3, 4)), -1),
    "meshgrid": lambda m: m.meshgrid(m.arange(3), m.arange(2)),
    "assign": lambda m: m.assign(m.to_tensor(_f(2, 2))),
    "clone": lambda m: m.clone(m.to_tensor(_f(2, 2))),
    "one_hot": lambda m: m.one_hot(m.to_tensor([0, 2, 1]), 4),
    "tril_indices": lambda m: m.tril_indices(3, 4, 1),
    "triu_indices": lambda m: m.triu_indices(3, 4, -1),
    "complex": lambda m: m.as_real(m.complex(m.to_tensor([1.0, 2.0]),
                                             m.to_tensor([3.0, -4.0]))),
    "as_complex": lambda m: m.as_real(m.as_complex(
        m.to_tensor(_f(3, 2)))),
    "as_real": lambda m: m.as_real(m.to_tensor(_f(3))),
}

# random creators: shape, dtype, and the distribution's mean and std over
# a large draw
_RANDOM = {
    "rand": (lambda m: m.rand([20000]), 0.5, 12 ** -0.5),
    "randn": (lambda m: m.randn([20000]), 0.0, 1.0),
    "standard_normal": (lambda m: m.standard_normal([20000]), 0.0, 1.0),
    "randint": (lambda m: m.randint(0, 10, [20000]), 4.5, 33 ** 0.5 / 2),
    "uniform": (lambda m: m.uniform([20000], min=2.0, max=4.0), 3.0,
                3 ** -0.5),
    "normal": (lambda m: m.normal(1.0, 2.0, [20000]), 1.0, 2.0),
    "randperm": (lambda m: m.randperm(20000), 9999.5, 5773.5),
    "bernoulli": (lambda m: m.bernoulli(m.full([20000], 0.3)), 0.3,
                  0.21 ** 0.5),
    "multinomial": (lambda m: m.multinomial(m.to_tensor([0.2, 0.8]), 20000,
                                            replacement=True), 0.8, 0.4),
    "binomial": (lambda m: m.binomial(m.full([20000], 10.0),
                                      m.full([20000], 0.3)), 3.0,
                 2.1 ** 0.5),
    "poisson": (lambda m: m.poisson(m.full([20000], 4.0)), 4.0, 2.0),
    "standard_gamma": (lambda m: m.standard_gamma(m.full([20000], 2.0)),
                       2.0, 2 ** 0.5),
    "dirichlet": (lambda m: m.dirichlet(m.full([20000, 2], 1.0))[:, 0], 0.5,
                  12 ** -0.5),
    "exponential_": (lambda m: m.exponential_(m.zeros([20000]), 2.0), 0.5,
                     0.5),
}


def test_creation_names_are_the_references():
    assert set(port.ops.creation.__all__) == set(ref.ops.creation.__all__)
    assert set(_DETERMINISTIC) | set(_RANDOM) == set(ref.ops.creation.__all__)


@pytest.mark.parametrize("name", sorted(_DETERMINISTIC))
def test_creation_deterministic(name):
    r = _DETERMINISTIC[name](ref)
    p = _DETERMINISTIC[name](port)
    r = list(r) if isinstance(r, list) else [r]
    p = list(p) if isinstance(p, list) else [p]
    for po, ro in zip(p, r):
        _assert_same(_np(po), _np(ro), FWD_RTOL, name)


@pytest.mark.parametrize("name", sorted(_RANDOM))
def test_creation_random(name):
    fn, mean, std = _RANDOM[name]
    port.seed(11)
    a = _np(fn(port)).astype(np.float64)
    r = _np(fn(ref))
    assert a.shape == r.shape
    assert abs(a.mean() - mean) < 0.05 * max(std, 0.1) + 4 * std / len(a) ** .5
    assert abs(a.std() - std) < 0.05 * std
    port.seed(11)
    np.testing.assert_array_equal(_np(fn(port)).astype(np.float64), a)
