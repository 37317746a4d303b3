"""Every op and function of the port's ops/extra.py and ops/extra2.py
against the reference's (paddle_tpu/ops/extra.py, extra2.py), on the
CPU, and the Tensor-method surface they complete.

The cases are the op contracts' (``artifacts/op_contracts.json``) where
those run on data, else written here, with the cases of the reference's
own tests of these modules (test_surface_tranche3.py,
test_surface_tranche4.py, test_signal_and_ops_tranche.py). The bar:
fp32 outputs within rtol 1e-6 of the reference (1e-6 of the largest
magnitude for entries that cancel), integer and boolean outputs exact,
the vjp of a seeded cotangent within rtol 1e-5; the FFTs within 1e-6 of
the output's largest magnitude. The random functions draw from each
package's own generator and are held by their distributions, except
``top_p_sampling`` with a seed, which draws JAX's bits in both.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dispatch import OpDef as RefOpDef

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_ops_cases import (EXTRA_CASES, EXTRA_FUNCS, FFT_CASES,
                             assert_same, contract_case, f32, i32)
from torch_ops_common import hold, npy, opdef, reference_op_flags, wrappers

port.set_device("cpu")

REF_OPS = {**wrappers(ref.ops.extra), **wrappers(ref.ops.extra2)}
PORT_OPS = {**wrappers(port.ops.extra), **wrappers(port.ops.extra2)}
# registered inside the function that calls them, in both packages'
# references: looked up by name
NESTED = {"top_p_sampling", "view_dtype"}


_PARAMS = [(name, cid) for name, cases in sorted(EXTRA_CASES.items())
           for cid, _, _ in cases]


def _ref_impl(name):
    return opdef(REF_OPS[name], RefOpDef)


def test_extra_registrations_are_the_references():
    flags = {**reference_op_flags("paddle_tpu/ops/extra.py"),
             **reference_op_flags("paddle_tpu/ops/extra2.py")}
    assert len(flags) == 55
    assert set(flags) == set(EXTRA_CASES)
    assert set(PORT_OPS) == set(flags)
    assert set(REF_OPS) == set(flags) - NESTED
    for name, (diff, amp) in flags.items():
        p = port.OP_REGISTRY[name]
        assert (p.differentiable, p.amp_policy) == (diff, amp), name


def _view_dtype_ref(x, dtype):
    return ref.view(x, dtype)


def _view_dtype_port(x, dtype):
    return port.view(x, dtype)


@pytest.mark.parametrize("name,cid", _PARAMS)
def test_extra_op_against_reference(name, cid):
    factory, opts = next((f, o) for c, f, o in EXTRA_CASES[name] if c == cid)
    if name == "view_dtype":
        hold(_view_dtype_ref, _view_dtype_port, factory(), name=name,
             **opts)
        return
    r_def = _ref_impl(name)
    if factory is None or isinstance(factory, tuple):
        case = contract_case(name, r_def.impl, domain=factory)
    else:
        case = factory()
    opts = {"differentiable": r_def.differentiable
            and opts.get("grad_inputs", True), **opts}
    hold(REF_OPS[name], PORT_OPS[name], case, name=f"{name}[{cid}]", **opts)


# -- the functions of the two modules --------------------------------------

@pytest.mark.parametrize("name", sorted(EXTRA_FUNCS))
def test_extra_function_against_reference(name):
    fn = EXTRA_FUNCS[name]
    assert_same(npy(fn(port)), npy(fn(ref)), 1e-6, name)


def test_predicates_and_host_utilities():
    for x in (f32(3), i32(1, 2), np.array([1 + 2j], np.complex64)):
        for name in ("is_complex", "is_floating_point", "is_integer",
                     "is_tensor"):
            assert getattr(port, name)(port.to_tensor(x)) == \
                getattr(ref, name)(ref.to_tensor(x)), (name, x.dtype)
    assert port.tolist(port.to_tensor(f32(2, 2))) == \
        ref.tolist(ref.to_tensor(f32(2, 2)))
    assert port.broadcast_shape([2, 1, 3], [4, 3]) == \
        ref.broadcast_shape([2, 1, 3], [4, 3]) == [2, 4, 3]
    assert port.check_shape([2, -1]) and ref.check_shape([2, -1])
    for pkg in (port, ref):
        with pytest.raises(ValueError):
            pkg.check_shape([2, -2])
        with pytest.raises(ValueError):
            pkg.hsplit(pkg.to_tensor(f32(4, 5)), 2)


@pytest.mark.parametrize("name", sorted(FFT_CASES))
def test_fft_against_reference(name):
    mk, kw = FFT_CASES[name]
    x = mk()
    x = x.astype(np.complex64) if np.iscomplexobj(x) else x
    p = getattr(port.fft, name)(port.to_tensor(x), **kw)
    r = getattr(ref.fft, name)(ref.to_tensor(x), **kw)
    assert npy(p).dtype == npy(r).dtype, name
    assert_same(npy(p), npy(r), 1e-6, name)


def test_fft_freqs_and_roundtrip():
    for name, args in (("fftfreq", (8, 0.5)), ("rfftfreq", (9,))):
        assert_same(npy(getattr(port.fft, name)(*args)),
                    npy(getattr(ref.fft, name)(*args)), 1e-6, name)
    x = f32(4, 8, seed=3)
    r = port.fft.irfftn(port.fft.rfftn(port.to_tensor(x)))
    np.testing.assert_allclose(npy(r), x, atol=1e-5)


# -- nucleus sampling --------------------------------------------------------

def _probs(B, V, seed=0):
    z = f32(B, V, seed=seed) * 3
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _nucleus(p, ps):
    order = np.argsort(-p, kind="stable")
    before = np.concatenate([[0.0], np.cumsum(p[order])[:-1]])
    return set(order[before < ps].tolist())


@pytest.mark.parametrize("seed,threshold", [(3, None), (17, None),
                                            (5, 0.01)])
def test_top_p_sampling_with_a_seed_draws_the_references_ids(seed,
                                                              threshold):
    """With a seed both packages draw JAX's uniform a row: the ids and
    values are the reference's. (The reference sums in fp32, the port
    in fp64; a draw within an ulp of a cumulative boundary could part
    them, about one row in 10⁵ here.)"""
    x = _probs(6, 50, seed)
    ps = np.array([0.9, 0.5, 0.95, 0.3, 0.99, 0.7], np.float32)
    rv, ri = ref.top_p_sampling(ref.to_tensor(x), ref.to_tensor(ps),
                                threshold=threshold, seed=seed)
    pv, pi = port.top_p_sampling(port.to_tensor(x), port.to_tensor(ps),
                                 threshold=threshold, seed=seed)
    assert npy(pi).dtype == np.int32 and npy(pi).shape == (6, 1)
    np.testing.assert_array_equal(npy(pi), npy(ri))
    np.testing.assert_array_equal(npy(pv), npy(rv))
    for b in range(6):
        assert int(npy(pi)[b, 0]) in _nucleus(x[b], ps[b])


def test_top_p_sampling_unseeded_keeps_to_the_nucleus():
    """The reference's own test: at p 0.8 only tokens 0 and 1 come out,
    and 0 (mass 0.5) comes out; the split follows 0.5 : 0.3."""
    port.seed(7)
    probs = np.tile(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32),
                    (2000, 1))
    _, ids = port.top_p_sampling(port.to_tensor(probs),
                                 port.to_tensor(np.full((2000,), 0.8,
                                                        np.float32)))
    ids = npy(ids).ravel()
    assert set(ids.tolist()) <= {0, 1}
    assert abs((ids == 0).mean() - 0.625) < 0.04


# -- the random functions ----------------------------------------------------

def test_random_functions_follow_their_distributions():
    port.seed(11)
    z = npy(port.log_normal(0.0, 0.5, shape=[20000])).astype(np.float64)
    assert abs(np.log(z).mean()) < 0.02 and abs(np.log(z).std() - 0.5) < 0.02
    r = npy(port.randint_like(port.to_tensor(f32(20000)), 0, 10))
    assert r.min() == 0 and r.max() == 9 and abs(r.mean() - 4.5) < 0.1
    x = port.to_tensor(np.zeros((20000,), np.float32))
    assert port.normal_(x, mean=2.0, std=0.5) is x
    v = npy(x)
    assert abs(v.mean() - 2.0) < 0.02 and abs(v.std() - 0.5) < 0.02
    port.bernoulli_(x, p=0.25)
    assert abs(npy(x).mean() - 0.25) < 0.02
    port.geometric_(x, probs=0.5)
    assert abs(npy(x).mean() - 2.0) < 0.05 and npy(x).min() == 1.0
    port.log_normal_(x, mean=0.0, std=0.25)
    assert abs(np.log(npy(x)).std() - 0.25) < 0.01
    port.cauchy_(x, loc=1.0, scale=2.0)
    assert abs(np.median(npy(x)) - 1.0) < 0.1
    # a tape tensor is rebound: its value no longer comes from its history
    w = port.to_tensor(f32(4), stop_gradient=False)
    y = port.multiply(w, 2.0)
    port.normal_(y)
    assert y._data.grad_fn is None


# -- the in-place family and the method surface ------------------------------

def test_inplace_family_is_the_references():
    from paddle_tpu.ops.extra2 import _INPLACE_SOURCES

    assert tuple(_INPLACE_SOURCES) == port.ops.extra2.INPLACE_SOURCES
    r = {b + "_" for b in _INPLACE_SOURCES if hasattr(ref, b + "_")}
    p = {b + "_" for b in _INPLACE_SOURCES if hasattr(port, b + "_")}
    assert p == r and hasattr(port, "where_")


@pytest.mark.parametrize("name,args", [
    ("sinc_", lambda: [f32(2, 3)]),
    ("ldexp_", lambda: [f32(2, 3), i32(1, -2, 3)]),
    ("renorm_", lambda: [f32(3, 4), 2.0, 0, 1.0]),
    ("multigammaln_", lambda: [f32(3, lo=2.5, hi=5), 2]),
    ("polygamma_", lambda: [f32(3, lo=0.5, hi=3)]),
    ("masked_scatter_", lambda: [f32(2, 3), f32(2, 3, seed=1) > 0,
                                 f32(6, seed=2)]),
    ("bitwise_left_shift_", lambda: [i32(1, 2, 3), i32(1, 0, 2)]),
])
def test_new_inplace_variants(name, args):
    vals = args()
    outs = {}
    for pkg in (port, ref):
        t = [pkg.to_tensor(v) for v in vals if isinstance(v, np.ndarray)]
        rest = [v for v in vals if not isinstance(v, np.ndarray)]
        got = getattr(pkg, name)(*t, *rest)
        assert got is t[0]
        outs[pkg] = npy(t[0])
    assert_same(outs[port], outs[ref], 1e-6, name)


def test_inplace_on_a_tape_tensor_keeps_the_gradient():
    """The reference's own case: pt.add_ on a tape tensor backprops."""
    x = port.to_tensor(np.array([1.0, 4.0], np.float32),
                       stop_gradient=False)
    y = port.sqrt(x)
    port.add_(y, port.to_tensor(np.array([1.0, 1.0], np.float32)))
    y.sum().backward()
    np.testing.assert_allclose(npy(y), [2.0, 3.0])
    np.testing.assert_allclose(npy(x.grad), 0.5 / np.sqrt([1.0, 4.0]),
                               rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("take", [i32(0, 5, 2)]), ("unflatten", [1, [2, 2]]),
    ("tensor_split", [2]), ("diagonal", []), ("view", [[2, 2, 2]]),
    ("nanquantile", [0.5]), ("frexp", []), ("vander", []),
    ("isin", [i32(0)]), ("sgn", []), ("reverse", [0]),
])
def test_completed_tensor_methods(name, args):
    x = f32(2, 4) if name not in ("vander",) else f32(3)
    if name == "isin":
        x = i32(0, 1, 2, 0)
    r = getattr(ref.to_tensor(x), name)(*[ref.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])
    p = getattr(port.to_tensor(x), name)(*[port.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])
    r = r if isinstance(r, (list, tuple)) else [r]
    p = p if isinstance(p, (list, tuple)) else [p]
    for po, ro in zip(p, r):
        assert_same(npy(po), npy(ro), 1e-6, name)


def test_missing_methods_are_only_the_unported_modules():
    """After the long tail, the reference's method names the port lacks
    are ``stft`` / ``istft`` (signal.py, not ported) and the eight the
    reference's own Tensor lacks."""
    from paddle_tpu.core.tensor import Tensor as RefTensor
    from paddle_tpu.ops.method_table import TENSOR_METHODS

    ref_missing = {n for n in TENSOR_METHODS if not hasattr(RefTensor, n)}
    assert set(port.ops.MISSING_METHODS) == ref_missing == {
        "stft", "istft", "acosh_", "asinh_", "index_fill_", "index_put_",
        "lerp_", "not_equal_", "put_along_axis_", "uniform_"}
