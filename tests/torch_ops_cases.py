"""The op-library cases of the long tail (ops/linalg.py, extra.py,
extra2.py, parity.py), in numpy only: the CPU tests hold each port op
against the reference's on them (tests/test_torch_ops_{linalg,extra,
parity}.py), and chip_smoke.py's phase ``ops`` holds each port op on the
card against the same op on the CPU. Nothing here imports JAX.

A table maps an op's registered name to its cases, (case id, factory,
options): the factory returns (args, kwargs) with numpy arrays standing
for tensors, ``None`` for the op contract's own case
(``artifacts/op_contracts.json``), a (lo, hi) pair for the contract's
shapes with data uniform over that domain; the options go to the
comparison (``check``, ``loss``, tolerances, ``grad_outs``;
``unordered``: the case writes one place twice, so the card, whose
scatters do not order such writes, skips it).
``EXTRA_FUNCS`` are functions of a package module ``m``, run once per
package (or device).
"""

import ast
import json
import re
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CONTRACTS = json.loads((ROOT / "artifacts" / "op_contracts.json")
                       .read_text())["ops"]
DECOMP_RTOL = 1e-5


def f32(*shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def i32(*vals):
    return np.asarray(vals, np.int32)


def spd(n, seed=0):
    a = f32(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def well(n, seed=0):
    """A well-conditioned square matrix."""
    return (f32(n, n, seed=seed) + 3 * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _spec_array(spec, rng, domain):
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", spec)
    dt, shape = m.group(1), tuple(int(s) for s in m.group(2).split(",") if s)
    if dt == "i32":
        return rng.integers(0, 2, shape).astype(np.int32)
    if domain is not None:
        return rng.uniform(*domain, shape).astype(np.float32)
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


def contract_case(name, impl, domain=None):
    """The contract's case: its array shapes with data from a seed
    (standard normal, or uniform over ``domain``), its static values."""
    c = CONTRACTS[name]["case"]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = iter(_spec_array(s, rng, domain) for s in c["in"])
    static = {k: ast.literal_eval(v) for k, v in c["static"].items()}
    return [static[p] if p in static else next(arrays)
            for p in _required(impl)], {}


def assert_same(port_arr, ref_arr, rtol, what):
    port_arr, ref_arr = np.asarray(port_arr), np.asarray(ref_arr)
    assert port_arr.shape == ref_arr.shape, (what, port_arr.shape,
                                             ref_arr.shape)
    if ref_arr.dtype.kind in "fc":
        finite = np.isfinite(ref_arr)
        scale = float(np.abs(ref_arr[finite]).max()) if finite.any() \
            else 0.0
        np.testing.assert_allclose(
            port_arr.astype(np.complex128 if ref_arr.dtype.kind == "c"
                            else np.float64),
            ref_arr.astype(np.complex128 if ref_arr.dtype.kind == "c"
                           else np.float64),
            rtol=rtol, atol=rtol * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(port_arr.astype(np.int64),
                                      ref_arr.astype(np.int64),
                                      err_msg=what)



# -- linalg --------------------------------------------------------------

def _chol(n, seed=0):
    return np.linalg.cholesky(spd(n, seed).astype(np.float64)) \
        .astype(np.float32)


def _lu_parts():
    import scipy.linalg

    lu_, piv = scipy.linalg.lu_factor(well(3, 4))
    return lu_.astype(np.float32), (piv + 1).astype(np.int32)


def _sq_loss(idx_c):
    """Loss of the squares of the outputs at ``idx_c`` (index, cotangent
    seed): invariant under a column's or row's sign."""

    def loss(pkg, outs):
        total = None
        for i, seed in idx_c:
            o = outs[i]
            c = pkg.to_tensor(f32(*tuple(o.shape), seed=seed))
            term = pkg.sum(pkg.multiply(pkg.multiply(o, o), c))
            total = term if total is None else pkg.add(total, term)
        return total

    return loss


def _check_qr(a):
    def check(p, r):
        q, rr = p
        np.testing.assert_allclose(q @ rr, a, rtol=DECOMP_RTOL,
                                   atol=DECOMP_RTOL * np.abs(a).max())
        k = q.shape[-1]
        np.testing.assert_allclose(q.T @ q, np.eye(k), atol=DECOMP_RTOL)
        assert_same(np.abs(q), np.abs(r[0]), DECOMP_RTOL, "|q|")
        assert_same(np.abs(rr), np.abs(r[1]), DECOMP_RTOL, "|r|")

    return check


def _check_svd(a):
    def check(p, r):
        u, s, v = p
        np.testing.assert_allclose((u * s) @ v.T, a, rtol=DECOMP_RTOL,
                                   atol=DECOMP_RTOL * np.abs(a).max())
        assert_same(s, r[1], DECOMP_RTOL, "s")
        assert_same(np.abs(u), np.abs(r[0]), DECOMP_RTOL, "|u|")
        assert_same(np.abs(v), np.abs(r[2]), DECOMP_RTOL, "|v|")

    return check


def _check_eigh(a):
    def check(p, r):
        w, v = p
        np.testing.assert_allclose((v * w) @ v.T, a, rtol=DECOMP_RTOL,
                                   atol=DECOMP_RTOL * np.abs(a).max())
        assert_same(w, r[0], DECOMP_RTOL, "w")
        assert_same(np.abs(v), np.abs(r[1]), DECOMP_RTOL, "|v|")

    return check


def _check_underdetermined(p, r):
    """A wide system: the residuals are 0 in exact arithmetic (noise of
    ~1e-13 on both sides), the rest equal."""
    for i in (0, 2, 3):
        assert_same(p[i], r[i], DECOMP_RTOL, f"lstsq output {i}")
    assert np.abs(p[1]).max() < 1e-9 and np.abs(r[1]).max() < 1e-9


def _sorted_eigs(w):
    return w[np.lexsort((np.imag(w), np.real(w)))]


def _check_eig(a):
    def check(p, r):
        w, v = p
        assert w.dtype.kind == np.asarray(r[0]).dtype.kind
        assert_same(_sorted_eigs(w), _sorted_eigs(r[0]), DECOMP_RTOL, "w")
        np.testing.assert_allclose(a @ v, v * w, atol=DECOMP_RTOL * 10)
        np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0,
                                   rtol=DECOMP_RTOL)

    return check


def _check_eigvals(p, r):
    assert p[0].dtype.kind == np.asarray(r[0]).dtype.kind
    assert_same(_sorted_eigs(p[0]), _sorted_eigs(r[0]), DECOMP_RTOL, "w")


_REAL_EIG = (np.diag([1.0, 2.0, -3.0]) + np.triu(f32(3, 3, seed=5), 1)) \
    .astype(np.float32)
_REAL_EIG = (well(3, 6) @ _REAL_EIG @ np.linalg.inv(well(3, 6))) \
    .astype(np.float32)
_CPLX_EIG = np.asarray([[0.0, -2.0, 0.5], [2.0, 0.0, 0.3],
                        [0.1, 0.2, 1.5]], np.float32)

_TALL = f32(4, 3, seed=2)
_SYM = (lambda a: (a + a.T) / 2)(f32(3, 3, seed=3)).astype(np.float32)
_INF = float("inf")

# name -> [(case id, case factory, options)]; a factory returns
# (args, kwargs); options go to ``hold``
LINALG_CASES = {
    "norm": [("contract", None, {}),
             ("p1_axis1", lambda: ([f32(2, 3)], {"p": 1, "axis": 1}), {}),
             ("inf_keepdim", lambda: ([f32(2, 3)], {"p": _INF, "axis": 0,
                                                     "keepdim": True}), {}),
             ("p3_axes", lambda: ([f32(2, 3, 2)], {"p": 3,
                                                   "axis": [0, 2]}), {})],
    "vector_norm": [("contract", None, {}),
                    ("p3_axis1", lambda: ([f32(2, 3)], {"p": 3, "axis": 1}),
                     {})],
    "matrix_norm": [("contract", None, {}),
                    ("nuc", lambda: ([f32(3, 3)], {"p": "nuc"}), {})],
    "dist": [("contract", None, {}),
             ("inf", lambda: ([f32(2, 3), f32(2, 3, seed=1)], {"p": _INF}),
              {})],
    "cholesky": [("spd", lambda: ([spd(3)], {}), {}),
                 ("upper", lambda: ([spd(3, 1)], {"upper": True}), {})],
    "cholesky_solve": [("lower", lambda: ([f32(3, 2), _chol(3)], {}), {}),
                       ("upper", lambda: ([f32(3, 2), _chol(3).T],
                                          {"upper": True}), {})],
    "qr": [("tall", lambda: ([_TALL], {}),
            {"check": _check_qr(_TALL), "loss": _sq_loss([(0, 4), (1, 5)]),
             "vjp_rtol": DECOMP_RTOL})],
    "svd": [("tall", lambda: ([_TALL], {}),
             {"check": _check_svd(_TALL),
              "loss": _sq_loss([(0, 4), (1, 5), (2, 6)]),
              "vjp_rtol": DECOMP_RTOL})],
    "svdvals": [("contract", None, {"fwd_rtol": DECOMP_RTOL,
                                    "vjp_rtol": DECOMP_RTOL})],
    "eig": [("real", lambda: ([_REAL_EIG], {}),
             {"check": _check_eig(_REAL_EIG), "grad_inputs": False}),
            ("complex", lambda: ([_CPLX_EIG], {}),
             {"check": _check_eig(_CPLX_EIG), "grad_inputs": False})],
    "eigh": [("sym", lambda: ([_SYM], {}),
              {"check": _check_eigh(_SYM),
               "loss": _sq_loss([(0, 4), (1, 5)]),
               "vjp_rtol": DECOMP_RTOL})],
    "eigvals": [("real", lambda: ([_REAL_EIG], {}),
                 {"check": _check_eigvals, "grad_inputs": False}),
                ("complex", lambda: ([_CPLX_EIG], {}),
                 {"check": _check_eigvals, "grad_inputs": False})],
    "eigvalsh": [("sym", lambda: ([_SYM], {}), {"fwd_rtol": DECOMP_RTOL,
                                               "vjp_rtol": DECOMP_RTOL})],
    "inverse": [("well", lambda: ([well(3)], {}), {})],
    "pinv": [("contract", None, {"fwd_rtol": DECOMP_RTOL,
                                 "vjp_rtol": DECOMP_RTOL})],
    "solve": [("well", lambda: ([well(3), f32(3, 2, seed=1)], {}), {})],
    "triangular_solve": [
        ("upper", lambda: ([well(3), f32(3, 2, seed=1)], {}), {}),
        ("lower_t", lambda: ([well(3), f32(3, 2, seed=1)],
                             {"upper": False, "transpose": True}), {}),
        ("unit", lambda: ([well(3), f32(3, 2, seed=1)],
                          {"unitriangular": True}), {}),
        ("vector", lambda: ([well(3), f32(3, seed=1)], {"upper": False}),
         {})],
    "lstsq": [("contract", None, {"check": _check_underdetermined,
                                  "grad_outs": [0, 3],
                                  "vjp_rtol": DECOMP_RTOL}),
              ("tall_vec", lambda: ([f32(4, 2), f32(4, seed=1)], {}),
               {"fwd_rtol": DECOMP_RTOL, "vjp_rtol": DECOMP_RTOL})],
    "lu": [("square", lambda: ([well(3, 4)], {}), {})],
    "det": [("contract", None, {})],
    "slogdet": [("contract", None, {})],
    "matrix_power": [("contract", None, {}),
                     ("neg", lambda: ([well(3)], {"n": -2}), {})],
    "matrix_rank": [("contract", None, {}),
                    ("deficient", lambda: ([f32(4, 2) @ f32(2, 4, seed=1)],
                                           {}), {})],
    "cond": [("contract", None, {"fwd_rtol": DECOMP_RTOL,
                                 "vjp_rtol": DECOMP_RTOL}),
             ("fro", lambda: ([well(3)], {"p": "fro"}), {})],
    "multi_dot": [("contract", None, {}),
                  ("chain", lambda: ([[f32(2, 3), f32(3, 4, seed=1),
                                       f32(4, 2, seed=2)]], {}), {})],
    "einsum": [("attn", lambda: (["bhqd,bhkd->bhqk", f32(2, 2, 3, 4),
                                  f32(2, 2, 5, 4, seed=1)], {}), {}),
               ("trace", lambda: (["ii->", f32(3, 3)], {}), {})],
    "tensordot": [("contract", None, {}),
                  ("axes", lambda: ([f32(2, 3), f32(3, 4, seed=1)],
                                    {"axes": [[1], [0]]}), {})],
    "histogram": [("contract", None, {}),
                  ("range", lambda: ([f32(4, 5)], {"bins": 5, "min": -1,
                                                   "max": 1}), {})],
    "bincount": [("plain", lambda: ([i32(0, 3, 1, 3, 5)], {}), {}),
                 ("weights", lambda: ([i32(0, 3, 1, 3)],
                                      {"weights": f32(4),
                                       "minlength": 6}), {})],
    "corrcoef": [("contract", None, {})],
    "cov": [("contract", None, {}),
            ("cols_ddof0", lambda: ([f32(4, 3)], {"rowvar": False,
                                                  "ddof": False}), {})],
    "householder_product": [("tall", lambda: ([f32(4, 3), f32(3, seed=1)],
                                              {}), {})],
    "lu_unpack": [("square", lambda: (list(_lu_parts()), {}), {})],
    "cholesky_inverse": [("lower", lambda: ([_chol(3)], {}), {})],
    "matrix_exp": [("contract", None, {})],
    "ormqr": [("contract", None, {}),
              ("right_t", lambda: ([f32(3, 2), f32(2, seed=1),
                                    f32(2, 3, seed=2)],
                                   {"left": False, "transpose": True}), {})],
}


# -- extra, extra2 -------------------------------------------------------

def _complex_loss(pkg, outs):
    o = outs[0]
    c1 = pkg.to_tensor(f32(*tuple(o.shape), seed=4))
    c2 = pkg.to_tensor(f32(*tuple(o.shape), seed=5))
    return pkg.add(pkg.sum(pkg.multiply(pkg.real(o), c1)),
                   pkg.sum(pkg.multiply(pkg.imag(o), c2)))


_NAN = np.asarray([[1.0, np.nan, 3.0, -2.0], [np.nan, 0.5, 4.0, 2.5]],
                  np.float32)

EXTRA_CASES = {
    # extra
    "polygamma": [("contract", (0.5, 3.0), {}),
                  ("n2", lambda: ([f32(2, 3, lo=0.5, hi=3)], {"n": 2}), {})],
    "nanmedian": [("contract", None, {}),
                  ("nan_axis1", lambda: ([_NAN], {"axis": 1}), {}),
                  ("nan_keepdim", lambda: ([_NAN], {"axis": 0,
                                                    "keepdim": True}), {})],
    "trapezoid": [("contract", None, {}),
                  ("x_axis0", lambda: ([f32(3, 4)],
                                       {"x": np.sort(f32(3, seed=1)),
                                        "axis": 0}), {})],
    "cumulative_trapezoid": [("contract", None, {}),
                             ("dx_axis0", lambda: ([f32(3, 4)],
                                                   {"dx": 0.5, "axis": 0}),
                              {})],
    "fmod": [("contract", None, {})],
    "fix": [("contract", None, {})],
    "signbit": [("contract", None, {})],
    "renorm": [("contract", None, {}),
               ("p2_axis0", lambda: ([f32(3, 4) * 2], {"p": 2.0, "axis": 0,
                                                       "max_norm": 1.0}),
                {})],
    "logdet": [("spd", lambda: ([(lambda a: a @ a.T + 3 * np.eye(
        3, dtype=np.float32))(f32(3, 3)).astype(np.float32)], {}), {})],
    "vdot": [("contract", None, {})],
    "diagonal": [("contract", None, {}),
                 ("offset_axes", lambda: ([f32(2, 3, 4)],
                                          {"offset": 1, "axis1": 1,
                                           "axis2": 2}), {})],
    "block_diag": [("contract", None, {})],
    "index_fill": [("float", lambda: ([f32(4, 3), i32(0, 2), 0, 0.5], {}),
                    {})],
    "masked_scatter": [("bool_mask", lambda: ([f32(3, 4), f32(3, 4, seed=1)
                                               > 0, f32(12, seed=2)], {}),
                        {})],
    "take": [("contract", None, {}),
             ("wrap", lambda: ([f32(3, 4), i32(-1, 13, 5).reshape(3, 1)],
                               {"mode": "wrap"}), {}),
             ("clip", lambda: ([f32(3, 4), i32(-3, 15, 2)],
                               {"mode": "clip"}), {})],
    "isreal": [("contract", None, {})],
    "iscomplex": [("contract", None, {})],
    "fliplr": [("contract", None, {})],
    "flipud": [("contract", None, {})],
    "unflatten": [("mid", lambda: ([f32(2, 6, 3), 1, [2, 3]], {}), {}),
                  ("neg", lambda: ([f32(2, 6), -1, [3, 2]], {}), {})],
    "ravel": [("contract", None, {})],
    "pdist": [("contract", None, {}),
              ("p1", lambda: ([f32(4, 3)], {"p": 1.0}), {})],
    "cdist": [("contract", None, {}),
              ("p1", lambda: ([f32(3, 2), f32(4, 2, seed=1)], {"p": 1.0}),
               {})],
    "gather_tree": [
        ("reference", lambda: ([np.array([[[1, 2]], [[3, 4]], [[5, 6]]],
                                         np.int32),
                                np.array([[[0, 0]], [[1, 0]], [[1, 0]]],
                                         np.int32)], {}), {}),
        ("random", lambda: ([np.random.default_rng(0).integers(
            0, 9, (5, 2, 3)).astype(np.int32),
            np.random.default_rng(1).integers(0, 3, (5, 2, 3))
            .astype(np.int32)], {}), {})],
    # extra2
    "add_n": [("contract", None, {}),
              ("list", lambda: ([[f32(2, 3), f32(2, 3, seed=1),
                                  f32(2, 3, seed=2)]], {}), {})],
    "cartesian_prod": [("contract", None, {})],
    "combinations": [("contract", None, {}),
                     ("replace", lambda: ([f32(4)], {"r": 3,
                                                     "with_replacement":
                                                         True}), {})],
    "column_stack": [("contract", None, {})],
    "row_stack": [("contract", None, {})],
    "dstack": [("contract", None, {})],
    "hsplit": [("contract", None, {}),
               ("indices", lambda: ([f32(3, 6), [1, 4]], {}), {})],
    "vsplit": [("contract", None, {})],
    "dsplit": [("contract", None, {})],
    "tensor_split": [("contract", None, {}),
                     ("uneven", lambda: ([f32(7, 2), 3, 0], {}), {})],
    "diagonal_scatter": [("reference", lambda: ([f32(3, 3), f32(3, seed=1)],
                                                {}), {}),
                         ("offset", lambda: ([f32(3, 4), f32(3, seed=1)],
                                             {"offset": 1}), {}),
                         ("axes", lambda: ([f32(2, 3, 3), f32(2, 2, seed=1)],
                                           {"offset": -1, "axis1": 1,
                                            "axis2": 2}), {})],
    # the contract's index repeats a position: which write lands is the
    # order of the scatter, defined on the CPU, not on the card
    "select_scatter": [("contract", None, {"unordered": True}),
                       ("float", lambda: ([f32(3, 4), f32(4, seed=1), 0, 1],
                                          {}), {})],
    "slice_scatter": [("reference", lambda: ([f32(3, 3), f32(3, 1, seed=1)],
                                             {"axes": [1], "starts": [2],
                                              "ends": [3],
                                              "strides": [1]}), {}),
                      ("strided", lambda: ([f32(4, 6), f32(2, 2, seed=1)],
                                           {"axes": [0, 1],
                                            "starts": [0, 1],
                                            "ends": [4, 5],
                                            "strides": [2, 2]}), {})],
    "frexp": [("contract", None, {}),
              ("reference", lambda: ([np.array([8.0, 0.5, -3.0, 0.0],
                                               np.float32)], {}), {})],
    "ldexp": [("contract", None, {})],
    "histogram_bin_edges": [("contract", None, {}),
                            ("range", lambda: ([f32(5)], {"bins": 4,
                                                          "min": -1.0,
                                                          "max": 2.0}),
                             {})],
    "isin": [("contract", None, {}),
             ("invert", lambda: ([i32(1, 2, 3, 2), i32(2, 5)],
                                 {"invert": True}), {})],
    "isneginf": [("inf", lambda: ([np.array([1.0, np.inf, -np.inf],
                                            np.float32)], {}), {})],
    "isposinf": [("inf", lambda: ([np.array([1.0, np.inf, -np.inf],
                                            np.float32)], {}), {})],
    "multigammaln": [("contract", (2.5, 5.0), {}),
                     ("p2", lambda: ([np.array([3.0, 5.0], np.float32), 2],
                                     {}), {})],
    "nanquantile": [("contract", None, {}),
                    ("nan_axis", lambda: ([_NAN, 0.3], {"axis": 1}), {}),
                    ("lower", lambda: ([f32(3, 5), 0.4],
                                       {"axis": [0, 1],
                                        "interpolation": "lower"}), {})],
    "polar": [("contract", None, {"loss": _complex_loss})],
    "reverse": [("contract", None, {})],
    "sgn": [("contract", None, {})],
    "sinc": [("contract", None, {}),
             ("zero", lambda: ([np.array([0.0, 0.5, -1.5], np.float32)],
                               {}), {})],
    "vander": [("vector", lambda: ([np.array([1.0, 2.0, 3.0], np.float32)],
                                   {}), {}),
               ("increasing", lambda: ([f32(3)], {"n": 4,
                                                  "increasing": True}), {})],
    "tensor_unfold": [("axis1", lambda: ([f32(2, 7, 3), 1, 3, 2], {}), {}),
                      ("neg", lambda: ([f32(5, 4), -2, 2, 1], {}), {})],
    "bitwise_left_shift": [("contract", None, {})],
    "bitwise_right_shift": [
        ("contract", None, {}),
        ("logical", lambda: ([i32(-8, 16, -1, 7), i32(1, 2, 3, 0)],
                             {"is_arithmetic": False}), {})],
    "view_dtype": [("f32_i32", lambda: ([f32(2, 4), "int32"], {}),
                    {"differentiable": False, "grad_inputs": False}),
                   ("narrow", lambda: ([f32(2, 3), "uint8"], {}),
                    {"differentiable": False, "grad_inputs": False}),
                   ("widen", lambda: ([np.arange(16, dtype=np.uint8)
                                       .reshape(2, 8), "float32"], {}),
                    {"differentiable": False, "grad_inputs": False})],
    "top_p_sampling": [],
}

EXTRA_FUNCS = {
    "atleast_1d": lambda m: m.atleast_1d(m.to_tensor(np.float32(2.0))),
    "atleast_2d": lambda m: m.atleast_2d(m.to_tensor(f32(3))),
    "atleast_3d": lambda m: m.atleast_3d(m.to_tensor(f32(3)),
                                         m.to_tensor(f32(2, 2)))[0],
    "poisson_nll_loss": lambda m: m.ops.extra.poisson_nll_loss(
        m.to_tensor(f32(3, 4)), m.to_tensor(f32(3, 4, lo=0, hi=3, seed=1)),
        full=True),
    "hsplit": lambda m: m.hsplit(m.to_tensor(f32(4, 6)), 3)[1],
    "vsplit": lambda m: m.vsplit(m.to_tensor(f32(4, 6)), [1, 3])[2],
    "dsplit": lambda m: m.dsplit(m.to_tensor(f32(2, 2, 4)), 2)[0],
    "tensor_split": lambda m: m.tensor_split(m.to_tensor(np.arange(7)),
                                             3)[2],
    "rank": lambda m: m.rank(m.to_tensor(f32(2, 3))),
    "shape": lambda m: m.shape(m.to_tensor(f32(2, 3, 4))),
    "view_shape": lambda m: m.view(m.to_tensor(f32(2, 6)), [3, 4]),
    "view_as": lambda m: m.view_as(m.to_tensor(f32(2, 6)),
                                   m.to_tensor(f32(4, 3))),
    "histogramdd": lambda m: m.histogramdd(m.to_tensor(f32(50, 2)),
                                           bins=[3, 4])[0],
    "histogramdd_edges": lambda m: m.histogramdd(
        m.to_tensor(f32(50, 2)), bins=3, ranges=[(-1, 1), (-2, 2)],
        density=True)[1][1],
    "histogramdd_density": lambda m: m.histogramdd(
        m.to_tensor(f32(50, 2)), bins=3, ranges=[(-1, 1), (-2, 2)],
        density=True, weights=m.to_tensor(f32(50, lo=0, hi=1)))[0],
    "masked_select": lambda m: m.ops.extra.masked_select(
        m.to_tensor(f32(3, 4)), m.to_tensor(f32(3, 4, seed=1) > 0)),
    "unique": lambda m: m.ops.extra.unique(m.to_tensor(i32(3, 1, 3, 0)),
                                           return_counts=True)[1],
    "nonzero": lambda m: m.ops.extra.nonzero(m.to_tensor(i32(0, 2, 0, 1))),
}


FFT_CASES = {
    "fft": (lambda: f32(3, 8), {}), "ifft": (lambda: f32(3, 8), {"n": 6}),
    "rfft": (lambda: f32(3, 8), {"norm": "ortho"}),
    "irfft": (lambda: f32(3, 5) + 1j * f32(3, 5, seed=1), {}),
    "fft2": (lambda: f32(4, 6), {}), "ifft2": (lambda: f32(4, 6), {}),
    "fftn": (lambda: f32(2, 4, 6), {"axes": (0, 2)}),
    "ifftn": (lambda: f32(2, 4, 6), {"norm": "forward"}),
    "rfft2": (lambda: f32(4, 6), {}),
    "irfft2": (lambda: f32(4, 4) + 1j * f32(4, 4, seed=1), {}),
    "rfftn": (lambda: f32(2, 4, 6), {}),
    "irfftn": (lambda: f32(2, 4, 4) + 1j * f32(2, 4, 4, seed=1), {}),
    "hfft": (lambda: f32(5) + 1j * f32(5, seed=1), {}),
    "ihfft": (lambda: f32(8), {}),
    "hfft2": (lambda: f32(4, 5) + 1j * f32(4, 5, seed=1), {"s": [4, 8]}),
    "ihfft2": (lambda: f32(4, 8), {}),
    "hfftn": (lambda: f32(2, 4, 5) + 1j * f32(2, 4, 5, seed=1), {}),
    "ihfftn": (lambda: f32(2, 4, 8), {}),
    "fftshift": (lambda: f32(3, 5), {}),
    "ifftshift": (lambda: f32(3, 5), {"axes": 1}),
}



# -- parity --------------------------------------------------------------

def _boxes(n, seed=0, scale=20.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(1, scale / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _unpool_case(nd):
    rng = np.random.default_rng(0)
    spatial = (4,) * nd
    size = int(np.prod(spatial))
    n_in = size // 2 ** nd
    idx = np.stack([rng.permutation(size)[:n_in] for _ in range(2)])
    x = f32(1, 2, *((2,) * nd))
    return [x, idx.reshape((1, 2) + (2,) * nd).astype(np.int32)], {}


def _crf_case():
    """The reference's own test's emission [T 4, N 3] and transition."""
    rng = np.random.RandomState(0)
    return (rng.randn(4, 3).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))


PARITY_CASES = {
    "fake_quantize_abs_max": [("contract", None, {})],
    "fake_channel_wise_quantize_abs_max": [
        ("contract", None, {}),
        ("axis1", lambda: ([f32(3, 4, 2)], {"quant_axis": 1,
                                            "bit_length": 4}), {})],
    "fake_quantize_dequantize_abs_max": [("contract", None, {}),
                                         ("bits4", lambda: ([f32(4, 4)],
                                                            {"bit_length":
                                                                 4}), {})],
    "fake_channel_wise_quantize_dequantize_abs_max": [("contract", None, {})],
    "fake_quantize_moving_average_abs_max": [("contract", None, {})],
    "fake_quantize_dequantize_moving_average_abs_max": [
        ("contract", None, {})],
    "fake_quantize_range_abs_max": [("contract", None, {})],
    "fake_dequantize_max_abs": [("contract", None, {})],
    "dequantize_abs_max": [("contract", None, {})],
    "fake_channel_wise_dequantize_max_abs": [
        ("contract", None, {}),
        ("axis1", lambda: ([np.round(f32(2, 3) * 50), [f32(3, lo=0.1,
                                                           hi=1)]],
                           {"quant_axis": 1}), {})],
    "dequantize_log": [("contract", None, {}),
                       ("codes", lambda: ([i32(-3, 0, 5, -127, 64),
                                           f32(128, lo=0, hi=2)], {}), {})],
    "quantize_linear": [("contract", None, {}),
                        ("per_channel", lambda: ([f32(3, 4),
                                                  f32(4, lo=0.01, hi=0.1)],
                                                 {"quant_axis": 1}), {})],
    "dequantize_linear": [("contract", None, {}),
                          ("per_channel", lambda: (
                              [np.round(f32(3, 4) * 60).astype(np.int8),
                               f32(3, lo=0.01, hi=0.1)],
                              {"quant_axis": 0}), {})],
    "apply_per_channel_scale": [("contract", None, {})],
    "llm_int8_linear": [("contract", None, {}),
                        ("mlp", lambda: ([f32(2, 3, 8),
                                          np.round(f32(6, 8) * 40)
                                          .astype(np.int8),
                                          f32(6, lo=0.5, hi=2)], {}), {})],
    "lookup_table_dequant": [("rows", lambda: ([np.round(f32(5, 4) * 60)
                                                .astype(np.int8),
                                                f32(5, lo=0.01, hi=0.1),
                                                i32(4, 0, 4, 2)], {}), {})],
    "lp_pool2d": [("p2", lambda: ([f32(1, 2, 5, 5)], {}), {}),
                  ("p3_pad", lambda: ([f32(1, 2, 6, 5)],
                                      {"norm_type": 3.0, "kernel_size": 3,
                                       "stride": 2, "padding": 1}), {})],
    "fractional_max_pool2d": [],
    "fractional_max_pool3d": [],
    "unpool": [("k2", lambda: _unpool_case(2), {})],
    "unpool3d": [("k2", lambda: _unpool_case(3), {})],
    "box_clip": [("boxes", lambda: ([_boxes(6) - 5,
                                     np.array([12.0, 10.0], np.float32)],
                                    {}), {})],
    "bipartite_match": [
        ("contract", None, {}),
        ("reference", lambda: ([np.array([[0.9, 0.1], [0.2, 0.8]],
                                         np.float32)], {}), {}),
        ("tall", lambda: ([f32(5, 3, lo=-0.2, hi=1)], {}), {})],
    "multiclass_nms3": [("top5", lambda: ([_boxes(12, 2), f32(2, 12, lo=0,
                                                             hi=1, seed=3)],
                                          {"keep_top_k": 5,
                                           "nms_threshold": 0.2}), {}),
                        ("classes", lambda: ([_boxes(24), f32(3, 24, lo=0,
                                                              hi=1)],
                                             {"keep_top_k": 20}), {})],
    "collect_fpn_proposals": [("levels", lambda: (
        [[_boxes(4), _boxes(5, 1)], [f32(4, lo=0, hi=1),
                                     f32(5, lo=0, hi=1, seed=1)], 6], {}),
        {})],
    "correlation": [("d2", lambda: ([f32(1, 3, 5, 6), f32(1, 3, 5, 6,
                                                          seed=1)],
                                    {"max_displacement": 2}), {}),
                    ("stride2", lambda: ([f32(2, 2, 4, 4), f32(2, 2, 4, 4,
                                                               seed=1)],
                                         {"max_displacement": 2,
                                          "stride": 2}), {})],
    "number_count": [("ids", lambda: ([i32(0, 2, 1, 2, 2, 0, -1, 5), 3],
                                      {}), {})],
    "assign_pos": [("contract", None, {}),
                   ("ids", lambda: ([i32(2, 0, 1, 2, 0, 2),
                                     i32(2, 3, 6)], {}), {})],
    "limit_by_capacity": [("contract", None, {}),
                          ("workers", lambda: ([np.array([3, 1, 4, 1, 5, 9],
                                                         np.int64),
                                                np.array([2, 2, 3],
                                                         np.int64), 2],
                                               {}), {})],
    "prune_gate_by_capacity": [
        ("contract", None, {}),
        ("reference", lambda: ([i32(0, 2, 1, 2, 2, 0), i32(1, 1, 2), 3],
                               {}), {})],
    "random_routing": [],
    "affine_channel": [("nchw", lambda: ([f32(2, 3, 4, 4), f32(3, seed=1),
                                          f32(3, seed=2)], {}), {}),
                       ("nhwc", lambda: ([f32(2, 4, 4, 3), f32(3, seed=1),
                                          f32(3, seed=2)],
                                         {"data_layout": "NHWC"}), {})],
    "add_position_encoding": [("contract", None, {}),
                              ("alpha", lambda: ([f32(2, 5, 8)],
                                                 {"alpha": 0.5,
                                                  "beta": 2.0}), {})],
    "fill_diagonal_tensor": [("vector", lambda: ([f32(3, 4), f32(3, seed=1)],
                                                 {}), {}),
                             ("offset", lambda: ([f32(4, 3, 2),
                                                  f32(2, 2, seed=1)],
                                                 {"offset": 1, "dim1": 0,
                                                  "dim2": 1}), {})],
    "edit_distance": [
        ("reference", lambda: ([i32(1, 2, 3, 4), i32(1, 3, 3, 5, 6)],
                               {"normalized": False}), {}),
        ("normalized", lambda: ([i32(0, 1, 2, 1, 0), i32(2, 1, 0)], {}),
         {})],
    "identity_loss": [("contract", None, {}),
                      ("sum", lambda: ([f32(2, 3)], {"reduction": "sum"}),
                       {}),
                      ("none", lambda: ([f32(2, 3)], {"reduction": 2}), {})],
    "huber_loss": [("contract", None, {}),
                   ("delta", lambda: ([f32(3, 4) * 2, f32(3, 4, seed=1)],
                                      {"delta": 0.5}), {})],
    "truncated_gaussian_random": [],
    "check_numerics": [("contract", None, {}),
                       ("nonfinite", lambda: ([np.array(
                           [1.0, np.nan, np.inf, 0.0, -2.0, -np.inf],
                           np.float32)], {}), {})],
    "accuracy_check": [("contract", None, {}),
                       ("close", lambda: ([f32(3), f32(3) * (1 + 1e-7)],
                                          {}), {})],
    "crf_decoding": [("reference", lambda: (list(_crf_case()), {}), {})],
}
