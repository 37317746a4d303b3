"""Shared by tests/test_torch_nn_functional.py and
tests/test_torch_nn_loss.py: the reference's and the port's funnel ops
of nn/functional's activation, common, input, norm and loss modules,
their cases, and the check that holds one op to the reference's.

Each op's case comes from the reference's op contracts
(``artifacts/op_contracts.json``: ``case.in`` shapes and dtypes, numpy
data from a seed inside the op's domain, ``case.static`` values), or is
written here where the contract is opaque; several cases are written
for the ops with modes (pad, interpolate, the norms, the sequence
losses). The bar: fp32 outputs within rtol 1e-6 (and 1e-6 of the
output's largest magnitude), integer outputs exact, the vjp of a seeded
cotangent within rtol 1e-5.
"""

import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dispatch import OpDef as RefOpDef

from test_torch_ops import (CONTRACTS, _assert_same, _np, _opdef,
                            _required, _run)

port.set_device("cpu")
FWD_RTOL = 1e-6
VJP_RTOL = 1e-5
MODULES = ("activation", "common", "input", "norm", "loss")


def _wrappers(mod):
    return {v.op_name: v for v in vars(mod).values()
            if hasattr(v, "op_name")
            and getattr(v, "__module__", None) == mod.__name__}


def _ops(pkg):
    out = {}
    for m in MODULES:
        out.update(_wrappers(getattr(pkg.nn.functional, m)))
    return out


REF_OPS = _ops(ref)
PORT_OPS = _ops(port)
# the random ops: their key / generator argument differs by package, and
# their draws are held by statistics below
RANDOM = {"dropout_impl", "class_center_sample"}

_UNIT = {"binary_cross_entropy", "log_loss"}
_POSITIVE = {"kl_div", "poisson_nll_loss", "gaussian_nll_loss"}


def _data(name, spec, rng):
    import re

    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", spec)
    dt, shape = m.group(1), tuple(int(s) for s in m.group(2).split(",") if s)
    if dt == "i32":
        return rng.integers(0, 2, shape).astype(np.int32)
    if name in _UNIT:
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    if name in _POSITIVE:
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _contract_case(name):
    import ast

    rng = np.random.default_rng(sum(map(ord, name)))
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


def _i(*vals, shape=None):
    a = np.asarray(vals, np.int32)
    return a if shape is None else a.reshape(shape)


X4 = lambda: _f(2, 3, 4, 5)  # noqa: E731

# Cases written here: the contract is opaque, or the op has modes its one
# contract case does not reach.
MANUAL = {
    "pad": [
        lambda: ([X4(), [1, 2, 0, 1]], {"mode": "reflect"}),
        lambda: ([X4(), [2, 0, 1, 3]], {"mode": "replicate"}),
        lambda: ([X4(), [1, 1, 2, 0]], {"mode": "circular"}),
        lambda: ([X4(), [1, 2, 0, 1]], {"value": 0.5}),
        lambda: ([X4(), [0, 1, 1, 0, 2, 1, 0, 2]], {}),
        lambda: ([X4(), [1, 0, 0, 2]], {"mode": "reflect",
                                         "data_format": "NHWC"}),
    ],
    "pixel_shuffle": [lambda: ([_f(1, 8, 2, 3), 2], {}),
                      lambda: ([_f(1, 2, 3, 8), 2],
                               {"data_format": "NHWC"})],
    "pixel_unshuffle": [lambda: ([_f(1, 2, 4, 6), 2], {}),
                        lambda: ([_f(1, 4, 6, 2), 2],
                                 {"data_format": "NHWC"})],
    "channel_shuffle": [lambda: ([_f(1, 6, 2, 2), 3], {}),
                        lambda: ([_f(1, 2, 2, 6), 2],
                                 {"data_format": "NHWC"})],
    "bilinear": [lambda: ([_f(3, 4), _f(3, 5, seed=1), _f(2, 4, 5, seed=2),
                           _f(2, seed=3)], {})],
    "interpolate": [
        lambda: ([_f(1, 2, 4, 6)], {"size": [8, 9]}),
        lambda: ([_f(1, 2, 6, 8)], {"size": [3, 5]}),
        lambda: ([_f(1, 2, 4, 6)], {"size": [8, 12], "mode": "bilinear"}),
        lambda: ([_f(1, 2, 8, 9)], {"size": [3, 4], "mode": "bilinear"}),
        lambda: ([_f(1, 2, 4, 6)], {"size": [7, 5], "mode": "bicubic"}),
        lambda: ([_f(1, 2, 4, 6)], {"scale_factor": 2.0, "mode": "area"}),
        lambda: ([_f(1, 2, 4, 6)], {"size": [7, 9], "mode": "bilinear",
                                    "align_corners": True}),
        lambda: ([_f(1, 2, 5)], {"size": [9], "mode": "linear",
                                 "data_format": "NCL"}),
        lambda: ([_f(1, 4, 6, 2)], {"size": [6, 9], "mode": "bilinear",
                                    "data_format": "NHWC"}),
    ],
    "unfold": [lambda: ([_f(1, 2, 5, 5), 2], {"strides": 1, "paddings": 1}),
               lambda: ([_f(1, 2, 6, 7), [2, 3]],
                        {"strides": [2, 1], "paddings": [1, 0, 0, 1],
                         "dilations": [1, 2]})],
    "fold": [lambda: ([_f(1, 8, 4), [4, 4], 2], {"strides": 2}),
             lambda: ([_f(1, 8, 9), [4, 4], 2], {"strides": 1,
                                                  "paddings": 0})],
    "batch_norm_train": [lambda: ([_f(4, 3, 5), _f(3, seed=1),
                                   _f(3, seed=2), 1, (0, 2), 1e-5], {})],
    "batch_norm_infer": [lambda: ([_f(4, 3, 5), _f(3, seed=1),
                                   _f(3, seed=2, lo=0.5, hi=2.0),
                                   _f(3, seed=3), _f(3, seed=4), 1, 1e-5],
                                  {})],
    "local_response_norm": [lambda: ([_f(2, 5, 3, 3), 3], {}),
                            lambda: ([_f(2, 3, 3, 6), 4],
                                     {"data_format": "NHWC"})],
    "layer_norm": [lambda: ([_f(2, 3, 4), [3, 4], _f(3, 4, seed=1),
                             _f(3, 4, seed=2)], {"epsilon": 1e-12})],
    "rms_norm": [lambda: ([_f(2, 3, 4), _f(3, 4, seed=1)],
                          {"begin_norm_axis": 1})],
    "group_norm": [lambda: ([_f(2, 3, 2, 4), 2], {
        "weight": _f(4, seed=1), "bias": _f(4, seed=2),
        "data_format": "NHWC"})],
    "instance_norm": [lambda: ([_f(2, 3, 5)], {"weight": _f(3, seed=1),
                                               "bias": _f(3, seed=2)})],
    "normalize": [lambda: ([_f(3, 4)], {"p": 3, "axis": 0})],
    "embedding": [lambda: ([_i(0, 4, 2, 2, 1, 0, shape=(2, 3)), _f(5, 3)],
                           {"padding_idx": 2}),
                  lambda: ([_i(-1, 3, 5, -7, shape=(4,)), _f(5, 3)], {})],
    "gelu": [lambda: ([_f(2, 3)], {"approximate": True})],
    "cross_entropy": [
        lambda: ([_f(4, 5), _i(0, 3, -100, 4)], {}),
        lambda: ([_f(4, 5), _i(0, 3, 1, 4, shape=(4, 1))],
                 {"weight": _f(5, lo=0.5, hi=2.0), "reduction": "sum"}),
        lambda: ([_f(4, 5), _i(0, 3, -100, 4)],
                 {"weight": _f(5, lo=0.5, hi=2.0)}),
        lambda: ([_f(2, 5, 3), _i(0, 3, 1, 4, 2, 2, shape=(2, 3))],
                 {"axis": 1, "reduction": "none"}),
        lambda: ([_f(4, 5), _i(0, 3, 1, 4)], {"label_smoothing": 0.1}),
        lambda: ([_f(4, 5), _f(4, 5, seed=1, lo=0.0, hi=1.0)],
                 {"soft_label": True, "weight": _f(5, lo=0.5, hi=2.0)}),
        lambda: ([_f(4, 5, lo=0.05, hi=0.95), _i(0, 3, 1, 4)],
                 {"use_softmax": False}),
    ],
    "binary_cross_entropy_with_logits": [
        lambda: ([_f(2, 3), _f(2, 3, seed=1, lo=0.0, hi=1.0)],
                 {"pos_weight": _f(3, lo=0.5, hi=2.0),
                  "weight": _f(2, 3, seed=2, lo=0.5, hi=2.0)})],
    "nll_loss": [lambda: ([_f(4, 5), _i(0, 3, -100, 4)], {}),
                 lambda: ([_f(4, 5), _i(0, 3, 1, 4)],
                          {"weight": _f(5, lo=0.5, hi=2.0)}),
                 lambda: ([_f(4, 5), _i(0, 3, -100, 4)],
                          {"weight": _f(5, lo=0.5, hi=2.0),
                           "reduction": "none"})],
    "kl_div": [lambda: ([_f(2, 3), _f(2, 3, seed=1)],
                        {"log_target": True, "reduction": "batchmean"})],
    "poisson_nll_loss": [lambda: ([_f(2, 3, lo=0.5, hi=2.0),
                                   _f(2, 3, seed=1, lo=0.0, hi=4.0)],
                                  {"log_input": False, "full": True})],
    "triplet_margin_loss": [lambda: ([_f(2, 3), _f(2, 3, seed=1),
                                      _f(2, 3, seed=2)],
                                     {"swap": True, "p": 1.5})],
    "sigmoid_focal_loss": [lambda: ([_f(2, 3),
                                     _i(0, 1, 1, 0, 0, 1, shape=(2, 3))
                                     .astype(np.float32)],
                                    {"normalizer": np.float32(3.0)})],
    "dice_loss": [lambda: ([_f(2, 3, 4, lo=0.0, hi=1.0),
                            _i(0, 3, 1, 2, 2, 0, shape=(2, 3, 1))], {})],
    "npair_loss": [lambda: ([_f(4, 3), _f(4, 3, seed=1), _i(0, 1, 0, 2)],
                            {})],
    "ctc_loss": [lambda: ([_f(6, 2, 4), _i(1, 2, 3, 2, 1, 0, shape=(2, 3)),
                           _i(6, 5), _i(3, 2)], {}),
                 lambda: ([_f(6, 2, 4), _i(1, 1, 3, 2, 1, 0, shape=(2, 3)),
                           _i(6, 4), _i(3, 2)],
                          {"reduction": "sum", "norm_by_times": True})],
    "rnnt_loss": [lambda: ([_f(2, 4, 3, 5), _i(1, 4, 2, 0, shape=(2, 2)),
                            _i(4, 3), _i(2, 1)], {}),
                  lambda: ([_f(2, 3, 3, 4), _i(3, 1, 2, 2, shape=(2, 2)),
                            _i(3, 3), _i(2, 2)],
                           {"fastemit_lambda": 0.0, "reduction": "none"})],
    "margin_cross_entropy": [
        lambda: ([_f(4, 5, lo=-0.9, hi=0.9), _i(0, 3, 1, 4)], {}),
        lambda: ([_f(4, 5, lo=-0.9, hi=0.9), _i(2, 3, 1, 0)],
                 {"margin1": 1.0, "margin2": 0.0, "margin3": 0.35,
                  "scale": 30.0, "return_softmax": True,
                  "reduction": "none"})],
    "hsigmoid_loss": [
        lambda: ([_f(4, 3), _i(0, 5, 3, 1), 6, _f(5, 3, seed=1)],
                 {"bias": _f(5, 1, seed=2)}),
        lambda: ([_f(3, 3), _i(0, 1, 2), 3, _f(4, 3, seed=1)],
                 {"path_table": _i(0, 1, -1, 0, 2, 3, 1, -1, -1,
                                   shape=(3, 3)),
                  "path_code": _i(1, 0, 0, 0, 1, 1, 1, 0, 0,
                                  shape=(3, 3))})],
}


# Contract cases whose gradient is 0 in exact arithmetic, so that both
# packages return rounding noise: group_norm's [2, 2, 2] in 2 groups
# normalises pairs, whose outputs are +-1 whatever the input. The
# written cases stand in for them.
DEGENERATE = {"group_norm"}


def module_of(name) -> str:
    return REF_OPS[name].__module__.rsplit(".", 1)[1]


def cases(modules):
    """(op name, case index) of every op of ``modules`` but the random
    ones; index -1 is the contract's case."""
    out = []
    for name in sorted(REF_OPS):
        if name in RANDOM or module_of(name) not in modules:
            continue
        c = CONTRACTS.get(name, {})
        if c.get("status") == "ok" and name not in DEGENERATE:
            out.append((name, -1))
        for i in range(len(MANUAL.get(name, ()))):
            out.append((name, i))
    return out


def check_op(name, i):
    """The port's op ``name`` against the reference's at case ``i``:
    outputs, then the vjp of a seeded cotangent."""
    args, kwargs = (_contract_case(name) if i < 0 else MANUAL[name][i]())
    r_outs, r_in = _run(ref, REF_OPS[name], args, kwargs)
    p_outs, p_in = _run(port, PORT_OPS[name], args, kwargs)
    assert len(p_outs) == len(r_outs)
    for j, (po, ro) in enumerate(zip(p_outs, r_outs)):
        _assert_same(_np(po), _np(ro), FWD_RTOL, f"{name} output {j}")
    if not _opdef(REF_OPS[name], RefOpDef).differentiable or not r_in:
        return
    pairs = [(po, ro) for po, ro in zip(p_outs, r_outs)
             if np.asarray(ro.numpy()).dtype.kind == "f"
             and not ro.stop_gradient]
    if not pairs:
        return
    rng = np.random.default_rng(1)
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


def same_fn(fn_name, args, kwargs=None):
    kwargs = kwargs or {}
    r, r_in = _run(ref, getattr(ref.nn.functional, fn_name), args, kwargs)
    p, p_in = _run(port, getattr(port.nn.functional, fn_name), args, kwargs)
    assert len(p) == len(r)
    for po, ro in zip(p, r):
        _assert_same(_np(po), _np(ro), FWD_RTOL, fn_name)
    return p, r
