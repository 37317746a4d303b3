"""Shared by the op-library parity tests of the long tail
(tests/test_torch_ops_{linalg,extra,parity}.py): the same numpy inputs
from a seed go through an op of each package; the outputs and, for a
differentiable op, the vjp of a seeded cotangent are compared.

A case is (args, kwargs) with numpy arrays standing for tensors: float
arrays become tensors that require grad, other arrays plain tensors.
``hold`` compares every output at ``fwd_rtol`` (and ``fwd_rtol`` of the
output's largest magnitude, for entries that cancel to ~0), integer and
boolean outputs exactly; then, where the reference's op is
differentiable, the gradient of sum(cotangent · output) over the
outputs ``grad_outs`` selects, at ``vjp_rtol``. Where an output is not
unique (a decomposition's signs), ``check`` replaces the comparison and
``loss`` builds a scalar that does not depend on the choice.
"""

import ast

import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_ops_cases import ROOT, assert_same

FWD_RTOL = 1e-6
VJP_RTOL = 1e-5


def wrappers(mod):
    """The module's funnel ops by registered name."""
    return {v.op_name: v for v in vars(mod).values()
            if hasattr(v, "op_name")
            and getattr(v, "__module__", None) == mod.__name__}


def opdef(wrapper, cls):
    return next(c.cell_contents for c in wrapper.__closure__
                if isinstance(c.cell_contents, cls))


def reference_op_flags(module_file):
    """{name: (differentiable, amp)} of every ``@op`` in a reference
    module's source, nested registrations included."""
    tree = ast.parse((ROOT / module_file).read_text())
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "op" \
                and n.args and isinstance(n.args[0], ast.Constant):
            kw = {k.arg: ast.literal_eval(k.value) for k in n.keywords}
            out[n.args[0].value] = (kw.get("differentiable", True),
                                    kw.get("amp", "none"))
    return out


def tensorize(pkg, obj, grads: list, requires_grad=True):
    if isinstance(obj, np.ndarray):
        floating = obj.dtype.kind == "f" and requires_grad
        t = pkg.to_tensor(obj, stop_gradient=not floating)
        if floating:
            grads.append(t)
        return t
    if isinstance(obj, list) and obj and isinstance(obj[0], np.ndarray):
        return [tensorize(pkg, o, grads, requires_grad) for o in obj]
    if isinstance(obj, tuple) and obj and isinstance(obj[0], np.ndarray):
        return tuple(tensorize(pkg, o, grads, requires_grad) for o in obj)
    return obj


def run(pkg, fn, args, kwargs, requires_grad=True):
    leaves = []
    a = [tensorize(pkg, x, leaves, requires_grad) for x in args]
    k = {n: tensorize(pkg, v, leaves, requires_grad)
         for n, v in kwargs.items()}
    out = fn(*a, **k)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return outs, leaves


def npy(t):
    if t is None:
        return None
    if hasattr(t, "numpy"):
        return np.asarray(t.numpy())
    return np.asarray(t)


def _cotangent_loss(pkg, outs, cots):
    total = None
    for o, c in zip(outs, cots):
        term = pkg.sum(pkg.multiply(o, pkg.to_tensor(c)))
        total = term if total is None else pkg.add(total, term)
    return total


def hold(ref_fn, port_fn, case, *, differentiable=True, fwd_rtol=FWD_RTOL,
         vjp_rtol=VJP_RTOL, check=None, loss=None, grad_outs=None,
         name="op", grad_inputs=True, unordered=False):
    """Run ``case`` through both packages and compare (see the module
    docstring); ``grad_inputs`` False gives the ops inputs that do not
    require grad; ``unordered`` concerns the card only (see
    torch_ops_cases.py). Returns (port outputs, reference outputs)."""
    args, kwargs = case
    r_outs, r_in = run(ref, ref_fn, args, kwargs, grad_inputs)
    p_outs, p_in = run(port, port_fn, args, kwargs, grad_inputs)
    assert len(p_outs) == len(r_outs), name
    if check is not None:
        check([npy(o) for o in p_outs], [npy(o) for o in r_outs])
    else:
        for i, (po, ro) in enumerate(zip(p_outs, r_outs)):
            if po is None or ro is None:    # a passthrough slot
                assert po is None and ro is None, f"{name} output {i}"
                continue
            assert_same(npy(po), npy(ro), fwd_rtol, f"{name} output {i}")
    if not differentiable or not r_in:
        return p_outs, r_outs
    if loss is not None:
        r_l, p_l = loss(ref, r_outs), loss(port, p_outs)
    else:
        sel = range(len(r_outs)) if grad_outs is None else grad_outs
        sel = [i for i in sel if r_outs[i] is not None
               and npy(r_outs[i]).dtype.kind == "f"
               and not r_outs[i].stop_gradient]
        if not sel:
            return p_outs, r_outs
        rng = np.random.default_rng(1)
        cots = [rng.standard_normal(npy(r_outs[i]).shape)
                .astype(np.float32) for i in sel]
        r_l = _cotangent_loss(ref, [r_outs[i] for i in sel], cots)
        p_l = _cotangent_loss(port, [p_outs[i] for i in sel], cots)
    r_g = ref.grad([r_l], r_in, allow_unused=True)
    p_g = port.grad([p_l], p_in, allow_unused=True)
    for j, (pg, rg, x) in enumerate(zip(p_g, r_g, p_in)):
        zero = np.zeros(tuple(x.shape), np.float32)
        assert_same(zero if pg is None else npy(pg),
                    zero if rg is None else npy(rg), vjp_rtol,
                    f"{name} grad {j}")
    return p_outs, r_outs
