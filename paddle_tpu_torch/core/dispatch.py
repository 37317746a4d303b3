"""Op dispatch: the one funnel every framework op goes through (port of
paddle_tpu/core/dispatch.py).

``op_call``:

  1. extracts Tensors from the arguments (nested in lists, tuples and
     dicts) and takes their torch buffers,
  2. fires the dispatch hooks,
  3. runs the op's torch impl, after the active AMP cast policy, with
     grad recording on only where the op is differentiable, grad mode is
     on and an input requires grad (torch autograd is the tape),
  4. checks the outputs for NaN/Inf under ``check_nan_inf``,
  5. wraps the outputs back into Tensors (``None`` slots kept).

An impl that calls another op's public wrapper runs that op raw (the
thread-local depth below): the outermost call owns the tape, AMP and
hooks. The funnel never catches an impl's error. The reference's
lazy-segment branch (jit/lazy_segments.py) has no counterpart until the
``jit`` item of ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, NamedTuple

import torch

from . import autograd
from .flags import GLOBAL_FLAGS
from .tensor import Tensor

__all__ = ["OpDef", "OP_REGISTRY", "op", "op_call", "unregister_op",
           "register_split_vjp", "SPLIT_VJP", "AMP_STATE", "DISPATCH_HOOKS"]


class _Ph:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __repr__(self):
        return f"Ph({self.i})"


def _extract(obj, leaves: list):
    if isinstance(obj, Tensor):
        leaves.append(obj)
        return _Ph(len(leaves) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_extract(o, leaves) for o in obj)
    if isinstance(obj, dict):
        return {k: _extract(v, leaves) for k, v in obj.items()}
    return obj


def _rebuild(obj, arrays):
    if isinstance(obj, _Ph):
        return arrays[obj.i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(o, arrays) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, arrays) for k, v in obj.items()}
    return obj


class OpDef(NamedTuple):
    name: str
    impl: Callable
    differentiable: bool
    amp_policy: str  # 'cast' (to low precision), 'keep_fp32', 'promote', 'none'


OP_REGISTRY: dict[str, OpDef] = {}


class _ImplDepth(threading.local):
    def __init__(self):
        self.v = 0


_IMPL_DEPTH = _ImplDepth()

# The zero-bubble split-backward rules by op name, read while
# ``WeightGradStore`` is enabled (core/autograd.py): ``(qualifies,
# rule)``. ``qualifies(arrays, wslots)`` decides at forward time whether
# the call's pattern splits (``wslots``: the slots holding leaf
# parameters); ``rule(arrays, wslots, kwargs, cotangents)`` returns
# ``(input grads, wgrad)``, the input grads None at the deferred slots
# and ``wgrad()`` {slot: gradient}.
SPLIT_VJP: dict[str, tuple] = {}


def register_split_vjp(name: str, qualifies: Callable):
    def deco(rule):
        SPLIT_VJP[name] = (qualifies, rule)
        return rule

    return deco


# Set by paddle_tpu_torch.amp while an auto_cast scope is active:
#   {"enable": bool, "dtype": torch dtype, "level": "O1"|"O2",
#    "white": set, "black": set}
AMP_STATE: dict | None = None

# Profiler / tracing hooks: fn(op_name), called once per dispatch.
DISPATCH_HOOKS: list[Callable[[str], Any]] = []

_LOW = (torch.float16, torch.bfloat16)


def _amp_cast_arrays(opdef: OpDef, arrays: list):
    state = AMP_STATE
    if state is None or not state.get("enable"):
        return arrays
    policy = opdef.amp_policy
    if opdef.name in state.get("black", ()):
        policy = "keep_fp32"
    elif opdef.name in state.get("white", ()):
        policy = "cast"
    target = state["dtype"]
    if policy == "cast" or (state.get("level") == "O2"
                            and policy != "keep_fp32"):
        return [a.to(target) if a.dtype == torch.float32 else a
                for a in arrays]
    if policy == "keep_fp32":
        return [a.float() if a.dtype in _LOW else a for a in arrays]
    return arrays


def _check_nan_inf(name: str, outs):
    for o in outs if isinstance(outs, tuple) else (outs,):
        if not isinstance(o, torch.Tensor) or not (
                o.dtype.is_floating_point or o.dtype.is_complex):
            continue
        if not bool(torch.isfinite(o).all()):
            msg = f"NaN or Inf detected in output of op '{name}'"
            if GLOBAL_FLAGS.get("check_nan_inf_level") > 0:
                print("WARNING:", msg)
            else:
                raise FloatingPointError(msg)


def _run_raw(opdef: OpDef, t_args, t_kwargs, arrays):
    _IMPL_DEPTH.v += 1
    try:
        return opdef.impl(*_rebuild(t_args, arrays),
                          **_rebuild(t_kwargs, arrays))
    finally:
        _IMPL_DEPTH.v -= 1


class _SplitSpec(NamedTuple):
    opdef: OpDef
    t_args: Any
    t_kwargs: Any
    rule: Callable
    wslots: tuple
    leaves: tuple          # the op's torch inputs before the AMP cast
    extras: dict           # the rule's kwargs


class _SplitOp(torch.autograd.Function):
    """An op with a split rule on the tape while the store is enabled:
    its backward returns the activation gradient and defers the leaf
    parameters' to ``WeightGradStore`` while the store is enabled, and
    computes them at once otherwise."""

    @staticmethod
    def forward(ctx, spec, *arrays):
        ctx.spec = spec
        ctx.save_for_backward(*arrays)
        outs = _run_raw(spec.opdef, spec.t_args, spec.t_kwargs, list(arrays))
        return tuple(outs) if isinstance(outs, list) else outs

    @staticmethod
    def backward(ctx, *cots):
        spec = ctx.spec
        arrays = list(ctx.saved_tensors)
        in_grads, wgrad = spec.rule(arrays, spec.wslots, spec.extras,
                                    list(cots))
        in_grads = list(in_grads)
        if autograd.WeightGradStore.enabled():
            leaves = spec.leaves

            def thunk():
                return [(leaves[i], g.to(leaves[i].dtype))
                        for i, g in wgrad().items()]

            autograd.WeightGradStore.put(thunk)
        else:
            for i, g in wgrad().items():
                in_grads[i] = g
        return (None,) + tuple(
            None if g is None or not need else g.to(a.dtype)
            for g, a, need in zip(in_grads, arrays, ctx.needs_input_grad[1:]))


def _split_spec(opdef: OpDef, t_args, t_kwargs, leaves):
    """The split record of this call, or None: the op has a rule, the
    store is enabled, and the rule's pattern (a leaf parameter in the
    deferred slots) qualifies. A declined call keeps torch's backward."""
    entry = SPLIT_VJP.get(opdef.name)
    if entry is None or not autograd.WeightGradStore.enabled():
        return None
    qualifies, rule = entry
    wslots = tuple(i for i, t in enumerate(leaves)
                   if t._data.is_leaf and t._data.requires_grad)
    if not wslots or not qualifies([t._data for t in leaves], wslots):
        return None
    extras = dict(t_kwargs) if t_kwargs else {}
    extras["_positional_extras"] = [a for a in t_args
                                    if not isinstance(a, _Ph)]
    return _SplitSpec(opdef, t_args, t_kwargs, rule, wslots,
                      tuple(t._data for t in leaves), extras)


def op_call(opdef: OpDef, args, kwargs):
    leaves: list[Tensor] = []
    t_args = _extract(list(args), leaves)
    t_kwargs = _extract(kwargs, leaves) if kwargs else {}

    if _IMPL_DEPTH.v > 0:
        # nested: an impl calling another op's wrapper gets torch tensors
        return _run_raw(opdef, t_args, t_kwargs, [t._data for t in leaves])

    requires_grad = (opdef.differentiable and autograd.is_grad_enabled()
                     and any(t._data.requires_grad for t in leaves))

    for hook in DISPATCH_HOOKS:
        hook(opdef.name)

    spec = _split_spec(opdef, t_args, t_kwargs, leaves) \
        if requires_grad else None
    with torch.set_grad_enabled(requires_grad):
        arrays = _amp_cast_arrays(opdef, [t._data for t in leaves])
        if spec is None:
            outs = _run_raw(opdef, t_args, t_kwargs, arrays)
        else:
            outs = _SplitOp.apply(spec, *arrays)
    if isinstance(outs, list):
        outs = tuple(outs)

    if GLOBAL_FLAGS.get("check_nan_inf"):
        _check_nan_inf(opdef.name, outs)

    def wrap(arr):
        if arr is None:
            return None
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(arr)
        return Tensor(arr, stop_gradient=not (requires_grad
                                              and arr.requires_grad))

    if isinstance(outs, tuple):
        return tuple(wrap(o) for o in outs)
    return wrap(outs)


def unregister_op(name: str) -> None:
    """Remove a registration. Public wrappers close over their OpDef, so
    removal only affects registry lookups. Unknown names raise
    ``KeyError``."""
    if name not in OP_REGISTRY:
        raise KeyError(f"unregister_op: no registered op named '{name}'")
    del OP_REGISTRY[name]


def op(name: str | None = None, differentiable: bool = True,
       amp: str = "none"):
    """Register a framework op from a torch implementation: its schema is
    the Python signature, its kernel the torch impl, its grad rule torch
    autograd's, its AMP list membership ``amp``."""

    def deco(impl):
        op_name = name or impl.__name__
        opdef = OpDef(op_name, impl, differentiable, amp)
        OP_REGISTRY[op_name] = opdef

        @functools.wraps(impl)
        def wrapper(*args, **kwargs):
            return op_call(opdef, args, kwargs)

        wrapper.op_name = op_name
        return wrapper

    return deco
