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
``jit`` item of ROADMAP Queue 1 item 3.
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

# The reference's zero-bubble split-backward rules, stored by name; the
# port's WeightGradStore never turns on (core/autograd.py), so nothing
# reads them yet.
SPLIT_VJP: dict[str, Callable] = {}


def register_split_vjp(name: str):
    def deco(rule):
        SPLIT_VJP[name] = rule
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

    with torch.set_grad_enabled(requires_grad):
        arrays = _amp_cast_arrays(opdef, [t._data for t in leaves])
        outs = _run_raw(opdef, t_args, t_kwargs, arrays)
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
