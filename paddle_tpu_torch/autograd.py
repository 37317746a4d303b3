"""User-facing autograd package (port of paddle_tpu/autograd.py).

``backward``/``grad``/``no_grad`` re-export the engine; ``PyLayer``
provides custom forward/backward definitions recorded on the same tape
(torch autograd, through a ``torch.autograd.Function`` that calls the
user's ``backward``). ``jacobian``, ``hessian``, ``vjp`` and ``jvp``
return the reference's structure (jax's nesting: outputs outside,
inputs inside), computed with ``torch.autograd.grad``: one reverse pass
a row of a Jacobian, a Hessian as the Jacobian of the gradient, and a
JVP as the gradient of a VJP with respect to its cotangent.
"""

from __future__ import annotations

import torch

from .core.autograd import (backward, enable_grad, grad,  # noqa: F401
                            is_grad_enabled, no_grad)
from .core.tensor import Tensor, as_torch

__all__ = [
    "backward",
    "grad",
    "no_grad",
    "enable_grad",
    "is_grad_enabled",
    "PyLayer",
    "PyLayerContext",
    "saved_tensors_hooks",
]


class PyLayerContext:
    """Context passed to PyLayer.forward/backward for residual stashing.

    If a :class:`saved_tensors_hooks` scope is active at forward time, its
    pack hook is applied to every saved tensor and the matching unpack hook
    at access time (activation-offload workflows).
    """

    def __init__(self):
        self._saved: tuple = ()
        self._unpack = None
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        scope = saved_tensors_hooks._active[-1] \
            if saved_tensors_hooks._active else None
        if scope is not None:
            self._saved = tuple(scope.pack_hook(t) for t in tensors)
            self._unpack = scope.unpack_hook
        else:
            self._saved = tuple(tensors)

    @property
    def saved_tensor(self):
        if self._unpack is not None:
            return tuple(self._unpack(t) for t in self._saved)
        return self._saved

    saved_tensors = saved_tensor


class _PyLayerFunction(torch.autograd.Function):
    """The tape node of one ``PyLayer.apply``: its forward returns the
    outputs the user's forward already computed (so they join the tape
    with this node as producer); its backward calls the user's backward
    under ``no_grad``. As the reference's node stores no primal, a
    gradient with ``create_graph`` through it raises."""

    @staticmethod
    def forward(fctx, layer_cls, ctx, outs, *inputs):
        fctx.set_materialize_grads(False)
        # a token saved tensor: torch frees it after a backward without
        # retain_graph, so a second backward through this node raises
        fctx.save_for_backward(torch.empty(0))
        fctx.layer_cls, fctx.ctx, fctx.n_inputs = layer_cls, ctx, len(inputs)
        fctx.out_meta = [(o.shape, o.dtype, o.device) for o in outs]
        return tuple(outs)

    @staticmethod
    def backward(fctx, *out_grads):
        fctx.saved_tensors  # raises once the graph was released
        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"create_graph through op '{fctx.layer_cls.__name__}' (no "
                "stored primal; e.g. custom PyLayer nodes) is not supported")
        ctx = fctx.ctx
        cots = []
        for g, (shape, dtype, dev) in zip(out_grads, fctx.out_meta):
            if g is None and ctx.materialize_grads:
                g = torch.zeros(shape, dtype=dtype, device=dev)
            cots.append(Tensor(g, stop_gradient=True)
                        if g is not None else None)
        with no_grad():
            res = fctx.layer_cls.backward(ctx, *cots)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        out = []
        for r in res[:fctx.n_inputs]:
            if r is None:
                out.append(None)
            else:
                out.append(r._data if isinstance(r, Tensor) else as_torch(r))
        # pad with Nones for inputs that get no grad
        out += [None] * (fctx.n_inputs - len(out))
        return (None, None, None, *out)


class PyLayer:
    """Custom op with user-defined forward and backward.

    Usage matches the reference::

        class Tanh(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle_tpu_torch.tanh(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor
                return dy * (1 - y * y)

    Tensors passed by keyword are inputs too (after the positional ones,
    in the order of the keywords); ``backward`` returns one gradient a
    tensor input, missing trailing ones count as None. An output's
    gradient that no consumer produced reaches ``backward`` as zeros,
    or as None when the forward set ``ctx.materialize_grads = False``.
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        tensor_inputs = [a for a in args if isinstance(a, Tensor)] + [
            v for v in kwargs.values() if isinstance(v, Tensor)]
        requires = is_grad_enabled() and any(
            not t.stop_gradient for t in tensor_inputs)
        with no_grad():
            outs = cls.forward(ctx, *args, **kwargs)
        single = not isinstance(outs, (tuple, list))
        outs_t = (outs,) if single else tuple(outs)
        if requires:
            with torch.enable_grad():
                linked = _PyLayerFunction.apply(
                    cls, ctx, [o._data for o in outs_t],
                    *[t._data for t in tensor_inputs])
            for o, d in zip(outs_t, linked):
                o._data = d
                o._hooked = None
        return outs if not single else outs_t[0]


class saved_tensors_hooks:
    """Pack/unpack hooks for activation offload-style workflows
    (reference: python/paddle/autograd/saved_tensors_hooks.py). As in the
    reference, they apply only to PyLayer ``save_for_backward`` payloads:
    what the tape's own nodes save is not packed.
    """

    _active: list = []

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        saved_tensors_hooks._active.append(self)
        return self

    def __exit__(self, *exc):
        saved_tensors_hooks._active.pop()
        return False


# ---------------------------------------------------------------------------
# functional transforms (reference: python/paddle/autograd/autograd.py:461
# jacobian/hessian; incubate functional vjp/jvp)
# ---------------------------------------------------------------------------

def _as_leaves(xs):
    """(single, fresh leaves that require grad) for ``xs``."""
    single = not isinstance(xs, (list, tuple))
    xs_t = [xs] if single else list(xs)
    return single, [x._data.detach().clone().requires_grad_(True)
                    for x in xs_t]


def _call(func, leaves):
    """``func`` on Tensors over ``leaves`` with the tape on: its outputs'
    torch buffers, a tuple when it returned a list or tuple, else one."""
    with enable_grad():
        out = func(*[Tensor(a, stop_gradient=False) for a in leaves])
    if isinstance(out, (tuple, list)):
        return tuple(o._data if isinstance(o, Tensor) else o for o in out)
    return out._data if isinstance(out, Tensor) else out


def _grads(out, leaves, cot, create_graph=False):
    """d<out, cot>/d leaves, zeros where ``out`` does not depend on a
    leaf."""
    if not out.requires_grad:
        return [torch.zeros_like(x) for x in leaves]
    gs = torch.autograd.grad(out, leaves, cot, retain_graph=True,
                             create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


def _jac_rows(out, leaves, create_graph=False):
    """The Jacobian of ``out`` with respect to each leaf, one reverse pass
    an element of ``out``: a list of [*out.shape, *leaf.shape]."""
    flat = out.reshape(-1)
    rows = [[] for _ in leaves]
    for i in range(flat.numel()):
        cot = torch.zeros_like(flat)
        cot[i] = 1
        for r, g in zip(rows, _grads(flat, leaves, cot, create_graph)):
            r.append(g)
    return [torch.stack(r).reshape(tuple(out.shape) + tuple(x.shape))
            if r else torch.zeros(tuple(out.shape) + tuple(x.shape),
                                  dtype=x.dtype, device=x.device)
            for r, x in zip(rows, leaves)]


def _wrap(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_wrap(t) for t in tree)
    return Tensor(tree.detach())


def jacobian(func_or_ys, xs, batch_axis=None):
    """Full Jacobian of ``func(xs)`` w.r.t. xs (functional form; the
    reference's lazy-row Jacobian object API evaluates the same values).
    One ``xs``: a Tensor (a tuple of them a output when ``func`` returns
    several). Several ``xs``: a tuple over ``xs`` (nested inside a tuple
    over outputs when ``func`` returns several)."""
    if not callable(func_or_ys):
        raise TypeError("jacobian expects a callable; the legacy "
                        "(ys, xs) form requires retained graphs")
    single, leaves = _as_leaves(xs)
    outs = _call(func_or_ys, leaves)
    multi_out = isinstance(outs, tuple)
    per_out = [_jac_rows(o, leaves) for o in (outs if multi_out
                                               else (outs,))]
    if single:
        per_out = [r[0] for r in per_out]
    else:
        per_out = [tuple(r) for r in per_out]
    return _wrap(tuple(per_out) if multi_out else per_out[0])


def hessian(func, xs, batch_axis=None):
    """Hessian of a scalar-output function (reference autograd.py), the
    Jacobian of its Jacobian: one ``xs`` gives a Tensor [*x.shape,
    *x.shape], several a tuple of tuples (block [i][j] is d2 f / dx_i
    dx_j)."""
    single, leaves = _as_leaves(xs)
    out = _call(func, leaves)
    if isinstance(out, tuple):
        raise TypeError("hessian needs a function with one output")
    jac = _jac_rows(out, leaves, create_graph=True)
    hes = tuple(tuple(_jac_rows(j, leaves)) for j in jac)
    if single:
        return _wrap(hes[0][0])
    return _wrap(hes)


def vjp(func, xs, v=None):
    """(outputs, vjp_result) — reference incubate.autograd.vjp. ``v``
    defaults to ones over every output; one ``xs`` returns one gradient,
    several a tuple."""
    single, leaves = _as_leaves(xs)
    outs = _call(func, leaves)
    multi_out = isinstance(outs, tuple)
    outs_t = outs if multi_out else (outs,)
    if v is None:
        cots = [torch.ones_like(o) for o in outs_t]
    else:
        cots = [v._data] if isinstance(v, Tensor) else [t._data for t in v]
    live = [(o, c) for o, c in zip(outs_t, cots) if o.requires_grad]
    if live:
        gs = torch.autograd.grad([o for o, _ in live], leaves,
                                 [c for _, c in live], allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(gs, leaves)]
    else:
        grads = [torch.zeros_like(x) for x in leaves]
    grads = _wrap(tuple(grads))
    if single:
        grads = grads[0]
    return _wrap(outs), grads


def jvp(func, xs, v=None):
    """(outputs, jvp_result) — forward-mode directional derivative,
    computed as the gradient of the VJP with respect to its cotangent
    (the VJP is linear in it). ``v`` defaults to ones over every input."""
    single, leaves = _as_leaves(xs)
    if v is None:
        tangents = [torch.ones_like(a) for a in leaves]
    else:
        v_t = [v] if single else list(v)
        tangents = [t._data for t in v_t]
    outs = _call(func, leaves)
    multi_out = isinstance(outs, tuple)
    outs_t = outs if multi_out else (outs,)
    tangent_out = []
    for o in outs_t:
        u = torch.zeros_like(o, requires_grad=True)
        pull = _grads(o, leaves, u, create_graph=True) \
            if o.requires_grad else []
        live = [(p, t) for p, t in zip(pull, tangents) if p.requires_grad]
        if live:
            (t_o,) = torch.autograd.grad([p for p, _ in live], [u],
                                         [t for _, t in live],
                                         allow_unused=True)
        else:
            t_o = None
        tangent_out.append(torch.zeros_like(o) if t_o is None else t_o)
    tangent_out = tuple(tangent_out) if multi_out else tangent_out[0]
    return _wrap(outs), _wrap(tangent_out)


__all__ += ["jacobian", "hessian", "vjp", "jvp"]
