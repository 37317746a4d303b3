"""Define-by-run autograd (port of paddle_tpu/core/autograd.py).

The reference records its own tape of GradNodes, each holding the
``jax.vjp`` pullback of one op. The port's tape is torch autograd: every
op of the funnel (core/dispatch.py) runs its torch impl with grad
recording on where the op is differentiable, so the produced buffers
carry ``grad_fn`` and ``backward`` / ``grad`` walk torch's graph. What
the reference's engine guarantees holds here too:

- a second ``backward`` through a released graph raises
  ``RuntimeError`` unless the first passed ``retain_graph=True``;
- a non-scalar output needs a ``grad_tensor``;
- gradients accumulate on leaves across backwards;
- a hook fires once, on the gradient accumulated for its tensor;
- ``grad`` writes no ``.grad``; with ``create_graph=True`` its results
  are on the tape (double and triple grad).

Grad mode is thread-local (``_GradState``) and mirrored into torch's.
``WeightGradStore`` is the zero-bubble pipeline's split backward (the
schedule is ``distributed/fleet/meta_parallel/pipeline_parallel.py``).
"""

from __future__ import annotations

import threading

import torch

__all__ = ["WeightGradStore", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "backward", "grad"]


class _GradState(threading.local):
    def __init__(self):
        self.enabled = True


_state = _GradState()


def is_grad_enabled() -> bool:
    return _state.enabled


def set_grad_enabled(mode: bool) -> None:
    _state.enabled = bool(mode)
    torch.set_grad_enabled(bool(mode))


class _GradModeGuard:
    """Context manager / decorator toggling grad recording."""

    def __init__(self, mode: bool):
        self._mode = mode
        self._prev = None

    def __enter__(self):
        self._prev = (_state.enabled, torch.is_grad_enabled())
        _state.enabled = self._mode
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        _state.enabled = self._prev[0]
        torch.set_grad_enabled(self._prev[1])
        return False

    def __call__(self, fn):
        def wrapper(*args, **kwargs):
            with _GradModeGuard(self._mode):
                return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapper


def no_grad():
    return _GradModeGuard(False)


def enable_grad():
    return _GradModeGuard(True)


class WeightGradStore:
    """The zero-bubble pipeline's deferred weight gradients (reference
    core/autograd.py:95-158).

    While the store is enabled (the zero-bubble schedule enables it
    around its forwards and its B passes), the funnel records an op with
    a split rule (``core/dispatch.py::SPLIT_VJP``: ``linear``,
    ``matmul``) whose pattern qualifies as a ``torch.autograd.Function``.
    Its backward returns the activation gradient at once and, while the
    store is enabled, enqueues a thunk for the parameters' gradients;
    with the store off it computes both at once. ``flush(limit)`` runs
    the thunks oldest first and hands each gradient to torch's engine on
    its leaf (``torch.autograd.backward``), so that tensor hooks and
    post-accumulate hooks fire as for any gradient. With the store off
    nothing changes: the ops keep torch's native backward.
    """

    # process-wide, not thread-local as the reference's: torch runs a
    # CUDA backward on its engine's device thread, not the caller's
    _state = {"enabled": False, "queue": []}

    @classmethod
    def _q(cls) -> list:
        return cls._state["queue"]

    @classmethod
    def enabled(cls) -> bool:
        return cls._state["enabled"]

    @classmethod
    def enable(cls) -> None:
        cls._state["enabled"] = True

    @classmethod
    def disable(cls) -> None:
        cls._state["enabled"] = False

    @classmethod
    def put(cls, thunk) -> None:
        cls._q().append(thunk)

    @classmethod
    def size(cls) -> int:
        return len(cls._q())

    @classmethod
    def flush(cls, limit: int | None = None) -> int:
        """Run up to ``limit`` deferred thunks (all if None), oldest
        first, so that each leaf accumulates in the order of the
        unsplit backward. Returns the number run."""
        q = cls._q()
        n = len(q) if limit is None else min(limit, len(q))
        for _ in range(n):
            pairs = q.pop(0)()
            if pairs:
                with torch.enable_grad():
                    torch.autograd.backward([t for t, _ in pairs],
                                            [g for _, g in pairs])
        return n

    @classmethod
    def clear(cls) -> None:
        cls._q().clear()


def _seed_grads(outputs, grad_outputs):
    """(torch outputs that require grad, their cotangents); a missing
    cotangent is ones for a one-element output and an error otherwise."""
    from .tensor import Tensor, as_torch

    outs, cots = [], []
    for t, g in zip(outputs, grad_outputs):
        d = t._data
        if not d.requires_grad:
            continue
        if g is None:
            if d.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    f"outputs; got shape {list(d.shape)}")
            g = torch.ones_like(d)
        else:
            g = g._data if isinstance(g, Tensor) else \
                as_torch(g, device=d.device)
            g = g.to(d.dtype)
        outs.append(d)
        cots.append(g)
    return outs, cots


def _as_list(x, n=None):
    from .tensor import Tensor

    if x is None:
        return [None] * (n or 0)
    if isinstance(x, Tensor):
        return [x]
    return list(x)


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Reverse accumulation from ``tensors`` into the leaves' ``.grad``
    (reference ``egr::Backward``)."""
    tensors = _as_list(tensors)
    grad_tensors = _as_list(grad_tensors, len(tensors))
    outs, cots = _seed_grads(tensors, grad_tensors)
    if outs:
        with torch.enable_grad():
            torch.autograd.backward(outs, cots, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph: bool = False,
         create_graph: bool = False, allow_unused: bool = False):
    """Gradients of ``outputs`` with respect to ``inputs`` (reference
    paddle.grad), touching no ``.grad``. An input the outputs do not
    depend on raises unless ``allow_unused``, which returns None for it.
    ``create_graph=True`` returns gradients on the tape (and implies
    ``retain_graph``)."""
    from .tensor import Tensor

    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grad_outputs = _as_list(grad_outputs, len(outputs))
    outs, cots = _seed_grads(outputs, grad_outputs)
    live = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    found = [None] * len(inputs)
    if outs and live:
        with torch.enable_grad():
            res = torch.autograd.grad(
                outs, [inputs[i]._data for i in live], cots,
                retain_graph=retain_graph or create_graph,
                create_graph=create_graph, allow_unused=True)
        for i, r in zip(live, res):
            found[i] = r
    results = []
    for r in found:
        if r is None:
            if not allow_unused:
                raise RuntimeError(
                    "one of the input tensors received no gradient; pass "
                    "allow_unused=True to get None instead")
            results.append(None)
        else:
            results.append(Tensor(r, stop_gradient=not r.requires_grad))
    return results
