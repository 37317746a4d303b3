"""Recompute: activation checkpointing for eager training (the port's
copy of paddle_tpu/distributed/fleet/recompute.py; reference
python/paddle/distributed/fleet/recompute/recompute.py: the reentrant
PyLayer :124, the non-reentrant saved-tensor hooks :319, the RNG state
restored before the replay :112).

Both of the reference's modes are ``torch.utils.checkpoint``'s
non-reentrant checkpoint here: the segment's activations are dropped
after its forward and recomputed when the backward reaches them, so a
segment keeps only its inputs. ``use_reentrant`` is accepted, as the
reference accepts it. The replay runs under the AMP state the forward
ran under (the port's autocast is its own, not torch's), and
``preserve_rng_state`` replays it on the random state it first ran
with: torch's own generators, and the port's generator
(``core/random.py``, which dropout draws from) with the model-parallel
tracker's named streams, so that a recomputed dropout draws the same
mask.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...core.tensor import Tensor
from ...nn.layer.layers import Layer

__all__ = ["recompute", "recompute_sequential"]


def _rng_snapshot():
    from ...core import device as _device
    from ...core import random as _random
    from .random import get_rng_state_tracker

    gen = _random.default_generator().torch_generator(
        _device.current_device())
    return gen, gen.get_state(), get_rng_state_tracker().get_states_tracker()


def _contexts(preserve: bool):
    """(forward, recompute) context managers: the first records the AMP
    state and, with ``preserve``, the port's random state; the second
    runs the replay under them and restores what the backward had."""
    from ...core import dispatch
    from .random import get_rng_state_tracker

    saved = {}

    @contextlib.contextmanager
    def forward():
        saved["amp"] = dispatch.AMP_STATE
        if preserve:
            saved["gen"], saved["state"], saved["tracker"] = _rng_snapshot()
        yield

    @contextlib.contextmanager
    def replay():
        tracker = get_rng_state_tracker()
        amp = dispatch.AMP_STATE
        dispatch.AMP_STATE = saved["amp"]
        if preserve:
            gen, now, now_tracker = _rng_snapshot()
            saved["gen"].set_state(saved["state"])
            tracker.set_states_tracker(saved["tracker"])
        try:
            yield
        finally:
            dispatch.AMP_STATE = amp
            if preserve:
                gen.set_state(now)
                tracker.set_states_tracker(now_tracker)

    return lambda: (forward(), replay())


def _unwrap(out):
    if isinstance(out, Tensor):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return out


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor(out, stop_gradient=not out.requires_grad)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


def recompute(function, *args, **kwargs):
    """Call ``function(*args, **kwargs)`` with its activations recomputed
    in the backward (reference recompute.py:124). The Tensors among
    ``args`` are the segment's inputs; a Layer's parameters are reached
    through it."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)

    def run(*arrays):
        it = iter(arrays)
        call = [_wrap(next(it)) if isinstance(a, Tensor) else a
                for a in args]
        return _unwrap(function(*call, **kwargs))

    tensors = [a._data for a in args if isinstance(a, Tensor)]
    out = checkpoint(run, *tensors, use_reentrant=False,
                     preserve_rng_state=preserve,
                     context_fn=_contexts(preserve))
    return _wrap(out)


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Checkpoint a Sequential (or a list of layers) in
    ``ctx["segments"]`` chunks (reference recompute_sequential)."""
    from ...nn.layer.container import Sequential

    segments = int((ctx or {}).get("segments", 1))
    if isinstance(functions, Layer):
        layers = list(functions.children()) or [functions]
    else:
        layers = list(functions)
    per = max(1, len(layers) // segments)
    out = args
    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]
        seg = chunk[0] if len(chunk) == 1 else Sequential(*chunk)
        out = (recompute(seg, *out, **kwargs),)
    return out[0]
