"""The port's training step under the resilient loop: ``make_train_step``
as the loop's ``step_fn(state, batch) -> (loss, state)``, over ``state =
{"params": ..., "opt": ...}``, the tree both packages checkpoint (the
reference's AdamW state and the port's share the names ``m``, ``v``,
``t`` and ``master``).

The port's step writes params and moments in place, so a step whose
loss is non-finite has already overwritten the state: the loop runs with
``donated_step=True`` and restores the last valid checkpoint on every bad
step."""

from __future__ import annotations

from .resilient_loop import ResilientTrainLoop
from .train_step import make_train_step

__all__ = ["adapt_train_step", "make_resilient_loop"]


def adapt_train_step(step, params: dict, opt_state: dict):
    """``(step_fn, state)`` from ``make_train_step``'s triple; ``batch``
    is ``(tokens, labels)``."""

    def step_fn(state, batch):
        tokens, labels = batch
        loss, p, o = step(state["params"], state["opt"], tokens, labels)
        return loss, {"params": p, "opt": o}

    return step_fn, {"params": params, "opt": opt_state}


def make_resilient_loop(cfg, ckpt_dir: str, step_kwargs=None,
                        **loop_kwargs) -> ResilientTrainLoop:
    """A :class:`ResilientTrainLoop` over ``make_train_step(cfg,
    **step_kwargs)``, with ``donated_step=True`` (the only setting an
    in-place step allows)."""
    if not loop_kwargs.pop("donated_step", True):
        raise ValueError("the port's step updates its state in place: a "
                         "skipped step cannot be undone without a "
                         "checkpoint, so donated_step must be True")
    step_fn, state = adapt_train_step(*make_train_step(
        cfg, **(step_kwargs or {})))
    return ResilientTrainLoop(step_fn, state, ckpt_dir, donated_step=True,
                              **loop_kwargs)
