"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py).

A subclass defines ``_init_slot(p)`` -> its state (a dict of fp32
tensors) and ``_update(g, p, state, lr, ctx)`` -> (new param, new
state). ``step`` clips the gradients, then runs the update of each
parameter under ``no_grad`` and writes the result into the parameter's
buffer in place. Every update computes in fp32, in the reference's order
of operations; the learning rate, weight decay and per-step scalars
enter as fp32 0-d tensors, as they enter the reference's jitted update.
The reference's one jitted program per device bucket has no counterpart
here: each parameter's update is its own sequence of torch ops.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.tensor import Parameter
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _f32(x):
    return x.float()


def _sqrt(x32):
    """Correctly rounded fp32 sqrt, as XLA's: CUDA's is; PyTorch's
    vectorized CPU sqrt is not in the last bit for ~0.6% of inputs, so on
    the CPU it goes through fp64, whose rounding to fp32 is exact."""
    if x32.is_cuda:
        return torch.sqrt(x32)
    return torch.sqrt(x32.double()).float()


def _scalar(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            from ..core.tensor import live_parameters

            parameters = live_parameters()
        self._parameter_list = list(parameters)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                flat.extend(g["params"])
            self._parameter_list = flat
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict[int, dict[str, Any]] = {}
        self._step_count = 0
        self._step_value: Any = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when learning rate is a scheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._learning_rate = scheduler

    # -- state --------------------------------------------------------------
    def _init_slot(self, p: Parameter) -> dict:
        return {}

    def _get_state(self, p: Parameter) -> dict:
        key = id(p)
        if key not in self._accumulators:
            with torch.no_grad():
                self._accumulators[key] = self._init_slot(p)
        return self._accumulators[key]

    def _param_lr(self, p: Parameter) -> float:
        return p.optimize_attr.get("learning_rate", 1.0) if hasattr(
            p, "optimize_attr") else 1.0

    # -- step ---------------------------------------------------------------
    def _collect(self):
        return [(p, p.grad) for p in self._parameter_list
                if not p.stop_gradient and p.grad is not None]

    def _update(self, grad, param, state, lr, ctx):
        raise NotImplementedError

    def _ctx(self) -> dict:
        """Per-step scalars shared across params (e.g. beta powers)."""
        return {}

    def step(self):
        params_grads = self._collect()
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        self._step_value = self._step_count
        ctx = self._ctx()
        with torch.no_grad():
            for p, g in params_grads:
                d = p._data
                state = self._get_state(p)
                c = {k: _scalar(v, d.device) for k, v in ctx.items()}
                c["wd"] = _scalar(self._effective_wd(p), d.device)
                new_p, new_state = self._update(
                    g._data, d, state, _scalar(lr * self._param_lr(p),
                                               d.device), c)
                d.copy_(new_p)
                self._accumulators[id(p)] = new_state

    def _effective_wd(self, p) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if hasattr(wd, "_coeff"):  # L2Decay object
            return float(wd._coeff)
        if isinstance(wd, (int, float)):
            return float(wd)
        return 0.0

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            p.clear_gradient(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        sd: dict[str, Any] = {"step_count": self._step_count}
        named = {}
        for i, p in enumerate(self._parameter_list):
            key = p.name or f"param_{i}"
            if id(p) in self._accumulators:
                named[key] = dict(self._accumulators[id(p)])
        sd["state"] = named
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        self._step_count = state_dict.get("step_count", 0)
        named = state_dict.get("state", {})
        for i, p in enumerate(self._parameter_list):
            key = p.name or f"param_{i}"
            if key in named:
                dev = p._data.device
                self._accumulators[id(p)] = {
                    k: (v.detach().to(dev).clone() if isinstance(
                        v, torch.Tensor) else torch.as_tensor(v).to(dev))
                    for k, v in named[key].items()}
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    @property
    def _parameter_names(self):
        return [p.name for p in self._parameter_list]
