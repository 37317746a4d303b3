"""The incubate optimizers (port of paddle_tpu/incubate/optimizer; Paddle's
python/paddle/incubate/optimizer): LookAhead, ModelAverage,
DistributedFusedLamb and GradientMergeOptimizer.

The port's optimizers write each update into the parameter's buffer in
place, so every weight these wrappers keep (LookAhead's slow weights,
ModelAverage's sums and its backup) is a copy of its own, never an alias
of a parameter; LookAhead's pull and ModelAverage's swap write into the
parameter in place, so a parameter keeps its identity, its gradient and
its place in every optimizer that holds it.
"""

from __future__ import annotations

import contextlib

import torch

from ...core.tensor import Tensor
from ...optimizer import Lamb
from ...optimizer.optimizer import Optimizer

__all__ = ["LookAhead", "ModelAverage", "DistributedFusedLamb",
           "GradientMergeOptimizer"]


class LookAhead(Optimizer):
    """k-step lookahead wrapper (reference incubate/optimizer/lookahead.py):
    every k inner steps the slow weights move ``alpha`` of the way to the
    fast ones, and the fast weights take the slow ones' values."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._k_count = 0
        self._parameter_list = inner_optimizer._parameter_list
        # the slow weights start at the parameters before the first window
        self._slow: dict[int, torch.Tensor] = {
            id(p): p._data.detach().clone() for p in self._parameter_list}

    def step(self):
        self.inner_optimizer.step()
        self._k_count += 1
        if self._k_count % self.k:
            return
        with torch.no_grad():
            for p in self._parameter_list:
                slow = self._slow[id(p)]
                slow = slow + self.alpha * (p._data - slow)
                self._slow[id(p)] = slow
                p._data.copy_(slow)

    def clear_grad(self, set_to_zero: bool = False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def set_state_dict(self, sd):
        return self.inner_optimizer.set_state_dict(sd)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage(Optimizer):
    """Running average of parameters (reference incubate/optimizer/
    modelaverage.py): ``step`` adds the parameters to a sum, ``apply()``
    swaps the averages in (a context manager that restores on exit unless
    ``need_restore`` is False), ``restore()`` swaps the parameters back,
    bit for bit."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self._sum: dict[int, torch.Tensor] = {}
        self._cnt = 0
        self._backup: dict[int, torch.Tensor] = {}

    def step(self):
        self._cnt += 1
        with torch.no_grad():
            for p in self._parameter_list:
                s = self._sum.get(id(p))
                self._sum[id(p)] = (p._data.detach().clone() if s is None
                                    else s + p._data)

    def apply(self, executor=None, need_restore: bool = True):
        with torch.no_grad():
            for p in self._parameter_list:
                if id(p) in self._sum and self._cnt:
                    self._backup[id(p)] = p._data.detach().clone()
                    p._data.copy_(self._sum[id(p)] / self._cnt)

        @contextlib.contextmanager
        def ctx():
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return ctx()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._parameter_list:
                if id(p) in self._backup:
                    p._data.copy_(self._backup.pop(id(p)))


class DistributedFusedLamb(Lamb):
    """reference: incubate/optimizer/distributed_fused_lamb.py: Lamb with
    the same knobs (the port's Lamb updates each parameter in fp32; the
    knobs of the distributed kernels are accepted and have no effect on
    one process)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 use_master_param_norm=True, gradient_accumulation_steps=1,
                 use_master_acc_grad=True, nproc_per_node=None,
                 use_hierarchical_allreduce=False, name=None):
        super().__init__(
            learning_rate=learning_rate, lamb_weight_decay=lamb_weight_decay,
            beta1=beta1, beta2=beta2, epsilon=epsilon, parameters=parameters,
            grad_clip=grad_clip,
            exclude_from_weight_decay_fn=exclude_from_weight_decay_fn)


class GradientMergeOptimizer:
    """k-step gradient accumulation wrapper (reference incubate/optimizer/
    gradient_merge.py): the gradients of k backwards add up, and every
    k-th ``step`` runs the inner step on them (divided by k with
    ``avg``) and clears them."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg
        self._count = 0

    def step(self):
        self._count += 1
        if self._count % self.k_steps:
            return
        if self.avg:
            for p in self.inner_optimizer._parameter_list:
                if p.grad is not None:
                    p.grad = Tensor(p.grad._data / self.k_steps)
        self.inner_optimizer.step()
        self.inner_optimizer.clear_grad()

    def clear_grad(self, set_to_zero: bool = False):
        # the gradients add up across the window
        if self._count % self.k_steps == 0:
            self.inner_optimizer.clear_grad(set_to_zero)

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)
