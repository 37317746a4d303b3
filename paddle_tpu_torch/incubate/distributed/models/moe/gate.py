"""MoE gates (the port's copy of
paddle_tpu/incubate/distributed/models/moe/gate.py; Paddle's
incubate/distributed/models/moe/gate/).

``tot_expert = world_size * num_expert``: a gate scores every expert of
the moe group. Under a moe group of more than one rank (``group``, set
by ``MoELayer``) the gate's parameters are replicated, so their gradient
is summed over the group: the gate's linear reads them through
``c_identity``, whose backward is that sum. GShard's auxiliary loss is
``E * sum_e mean(prob_e) * mean(is_top1_e)`` over the group's tokens:
both means are summed over the group before their product (a product
of the ranks' local means is another function). SwitchGate's training
noise draws from the port's generator (core/random.py).
"""

from __future__ import annotations

import torch

from ..... import nn
from .....core import random as prandom
from .....core.tensor import Tensor
from .....distributed.autograd_collectives import c_identity, mp_allreduce

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


def _pg(group):
    if group is None or group.nranks == 1:
        return None
    from .....distributed.collective import _pg as pg

    return pg(group)


class BaseGate(nn.Layer):
    def __init__(self, num_expert: int, world_size: int = 1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None
        self.group = None

    def get_loss(self, clear: bool = True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """Plain top-k softmax gate (reference naive_gate.py)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2):
        super().__init__(num_expert, world_size)
        self.gate = nn.Linear(d_model, self.tot_expert)
        self.top_k = topk

    def _logits(self, inp):
        pg = _pg(self.group)
        if pg is None:
            return self.gate(inp)
        w, b = (Tensor(c_identity(p._data, pg), stop_gradient=p.stop_gradient)
                for p in (self.gate.weight, self.gate.bias))
        return nn.functional.linear(inp, w, b)

    def forward(self, inp, return_all_scores: bool = False):
        gate_logits = self._logits(inp)
        gate_prob = nn.functional.softmax(gate_logits, axis=-1)
        topk_val, topk_idx = gate_prob.topk(self.top_k, axis=-1)
        if return_all_scores:
            return topk_val, topk_idx, gate_logits
        return topk_val, topk_idx


class GShardGate(NaiveGate):
    """Top-2 gate with the load-balance loss (reference gshard_gate.py;
    capacity bounds the dispatch in ``MoELayer``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4),
                 random_routing: bool = True, group=None):
        super().__init__(d_model, num_expert, world_size, topk=2)
        self.capacity = capacity
        self.group = group

    def forward(self, x):
        topk_val, topk_idx, logits = super().forward(x,
                                                     return_all_scores=True)
        prob = nn.functional.softmax(logits, axis=-1)._data
        top1 = torch.nn.functional.one_hot(topk_idx._data[:, 0],
                                           self.tot_expert).to(prob.dtype)
        pg = _pg(self.group)
        me, ce = prob.sum(0), top1.sum(0)
        n = torch.tensor([float(prob.shape[0])], dtype=prob.dtype,
                         device=prob.device)
        if pg is not None:
            me = mp_allreduce(me, pg)
            ce, n = (mp_allreduce(t.detach(), pg) for t in (ce, n))
        loss = (me / n * (ce / n)).sum() * self.tot_expert
        self.loss = Tensor(loss, stop_gradient=not loss.requires_grad)
        return topk_val, topk_idx


class SwitchGate(NaiveGate):
    """Top-1 switch gate (reference switch_gate.py): in training the
    logits are scaled by uniform noise in [1 - eps, 1 + eps]."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1, capacity=(1.2, 2.4),
                 group=None):
        super().__init__(d_model, num_expert, world_size, topk=1)
        self.switch_eps = switch_eps
        self.group = group

    def forward(self, x):
        if getattr(self, "training", True) and self.switch_eps > 0:
            d = x._data
            gen = prandom.default_generator().torch_generator(d.device)
            noise = torch.rand(tuple(d.shape[:-1]) + (self.tot_expert,),
                               generator=gen, device=d.device)
            noise = noise * (2 * self.switch_eps) + (1 - self.switch_eps)
            h = self._logits(x) * Tensor(noise)
            prob = nn.functional.softmax(h, axis=-1)
            return prob.topk(1, axis=-1)
        return super().forward(x)
