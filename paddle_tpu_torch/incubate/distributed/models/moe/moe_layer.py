"""MoELayer: expert-parallel mixture of experts over arbitrary expert
Layers (the port's copy of
paddle_tpu/incubate/distributed/models/moe/moe_layer.py; Paddle's
incubate/distributed/models/moe/moe_layer.py:263).

The routing is the reference's (``_routing_impl``): capacity ``C =
max(1, int(capacity_factor * N * K / E))`` for N tokens, K slots and E
experts; each top-k slot has its own capacity buffer and cumsum
positions; a token's output is the sum of its kept slots' expert outputs
weighted by their gate values, divided by the sum of those values
(clipped at 1e-9), so a token dropped from every slot outputs 0.

The reference holds every expert in one process and dispatches with a
one-hot capacity einsum. Here each rank of the moe group (W ranks)
holds ``experts``, E / W of them, and the gate scores all E. N is the
group's token count, and a token's position in an expert's queue is its
position in the group's rank-major order: this rank's cumsum plus the
tokens of lower ranks, from the per-expert counts all-gathered over the
group. So the kept set is the reference's Layer holding all E experts on
the concatenated batch. Kept rows reach their experts through
``global_scatter`` and come back through ``global_gather``; the
experts run on the rows they receive, not on padded buffers.

Each rank owns its experts: their parameters carry the moe group
(``moe_group``). A dp sync (``DataParallel``, ``fused_allreduce_
gradients``, the wrappers' broadcasts: ``distributed/parallel.py::
held_apart``) skips them where the moe group spans the dp group, and
syncs them as any parameter where it meets the dp group in one rank (a
moe group over mp: the dp replicas hold the same experts). The clip sums
their squared norms over the moe group. The gate is replicated and its
gradient summed over the group (gate.py), then averaged over dp as any
parameter's. Under a sum loss the gradients are the reference's; under
a mean over each rank's tokens they are W times the reference's mean
over the concatenated batch (ROADMAP Queue 3, defect K).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..... import nn
from .....core.tensor import Tensor
from .....distributed.utils.moe_utils import global_gather, global_scatter
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401

__all__ = ["MoELayer"]


class MoELayer(nn.Layer):
    def __init__(self, d_model: int, experts: Sequence[nn.Layer],
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0, capacity_factor: float = 1.25,
                 **kwargs):
        super().__init__()
        self.d_model = d_model
        self.experts = nn.LayerList(list(experts))
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        self.group = moe_group if moe_group is not None and \
            moe_group.nranks > 1 else None
        self.world_size = self.group.nranks if self.group else 1
        if gate is None or isinstance(gate, dict):
            gate_cfg = gate if isinstance(gate, dict) else {}
            typ = gate_cfg.get("type", "gshard")
            topk = gate_cfg.get("top_k", 2)
            cls = {"naive": NaiveGate, "gshard": GShardGate,
                   "switch": SwitchGate}[typ]
            gate = cls(d_model, self.num_expert, world_size=self.world_size,
                       topk=topk)
        if gate.tot_expert != self.world_size * self.num_expert:
            raise ValueError(f"the gate scores {gate.tot_expert} experts, the "
                             f"group holds {self.world_size} x "
                             f"{self.num_expert}")
        gate.group = self.group
        self.gate = gate
        if self.group is not None:
            for p in self.experts.parameters():
                p.moe_group = self.group
        self.last_routing = None

    def _positions(self, idx: torch.Tensor):
        """(capacity, queue positions [N, K]) in the group's token order."""
        N, K = idx.shape
        E = self.world_size * self.num_expert
        onehot = torch.nn.functional.one_hot(idx, E)          # [N, K, E]
        counts = onehot.sum(0)                                 # [K, E]
        meta = torch.cat([counts.reshape(-1),
                          torch.tensor([N], device=idx.device)])
        before = torch.zeros_like(counts)
        total = N
        if self.group is not None:
            from .....distributed.collective import all_gather

            rows = all_gather(meta.contiguous(), group=self.group).wait()
            rows = rows.reshape(self.world_size, -1)
            me = self.group.rank
            before = rows[:me, :-1].sum(0).reshape(K, E)
            total = int(rows[:, -1].sum())
        cap = max(1, int(self.capacity_factor * total * K / E))
        local = (onehot.cumsum(0) - 1) * onehot                # [N, K, E]
        pos = (local + before[None] * onehot).sum(-1)          # [N, K]
        return cap, pos

    def _route(self, x: torch.Tensor, vals: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
        N, K = idx.shape
        E = self.world_size * self.num_expert
        cap, pos = self._positions(idx)
        keep = pos < cap                                       # [N, K]
        # kept (slot, token) rows, slot-major, sorted by expert (stable)
        k_t = keep.t().reshape(-1)
        e_t = idx.t().reshape(-1)[k_t]
        rows = torch.arange(N * K, device=x.device)[k_t]
        order = torch.argsort(e_t, stable=True)
        rows, e_sorted = rows[order], e_t[order]
        tok = rows % N
        lc = torch.bincount(e_sorted, minlength=E)
        xin = x[tok]
        gc = lc
        if self.group is not None:
            from .....distributed.collective import alltoall_single

            gc = alltoall_single(lc.contiguous(), group=self.group).wait()
            xin = global_scatter(xin, lc, gc, group=self.group)
        per = gc.reshape(self.world_size, self.num_expert).sum(0).tolist()
        outs = []
        for expert, part in zip(self.experts, torch.split(xin, per)):
            y = expert(Tensor(part, stop_gradient=not part.requires_grad))
            outs.append(y._data)
        y = torch.cat(outs) if outs else xin
        if self.group is not None:
            y = global_gather(y, lc, gc, group=self.group)
        y = y.to(x.dtype)
        w = vals.t().reshape(-1)[rows].to(x.dtype)
        out = torch.zeros_like(x).index_add(0, tok, y * w[:, None])
        denom = (vals * keep).sum(-1).clamp_min(1e-9).to(x.dtype)
        self.last_routing = {"capacity": cap, "keep": keep.detach(),
                             "idx": idx.detach(), "rows": int(rows.numel())}
        return out / denom[:, None]

    def forward(self, inp: Tensor) -> Tensor:
        orig_shape = inp.shape
        x = inp.reshape([-1, self.d_model])
        topk_val, topk_idx = self.gate(x)
        out = self._route(x._data, topk_val._data.float(),
                          topk_idx._data.long())
        out = Tensor(out, stop_gradient=not out.requires_grad)
        return out.reshape(orig_shape)
