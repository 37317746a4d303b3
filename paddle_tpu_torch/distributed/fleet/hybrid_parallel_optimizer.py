"""HybridParallelOptimizer: the optimizer wrapper that keeps the serial
step across parallel groups (the port's copy of
paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py; reference
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:266).

The reference's gradients are global arrays, so its global norm and its
found-inf are already the serial ones. Here each rank holds its own
blocks, and the wrapper does what Paddle's does:

- ``step()`` first averages the gradients over dp when dp > 1 and the
  model is not under ``DataParallel`` (whose hooks sync them):
  ``fused_allreduce_gradients``, one flat all-reduce a dtype;
- ``ClipGradByGlobalNorm`` becomes ``HybridParallelClipGrad``: the
  squared norms of the mp-split leaves (``is_distributed``) summed over
  mp, each replicated leaf counted once;
- AMP's found-inf (``GradScaler.unscale_``) is all-reduced MAX over the
  world, so that every rank skips or takes the same step.
"""

from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm
from ..collective import ReduceOp, _pg, all_reduce

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "fused_allreduce_gradients"]


def fused_allreduce_gradients(parameter_list, hcg) -> None:
    """Average the gradients of ``parameter_list`` over dp: one flat
    buffer a dtype, summed, divided by dp, written back."""
    group = hcg.get_data_parallel_group()
    if _pg(group) is None:
        return
    by_dtype = {}
    for p in parameter_list:
        g = p._data.grad
        if g is not None and not p.stop_gradient:
            by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce(flat, group=group)
        flat.div_(group.nranks)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip over a hybrid topology: the mp-split leaves'
    squared norms summed over mp, the replicated ones' counted once.
    ``last_norm`` keeps the global norm of the last call."""

    def __init__(self, clip, hcg):
        super().__init__(clip.clip_norm, clip.group_name,
                         clip.auto_skip_clip)
        self._hcg = hcg
        self.last_norm = None

    def _global_norm_sq(self, params_grads):
        dist_sq = not_dist_sq = None
        for p, g in params_grads:
            if g is None or getattr(p, "need_clip", True) is False:
                continue
            s = torch.sum(torch.square(g._data.float()))
            if getattr(p, "is_distributed", False):
                dist_sq = s if dist_sq is None else dist_sq + s
            else:
                not_dist_sq = s if not_dist_sq is None else not_dist_sq + s
        if dist_sq is None and not_dist_sq is None:
            return None
        ref = dist_sq if dist_sq is not None else not_dist_sq
        if dist_sq is None:
            dist_sq = torch.zeros_like(ref)
        if not_dist_sq is None:
            not_dist_sq = torch.zeros_like(ref)
        dist_sq = dist_sq.reshape(1).contiguous()
        all_reduce(dist_sq, group=self._hcg.get_model_parallel_group())
        sq = dist_sq[0] + not_dist_sq
        self.last_norm = torch.sqrt(sq)
        return sq


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        from ..topology import ParallelMode

        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._dp_enable = (hcg.get_parallel_mode()
                           != ParallelMode.DATA_PARALLEL
                           and hcg.get_data_parallel_world_size() > 1)
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)

    @property
    def inner_opt(self):
        return self._inner_opt

    def _found_inf_all_reduce(self, found: bool) -> bool:
        """``found`` on any rank of the world (GradScaler.unscale_)."""
        from ..parallel import _ensure_default_group

        group = _ensure_default_group()
        if _pg(group) is None:
            return found
        flag = torch.tensor([1.0 if found else 0.0],
                            device=self._device())
        all_reduce(flag, op=ReduceOp.MAX, group=group)
        return bool(flag.item())

    def _device(self):
        for p in self._inner_opt._parameter_list:
            return p._data.device
        return torch.device("cpu")

    def step(self):
        if self._dp_enable:
            fused_allreduce_gradients(self._inner_opt._parameter_list,
                                      self._hcg)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero=set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self):
        return self._inner_opt.get_lr()

    def set_lr(self, v):
        return self._inner_opt.set_lr(v)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def __getattr__(self, name):
        if name == "_inner_opt":
            raise AttributeError(name)
        return getattr(self._inner_opt, name)
