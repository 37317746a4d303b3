"""Gradient clipping (port of paddle_tpu/nn/clip.py): by value, by each
gradient's norm, and by the global norm (reference nn/clip.py:679). The
norms are taken in fp32."""

from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _skip(p, g) -> bool:
    return g is None or getattr(p, "need_clip", True) is False


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else
                (p, Tensor(torch.clamp(g._data, self.min, self.max)))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g._data.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, Tensor((g._data * scale).to(g.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all grads by clip_norm / max(global_norm, clip_norm).
    ``_norm_extra`` is the override point of a distributed norm."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _global_norm_sq(self, params_grads):
        sq = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            s = torch.sum(torch.square(g._data.float()))
            sq = s if sq is None else sq + s
        return sq

    def _norm_extra(self, global_norm_sq):
        return global_norm_sq

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        sq = self._norm_extra(sq)
        global_norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, g) if _skip(p, g) else
                (p, Tensor((g._data * scale).to(g.dtype)))
                for p, g in params_grads]
