"""Nucleus (top-p) keep rule (port of paddle_tpu/ops/nucleus.py)."""

from __future__ import annotations

import torch

__all__ = ["nucleus_keep"]


def nucleus_keep(sorted_probs: torch.Tensor, top_p) -> torch.Tensor:
    """Keep mask over descending-sorted probabilities [..., V]: the
    minimal prefix whose mass reaches ``top_p``, crossing element
    included: for ``top_p`` > 0 the first token always (the mass before
    it is 0), for ``top_p`` <= 0 none, as in the reference. The mass
    before each
    element is an EXCLUSIVE cumsum (shift, then accumulate), never
    ``cumsum - p``, which can lose an ulp and move the boundary."""
    shifted = torch.cat([torch.zeros_like(sorted_probs[..., :1]),
                         sorted_probs[..., :-1]], dim=-1)
    top_p = torch.as_tensor(top_p, dtype=sorted_probs.dtype,
                            device=sorted_probs.device)
    return torch.cumsum(shifted, dim=-1) < top_p[..., None]
