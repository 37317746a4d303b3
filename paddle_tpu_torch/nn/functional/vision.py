"""Vision functionals: grid_sample, affine_grid (port of
paddle_tpu/nn/functional/vision.py).

The reference writes both as gather / interpolation expressions outside
any Pallas kernel. ``grid_sample`` here is torch's (the same coordinate
unnormalisation, border clip, reflection over [-0.5, size - 0.5] then a
clip when corners are not aligned, round-half-even for "nearest", zeros
outside); ``affine_grid`` is the reference's expression.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import op

__all__ = ["grid_sample", "affine_grid"]


@op("grid_sample")
def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True):
    """x [N, C, H, W], grid [N, Ho, Wo, 2] in [-1, 1] -> [N, C, Ho, Wo]."""
    out = TF.grid_sample(x, grid.to(x.dtype), mode=mode,
                         padding_mode=padding_mode,
                         align_corners=align_corners)
    return out.to(x.dtype)


@op("affine_grid")
def affine_grid(theta, out_shape, align_corners: bool = True):
    """theta [N, 2, 3] -> sampling grid [N, H, W, 2] (reference
    affine_grid:34)."""
    if hasattr(out_shape, "tolist"):
        out_shape = [int(v) for v in out_shape.tolist()]
    N, C, H, W = [int(v) for v in out_shape]

    def linspace(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=theta.device)
        step = 2.0 / n
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                              device=theta.device)

    yy, xx = torch.meshgrid(linspace(H), linspace(W), indexing="ij")
    base = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)   # [H, W, 3]
    out = torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)
    return out.to(theta.dtype)
