"""Weight-only int8 quantization (port of paddle_tpu/ops/quant.py)."""

from __future__ import annotations

import torch

__all__ = ["absmax_quantize_int8", "SCALE_EPS"]

# scales are clamped here before any divide, so all-zero columns
# quantize to 0 and dequantize to exact 0 instead of NaN
SCALE_EPS = 1e-30


def absmax_quantize_int8(arr: torch.Tensor, axis: int = -2,
                         scale_dtype=torch.float32):
    """Per-channel absmax int8 along ``axis`` (the reduced dim is kept).

    The values are quantized against the fp32 scale, and only then is
    the scale stored in ``scale_dtype``, in the reference's order.
    Returns (int8 weights, scales)."""
    scale = arr.abs().amax(dim=axis, keepdim=True).float() / 127.0
    scale = torch.clamp_min(scale, SCALE_EPS)
    q = torch.clamp(torch.round(arr.float() / scale), -127, 127).to(
        torch.int8)
    return q, scale.to(scale_dtype)
