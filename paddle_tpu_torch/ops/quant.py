"""int8 quantization of weights and KV pages (port of
paddle_tpu/ops/quant.py).

- Weights: per-output-column absmax int8 (``absmax_quantize_int8``).
- KV pages (``serving_kv_quant``): per-page, per-kv-head symmetric int8
  with an fp32 scale plane ``[n_pages, n_kv_heads]`` per layer. A page
  fills incrementally, so its scale is a running absmax: a write
  scatter-maxes the plane (``kv_scale_update``), the touched pages' int8
  content is rescaled onto the new scale (``rescale_int8``, bit-exact
  identity where the scale did not grow), and the new tokens quantize
  against it (``quantize_to_scale``). The attention kernels dequantize
  their tiles as ``dequantize_int8`` does.

Each function computes the reference's expression in its order: every
divide is a true fp32 divide, ``torch.round`` rounds half to even as
``jnp.round`` does, and scales are clamped to ``SCALE_EPS`` before any
divide, so all-zero inputs round-trip to exact zeros instead of NaN.
"""

from __future__ import annotations

import torch

__all__ = ["absmax_quantize_int8", "dequantize_int8", "kv_scale_update",
           "quantize_to_scale", "rescale_int8", "SCALE_EPS"]

SCALE_EPS = 1e-30


_INV_127 = 1.0 / 127.0


def absmax_quantize_int8(arr: torch.Tensor, axis: int = -2,
                         scale_dtype=torch.float32,
                         reciprocal: bool = False):
    """Per-channel absmax int8 along ``axis`` (the reduced dim is kept).

    The values are quantized against the fp32 scale, and only then is
    the scale stored in ``scale_dtype``, in the reference's order.
    ``reciprocal`` takes the scale as absmax times the fp32 reciprocal
    of 127, which is how XLA compiles the reference's ``absmax / 127``
    inside a jitted program (its simplifier turns a divide by a constant
    into a multiply); eagerly the reference divides. Returns (int8
    weights, scales)."""
    amax = arr.abs().amax(dim=axis, keepdim=True).float()
    scale = (amax * torch.tensor(_INV_127, dtype=torch.float32)
             if reciprocal else amax / 127.0)
    scale = torch.clamp_min(scale, SCALE_EPS)
    q = torch.clamp(torch.round(arr.float() / scale), -127, 127).to(
        torch.int8)
    return q, scale.to(scale_dtype)


def quantize_to_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x`` against an externally managed ``scale``
    (broadcastable): the KV write path's, where the scale is the page's
    running absmax and so at least |x| / 127."""
    s = torch.clamp_min(scale.float(), SCALE_EPS)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in fp32, cast to ``dtype``: the attention kernels'
    int8 tile load, element for element."""
    return (q.float() * scale.float()).to(dtype)


def rescale_int8(q: torch.Tensor, old_scale: torch.Tensor,
                 new_scale: torch.Tensor) -> torch.Tensor:
    """Re-express int8 content quantized at ``old_scale`` on
    ``new_scale``. An unchanged scale gives the ratio 1.0 exactly, and
    the stored integers come back unchanged."""
    ratio = old_scale.float() / torch.clamp_min(new_scale.float(), SCALE_EPS)
    return torch.clamp(torch.round(q.float() * ratio), -127, 127).to(
        torch.int8)


def kv_scale_update(scales: torch.Tensor, page_ids: torch.Tensor,
                    token_absmax: torch.Tensor) -> torch.Tensor:
    """Scatter-max ``token_absmax`` [N, nKV] into the plane ``scales``
    [P, nKV] at ``page_ids`` [N], in place, and return it. Duplicate page
    ids are fine: max does not depend on order. Where the reference
    returns a new plane, the engine's planes are updated in place."""
    return scales.index_reduce_(0, page_ids.long(),
                                token_absmax.to(scales.dtype), "amax")
