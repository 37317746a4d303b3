"""Attention functionals (port of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` routes as the reference's: with
``use_pallas_attention`` on, no mask, no dropout and a shape the flash
gate takes (``flash_supported``, the reference's ``supported``), the
call is the op ``pallas_flash_attention``: in the port
``ops/kernels/flash_attention.py::flash_attention_raw`` (K1's
separate-input forward and K3's separate backward, or K17 under
``flash_attention_native_layout=0``). Every other case runs the
reference's ``_sdpa_ref`` expression in torch as the op
``scaled_dot_product_attention``.
"""

from __future__ import annotations

import math

import torch

from ...core import random as prandom
from ...core.dispatch import op
from ...core.flags import GLOBAL_FLAGS
from ...ops.kernels import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sdp_kernel"]


def _sdpa_ref(q, k, v, mask, dropout_p, is_causal, scale, training,
              generator=None):
    # q, k, v: [B, S, H, D] (the reference layout)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(ql, kl, dtype=torch.bool,
                            device=q.device).tril(kl - ql)
        logits = torch.where(causal, logits, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training and generator is not None:
        keep = 1.0 - dropout_p
        dmask = torch.rand(probs.shape, generator=generator,
                           device=probs.device) < keep
        probs = torch.where(dmask, probs / keep,
                            torch.zeros_like(probs)).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


@op("pallas_flash_attention", amp="cast")
def _flash_op(q, k, v, causal=False, sm_scale=None):
    return _fa.flash_attention_raw(q, k, v, causal=causal,
                                   sm_scale=sm_scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """q, k, v: [batch, seq, num_heads, head_dim] (reference layout)."""
    generator = None
    if dropout_p > 0.0 and training:
        generator = prandom.default_generator().torch_generator(
            query._data.device)
    use_flash = (GLOBAL_FLAGS.get("use_pallas_attention")
                 and attn_mask is None and dropout_p == 0.0)
    if use_flash and _fa.flash_supported(tuple(query.shape), query.dtype):
        return _flash_op(query, key, value, causal=is_causal)

    @op("scaled_dot_product_attention", amp="cast")
    def _impl(q, k, v, m):
        return _sdpa_ref(q, k, v, m, dropout_p, is_causal, None, training,
                         generator)

    return _impl(query, key, value, attn_mask)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name="",
                    training: bool = True, name=None):
    """reference: python/paddle/nn/functional/flash_attention.py:248."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over packed sequences [total_tokens, H, D], as
    a segment-masked SDPA (reference flash_attn_unpadded)."""

    @op("flash_attn_unpadded", amp="cast")
    def _impl(q, k, v, cu_q, cu_k):
        pos_q = torch.arange(q.shape[0], device=q.device)
        pos_k = torch.arange(k.shape[0], device=k.device)
        seg_q = torch.searchsorted(cu_q.contiguous(), pos_q.to(cu_q.dtype),
                                   right=True) - 1
        seg_k = torch.searchsorted(cu_k.contiguous(), pos_k.to(cu_k.dtype),
                                   right=True) - 1
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            off_q = pos_q - cu_q.long()[seg_q]
            off_k = pos_k - cu_k.long()[seg_k]
            mask = mask & (off_q[:, None] >= off_k[None, :])
        logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
        logits = torch.where(mask[None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("hqk,khd->qhd", probs, v)

    return _impl(query, key, value, cu_seqlens_q, cu_seqlens_k), None


class sdp_kernel:
    """Context manager selecting the attention route (torch-compat)."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self._enable_flash = enable_flash
        self._prev = None

    def __enter__(self):
        self._prev = GLOBAL_FLAGS.get("use_pallas_attention")
        GLOBAL_FLAGS.set("use_pallas_attention", bool(self._enable_flash))
        return self

    def __exit__(self, *exc):
        GLOBAL_FLAGS.set("use_pallas_attention", self._prev)
        return False
