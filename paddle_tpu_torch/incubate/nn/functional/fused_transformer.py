"""Serving ops of incubate: the paged KV cache, block (paged) multi-head
attention and the fused decoder stack (port of
paddle_tpu/incubate/nn/functional/fused_transformer.py).

- ``PagedKVCache``: pages of ``block_size`` tokens, per-sequence block
  tables, the reference's two k layouts (``d_major``, the default, and
  ``token_major``) and its static round-robin table. The writes go into
  the pool in place (indexed assignment, ``index_put_``): the pool is
  never copied per step.
- ``block_multihead_attention``: prefill writes whole pages and runs
  ``flash_attention_raw`` (K1-sep, or the head-major K17 under
  ``flash_attention_native_layout=0``), the plain ``_sdpa_fallback``
  where the flash gate fails; decode writes one slot and calls
  ``paged_decode_attention``.
- ``paged_decode_attention``: the reference's route, gates term for term:
  K15 (``paged_decode_attention_mxu``) on d-major pages, K14
  (``paged_decode_attention_kernel``) on token-major pages, and the
  gather expression (plain PyTorch, the reference's XLA arm, the only
  place the kv heads are repeated for GQA) where the gates fail.
- ``fused_multi_transformer``: L pre-LN decoder layers over the
  reference's [2, B, nh, max_seq, dh] caches, plain PyTorch (no kernel),
  returning new caches as the reference does.

``ROUTES`` counts, on any device, which arm each call took: "flash" or
"sdpa" for a prefill, "mxu" (K15), "kernel" (K14) or "gather" for a
decode step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ....core.device import resolve_device
from ....ops.kernels import decode_attention as da
from ....ops.kernels.flash_attention import (flash_attention_raw,
                                             flash_supported)

__all__ = ["fused_multi_transformer", "block_multihead_attention",
           "PagedKVCache", "paged_decode_attention", "ROUTES"]

ROUTES = {"flash": 0, "sdpa": 0, "mxu": 0, "kernel": 0, "gather": 0}


def _ln(x, g, b, eps=1e-5):
    x32 = x.float()
    y = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
        x32.var(-1, unbiased=False, keepdim=True) + eps)
    if g is not None:
        y = y * g
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            out_weights, out_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, cache_kvs=None,
                            time_step: Optional[int] = None,
                            num_heads: Optional[int] = None,
                            pre_layer_norm: bool = True,
                            epsilon: float = 1e-5, causal: bool = True):
    """Run L pre-LN decoder layers, writing k and v into copies of the
    caches. ``cache_kvs``: per layer [2, B, n_heads, max_seq, head_dim];
    ``time_step`` the decode position (None: prefill from 0). Returns
    (out, new_cache_kvs or None)."""
    L = len(qkv_weights)
    B, S, H = x.shape
    nh = num_heads or (cache_kvs[0].shape[2] if cache_kvs is not None else 8)
    dh = H // nh
    pos = 0 if time_step is None else int(time_step)
    new_caches = []
    for i in range(L):
        h = _ln(x, ln_scales[i], ln_biases[i], epsilon) \
            if pre_layer_norm else x
        qkv = torch.matmul(h, qkv_weights[i])
        if qkv_biases is not None and qkv_biases[i] is not None:
            qkv = qkv + qkv_biases[i]
        q, k, v = (t.reshape(B, S, nh, dh) for t in qkv.chunk(3, dim=-1))
        if cache_kvs is not None:
            cache = cache_kvs[i]              # [2, B, nh, max_seq, dh]
            kc, vc = cache[0].clone(), cache[1].clone()
            kc[:, :, pos:pos + S] = k.transpose(1, 2).to(cache.dtype)
            vc[:, :, pos:pos + S] = v.transpose(1, 2).to(cache.dtype)
            new_caches.append(torch.stack([kc, vc]))
            kh, vh = kc.to(x.dtype), vc.to(x.dtype)
            kv_len = pos + S
        else:
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            kv_len = S
        qh = q.transpose(1, 2)
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float(),
                         kh.float()) / math.sqrt(dh)
        kpos = torch.arange(kh.shape[2], device=x.device)
        valid = kpos < kv_len
        if causal and S > 1:
            qpos = pos + torch.arange(S, device=x.device)
            mask = valid[None, :] & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask, s, -1e30)
        else:
            s = torch.where(valid, s, -1e30)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
        o = torch.matmul(o.transpose(1, 2).reshape(B, S, H), out_weights[i])
        if out_biases is not None and out_biases[i] is not None:
            o = o + out_biases[i]
        x = x + o
        h = _ln(x, ffn_ln_scales[i], ffn_ln_biases[i], epsilon) \
            if pre_layer_norm else x
        h = torch.matmul(h, ffn1_weights[i])
        if ffn1_biases is not None and ffn1_biases[i] is not None:
            h = h + ffn1_biases[i]
        h = F.gelu(h, approximate="tanh")
        h = torch.matmul(h, ffn2_weights[i])
        if ffn2_biases is not None and ffn2_biases[i] is not None:
            h = h + ffn2_biases[i]
        x = x + h
    return x, (new_caches if cache_kvs is not None else None)


class PagedKVCache:
    """vLLM-style paged KV cache (the reference's block_multi_head_attention
    layout). v_pages [n_pages, n_heads, block_size, head_dim]; k_pages the
    same with ``k_layout='token_major'``, or [n_pages, n_heads, head_dim,
    block_size] with ``k_layout='d_major'`` (default, K15's operand);
    block_table [B, max_blocks] int32, the static round-robin allocation
    (sequence b owns pages b*max_blocks ...); seq_lens [B] int32. Lives on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, n_pages: int, n_heads: int, block_size: int,
                 head_dim: int, batch: int, max_seq: int,
                 dtype=torch.bfloat16, k_layout: str = "d_major",
                 device=None):
        if k_layout not in ("d_major", "token_major"):
            raise ValueError(f"k_layout {k_layout!r}")
        dev = resolve_device(device)
        self.block_size = block_size
        self.k_layout = k_layout
        self.max_blocks = (max_seq + block_size - 1) // block_size
        self.v_pages = torch.zeros((n_pages, n_heads, block_size, head_dim),
                                   dtype=dtype, device=dev)
        self.k_pages = (torch.zeros((n_pages, n_heads, head_dim, block_size),
                                    dtype=dtype, device=dev)
                        if k_layout == "d_major"
                        else torch.zeros_like(self.v_pages))
        assert n_pages >= batch * self.max_blocks, "cache too small"
        self.block_table = (
            torch.arange(batch, dtype=torch.int32, device=dev)[:, None]
            * self.max_blocks
            + torch.arange(self.max_blocks, dtype=torch.int32,
                           device=dev)[None, :])
        self.seq_lens = torch.zeros((batch,), dtype=torch.int32, device=dev)

    def write_prefill(self, k, v):
        """k/v [B, S, nh, dh] for the prompt; fills pages from 0."""
        B, S, nh, dh = k.shape
        bs = self.block_size
        pad = (-S) % bs
        kp = F.pad(k, (0, 0, 0, 0, 0, pad))
        vp = F.pad(v, (0, 0, 0, 0, 0, pad))
        nblk = kp.shape[1] // bs
        # [B, nblk, bs, nh, dh] -> [B*nblk, nh, bs, dh]
        kb = kp.reshape(B, nblk, bs, nh, dh).transpose(2, 3) \
            .reshape(B * nblk, nh, bs, dh)
        vb = vp.reshape(B, nblk, bs, nh, dh).transpose(2, 3) \
            .reshape(B * nblk, nh, bs, dh)
        if self.k_layout == "d_major":
            kb = kb.transpose(2, 3)                 # [B*nblk, nh, dh, bs]
        pages = self.block_table[:, :nblk].reshape(-1).long()
        self.k_pages[pages] = kb.to(self.k_pages.dtype)
        self.v_pages[pages] = vb.to(self.v_pages.dtype)
        self.seq_lens.fill_(S)

    def write_decode(self, k, v):
        """k/v [B, 1, nh, dh] for one decode step at seq_lens. The page
        and the slot are non-adjacent advanced indices, so the indexed
        block is [B, nh, dh] in both layouts (numpy's rule, which torch
        follows as JAX does)."""
        B = k.shape[0]
        lens = self.seq_lens.long()
        blk = lens // self.block_size
        off = lens % self.block_size
        pages = self.block_table.long()[torch.arange(B, device=lens.device),
                                        blk]
        kt = k[:, 0].to(self.k_pages.dtype)          # [B, nh, dh]
        if self.k_layout == "d_major":
            # the token's slot is the last (bs) axis of the d-major page
            self.k_pages[pages, :, :, off] = kt
        else:
            self.k_pages[pages, :, off] = kt
        self.v_pages[pages, :, off] = v[:, 0].to(self.v_pages.dtype)
        self.seq_lens += 1


def _sdpa_fallback(q, k, v, causal: bool, sm_scale: float):
    """Plain attention on [B, S, h, d]: fp32 logits, the causal mask
    aligned to the last key, p cast to q's dtype (the reference's
    ``_sdpa_fallback``)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) \
        * sm_scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), vh.float()).to(q.dtype)
    return o.transpose(1, 2)


def block_multihead_attention(qkv, cache: PagedKVCache,
                              seq_lens_encoder=None, seq_lens_decoder=None,
                              max_seq_len: Optional[int] = None,
                              num_heads: Optional[int] = None,
                              head_dim: Optional[int] = None):
    """Paged attention (the reference's block_multi_head_attention):
    ``qkv`` [B, S, 3, nh, dh]. Prefill (S > 1) writes whole pages and runs
    flash; decode writes one slot and attends over the pages. Returns
    [B, S, nh, dh]."""
    S = qkv.shape[1]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if S > 1:
        cache.write_prefill(k, v)
        if flash_supported(q.shape, q.dtype):
            ROUTES["flash"] += 1
            return flash_attention_raw(q, k, v, causal=True)
        ROUTES["sdpa"] += 1
        return _sdpa_fallback(q, k, v, True, 1.0 / math.sqrt(q.shape[-1]))
    cache.write_decode(k, v)
    return paged_decode_attention(q, cache.k_pages, cache.v_pages,
                                  cache.block_table, cache.seq_lens,
                                  k_layout=cache.k_layout)


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens,
                           k_layout: str = "token_major"):
    """Single-token decode against the paged cache, q [B, 1, nq, dh]:
    K15 on d-major pages where ``paged_decode_mxu_supported`` holds, K14
    on token-major pages where ``paged_decode_supported`` holds (q cast to
    the page dtype for both), else the gather expression. Returns
    [B, 1, nq, dh] in q's dtype."""
    B = q.shape[0]
    if k_layout == "d_major":
        nh, dh, bs = k_pages.shape[1:]
    else:
        nh, bs, dh = k_pages.shape[1:]
    max_blocks = block_table.shape[1]
    itemsize = k_pages.element_size()
    scale = 1.0 / math.sqrt(dh)
    if k_layout == "d_major" and da.paged_decode_mxu_supported(
            k_pages.shape, q.shape[2], max_blocks=max_blocks,
            itemsize=itemsize):
        ROUTES["mxu"] += 1
        o = da.paged_decode_attention_mxu(
            q[:, 0].to(k_pages.dtype).contiguous(), k_pages, v_pages,
            block_table, seq_lens, scale)
        return o[:, None].to(q.dtype)
    if k_layout == "token_major" and da.paged_decode_supported(
            k_pages.shape, q.shape[2], max_blocks=max_blocks,
            itemsize=itemsize):
        ROUTES["kernel"] += 1
        o = da.paged_decode_attention_kernel(
            q[:, 0].to(k_pages.dtype).contiguous(), k_pages, v_pages,
            block_table, seq_lens, scale)
        return o[:, None].to(q.dtype)

    ROUTES["gather"] += 1
    table = block_table.long()
    kg = k_pages[table]                  # [B, max_blocks, nh, bs, dh]
    if k_layout == "d_major":
        kg = kg.transpose(3, 4)          # back to token-major for the dot
    vg = v_pages[table]
    kg = kg.transpose(1, 2).reshape(B, nh, max_blocks * bs, dh)
    vg = vg.transpose(1, 2).reshape(B, nh, max_blocks * bs, dh)
    if q.shape[2] != nh:                 # GQA: repeat the kv heads here only
        kg = kg.repeat_interleave(q.shape[2] // nh, dim=1)
        vg = vg.repeat_interleave(q.shape[2] // nh, dim=1)
    qh = q.transpose(1, 2).to(kg.dtype)  # [B, nq, 1, dh]
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kg.float()) \
        / math.sqrt(dh)
    pos = torch.arange(max_blocks * bs, device=q.device)
    mask = pos[None, :] < seq_lens.to(q.device)[:, None]      # [B, K]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(vg.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), vg.float()).to(vg.dtype)
    return o.transpose(1, 2).to(q.dtype)
