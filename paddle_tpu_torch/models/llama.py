"""LLaMA: the building blocks the serving engine shares, the prefill
forward and the compiled prefill + decode engine ``LlamaForCausalLM``
(port of paddle_tpu/models/llama.py).

The parameter tree has the reference's names and shapes: ``blocks.*``
leaves are stacked on a leading layer axis, so weights carry across
packages one leaf at a time. Every cast point of the reference is kept:
RMSNorm and RoPE compute in fp32 and cast back, matmuls accumulate in
fp32 and return ``cfg.dtype``.

The training/prefill block (``block_apply``) is the plain composition;
the fusion compiler (``compiler.fused_call``) places K6 (rms form), K11
(RoPE in the flash tile) and K12 (swiglu) in it, as the reference's
compiler does. Where the reference scans over layers, the port runs an
eager loop. ``llama_loss`` differentiates through the flash backward K3
(separate mode, behind K11's rotary pullback or K1's separate-input
forward); GQA's gradients flow through autograd of the kv repeat. The
decode step does not go through the compiler: its attention is K10 over
the dense kv-head-major cache.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler import fused_call, remat_call
from ..core.device import resolve_device
from ..core.flags import GLOBAL_FLAGS
from ..core.jax_random import categorical, prng_key, split
from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_plain,
                                            decode_attention_supported)
from ..ops.kernels.flash_attention import flash_attention_raw, flash_supported
from ..ops.kernels.quant_matmul import quant_matmul
from ..ops.nucleus import nucleus_keep
from ..ops.quant import absmax_quantize_int8

__all__ = ["LlamaConfig", "llama_presets", "init_llama_params", "rms_norm",
           "rope_angles", "apply_rope", "quantize_weights_int8",
           "block_apply", "llama_apply", "llama_loss", "LlamaForCausalLM"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32          # < n_heads => GQA/MQA
    ffn_hidden: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    weight_only_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


def llama_presets(name: str) -> LlamaConfig:
    table = {
        "llama2-7b": dict(hidden=4096, n_layers=32, n_heads=32,
                          n_kv_heads=32, ffn_hidden=11008),
        "llama2-13b": dict(hidden=5120, n_layers=40, n_heads=40,
                           n_kv_heads=40, ffn_hidden=13824),
        "llama3-8b": dict(hidden=4096, n_layers=32, n_heads=32,
                          n_kv_heads=8, ffn_hidden=14336,
                          vocab_size=128256, rope_theta=500000.0),
        "tinyllama": dict(hidden=256, n_layers=4, n_heads=8, n_kv_heads=4,
                          ffn_hidden=688, vocab_size=1024, max_seq_len=512),
    }
    return LlamaConfig(**table[name])


def init_llama_params(cfg: LlamaConfig, generator: torch.Generator,
                      device) -> dict:
    """Random parameters drawn on ``device`` from ``generator`` (std 0.02,
    output projections scaled by 1/sqrt(2L)), norm gains at 1. The
    numbers differ from the reference's (another generator); the tree,
    names, shapes and dtypes are the same."""
    H, L = cfg.hidden, cfg.n_layers
    dH, nKV, F = cfg.head_dim, cfg.n_kv_heads, cfg.ffn_hidden
    pd = cfg.param_dtype
    std = 0.02

    def nrm(shape, s=std):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, s, generator=generator)
        return w.to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    return {
        "wte": nrm((cfg.vocab_size, H)),
        "blocks": {
            "attn_norm": ones((L, H)),
            "wq": nrm((L, H, cfg.n_heads * dH)),
            "wk": nrm((L, H, nKV * dH)),
            "wv": nrm((L, H, nKV * dH)),
            "wo": nrm((L, cfg.n_heads * dH, H), std / math.sqrt(2 * L)),
            "ffn_norm": ones((L, H)),
            "w_gate": nrm((L, H, F)),
            "w_up": nrm((L, H, F)),
            "w_down": nrm((L, F, H), std / math.sqrt(2 * L)),
        },
        "final_norm": ones((H,)),
        "head": nrm((H, cfg.vocab_size)),
    }


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def rope_angles(cfg: LlamaConfig, positions: torch.Tensor):
    """positions int [...] -> (cos, sin) fp32 [..., dH/2]."""
    dH = cfg.head_dim
    exps = torch.arange(0, dH, 2, dtype=torch.float32,
                        device=positions.device) / dH
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in fp32. x [..., nH, dH]; cos/sin broadcastable
    [..., 1, dH/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mm(x: torch.Tensor, w, cfg: LlamaConfig) -> torch.Tensor:
    """x [..., K] @ w -> cfg.dtype. ``w`` is a [K, N] tensor or an
    (int8 [K, N], scale [1, N]) pair; the pair goes through the weight-
    only int8 kernel, which folds the per-column scale into its fp32
    epilogue."""
    if isinstance(w, tuple):
        wq, scale = w
        return quant_matmul(x, wq, scale).to(cfg.dtype)
    return torch.matmul(x.to(cfg.dtype), w.to(cfg.dtype)).to(cfg.dtype)


def quantize_weights_int8(params: dict) -> dict:
    """Weight-only int8: per-column absmax int8 with bf16 scales for the
    matmul weights; embeddings and norm gains stay as they are."""

    def q(name, a):
        if a.dim() < 2 or "norm" in name or name == "wte":
            return a
        return absmax_quantize_int8(a, axis=-2, scale_dtype=torch.bfloat16)

    return {"wte": params["wte"], "final_norm": params["final_norm"],
            "head": q("head", params["head"]),
            "blocks": {k: q(k, v) for k, v in params["blocks"].items()}}



def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, nKV, dH] -> [B, T, nKV * n_rep, dH], each kv head repeated
    for its query heads."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _decode_weight_quant_flag() -> bool:
    """Init-time read of ``decode_weight_quant`` (default off): puts the
    engine on weight-only int8 without a config change, as
    ``cfg.weight_only_int8`` does."""
    return bool(GLOBAL_FLAGS.get("decode_weight_quant"))


def _layer(blocks: dict, i: int) -> dict:
    """Layer i's slice of the stacked block leaves ((int8, scale) pairs
    sliced leaf by leaf)."""
    return {k: (tuple(t[i] for t in v) if isinstance(v, tuple) else v[i])
            for k, v in blocks.items()}


def block_apply(bp: dict, x, cfg: LlamaConfig, cos, sin,
                return_kv: bool = False):
    """Prefill block, full-sequence causal attention, written as the plain
    composition: the compiler rediscovers the rms-epilogue, rope + flash
    and swiglu chains in its trace. ``return_kv`` also returns the
    rotated k and v before the repeat (the prefill fills the decode cache
    with them); the escaping rotated k is what makes the compiler take
    the q-only rope fusion there."""
    B, T, H = x.shape
    nH, nKV, dH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, bp["attn_norm"], cfg.rms_eps)
    q = _mm(h, bp["wq"], cfg).reshape(B, T, nH, dH)
    k = _mm(h, bp["wk"], cfg).reshape(B, T, nKV, dH)
    v = _mm(h, bp["wv"], cfg).reshape(B, T, nKV, dH)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kf = _repeat_kv(k, nH // nKV)
    vf = _repeat_kv(v, nH // nKV)
    if flash_supported(q.shape, q.dtype):
        o = flash_attention_raw(q, kf, vf, causal=True)
    else:
        o = _sdpa(q, kf, vf)
    x = x + _mm(o.reshape(B, T, nH * dH), bp["wo"], cfg)
    h = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
    gate = _mm(h, bp["w_gate"], cfg)
    up = _mm(h, bp["w_up"], cfg)
    x = x + _mm(F.silu(gate.float()).to(cfg.dtype) * up, bp["w_down"], cfg)
    if return_kv:
        return x, k, v
    return x


def _sdpa(q, k, v):
    """Plain causal attention [B, T, nH, dH] where the flash gate fails:
    fp32 logits, fill -1e30, probabilities cast to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    T = q.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _embed_and_angles(params, tokens, cfg: LlamaConfig):
    T = tokens.shape[1]
    x = params["wte"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_angles(cfg, torch.arange(T, device=x.device))
    return x, cos[None, :, None, :], sin[None, :, None, :]


def _remat_block(bp, x, cos, sin, cfg: LlamaConfig):
    return block_apply(bp, x, cfg, cos, sin)


def _llama_apply_unfused(params, tokens, cfg: LlamaConfig,
                         remat: bool = True):
    """The plain forward to fp32 logits [B, T, V]. With ``remat`` every
    block runs through ``compiler.remat_call`` with no policy (the
    reference's ``jax.checkpoint``): recomputed whole in the backward, and
    planned by the compiler as a nested program."""
    x, cos, sin = _embed_and_angles(params, tokens, cfg)
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x = remat_call(("llama_block", cfg),
                           functools.partial(_remat_block, cfg=cfg), bp, x,
                           cos, sin)
        else:
            x = block_apply(bp, x, cfg, cos, sin)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _mm(x, params["head"], cfg).float()


def llama_apply(params, tokens, cfg: LlamaConfig, remat: bool = True):
    """Forward to logits, routed through the fusion compiler (with
    ``use_auto_fusion=0`` the plain composition runs); ``remat`` decides
    what a backward recomputes."""
    return fused_call(("llama_apply", cfg, bool(remat)),
                      functools.partial(_llama_apply_unfused, cfg=cfg,
                                        remat=remat),
                      params, tokens)


def llama_loss(params, tokens, labels, cfg: LlamaConfig):
    """Mean next-token cross-entropy of the fp32 logits."""
    logits = llama_apply(params, tokens, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


# ---------------------------------------------------------------------------
# inference engine
# ---------------------------------------------------------------------------

def _prefill_unfused(params, tokens, cache, cfg: LlamaConfig):
    """Prefill trace body (the compiler fuses it, see
    ``LlamaForCausalLM._prefill_impl``): the forward over the prompt that
    also fills the decode cache. The cache slots 0..T-1 of each layer are
    written in place, where the reference's scan returns updated
    buffers."""
    T = tokens.shape[1]
    x, cos, sin = _embed_and_angles(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, k, v = block_apply(_layer(params["blocks"], i), x, cfg, cos, sin,
                              return_kv=True)
        cache["k"][i, :, :, :T] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][i, :, :, :T] = v.transpose(1, 2).to(cache["v"].dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _mm(x[:, -1:], params["head"], cfg).float()
    return logits[:, 0], cache


def _decode_block(bp, x, cache_k, cache_v, pos: int, cfg: LlamaConfig, cos,
                  sin):
    """One decode step of one block: x [B, 1, H]; cache [B, nKV, S, dH]
    (kv-head-major, K10's layout), slot ``pos`` written in place (the
    reference's dynamic_update_slice on donated buffers)."""
    B = x.shape[0]
    nH, nKV, dH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, bp["attn_norm"], cfg.rms_eps)
    q = _mm(h, bp["wq"], cfg).reshape(B, 1, nH, dH)
    k = _mm(h, bp["wk"], cfg).reshape(B, 1, nKV, dH)
    v = _mm(h, bp["wv"], cfg).reshape(B, 1, nKV, dH)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, :, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v[:, 0].to(cache_v.dtype)
    scale = 1.0 / math.sqrt(dH)
    if decode_attention_supported(cache_k.shape, dH, num_heads=nH):
        # K10: no repeated cache, reads bounded by pos
        o = decode_attention(q[:, 0], cache_k, cache_v, pos, scale)
    else:
        o = decode_attention_plain(q[:, 0], cache_k, cache_v, pos, scale)
    x = x + _mm(o.reshape(B, 1, nH * dH), bp["wo"], cfg)
    h = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
    x = x + _mm(F.silu(_mm(h, bp["w_gate"], cfg).float()).to(cfg.dtype)
                * _mm(h, bp["w_up"], cfg), bp["w_down"], cfg)
    return x, cache_k, cache_v


class LlamaForCausalLM:
    """Prefill + decode inference engine.

    ``generate`` runs one prefill over the prompt (through the fusion
    compiler) and then a per-token decode loop against a static
    kv-head-major cache: the reference's two-program serving pattern,
    eager here (its jitted ``lax.scan`` over decode steps is a Python
    loop). Runs on CUDA unless ``device`` says otherwise; weights are
    drawn from ``seed`` on that device when ``params`` is None."""

    def __init__(self, cfg: LlamaConfig, params: Optional[dict] = None,
                 seed: int = 0, max_batch: int = 1,
                 max_seq_len: Optional[int] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_llama_params(cfg, gen, self.device)
        if (cfg.weight_only_int8 or _decode_weight_quant_flag()) \
                and not isinstance(params["blocks"]["wq"], tuple):
            params = quantize_weights_int8(params)
        self.params = params
        # per-layer views of the weights, made once for the decode loop
        self._layers = [_layer(params["blocks"], i)
                        for i in range(cfg.n_layers)]
        self.max_batch = max_batch
        self.max_seq = max_seq_len or cfg.max_seq_len
        # the decode step's rotation angles, one row per cache slot (the
        # values rope_angles gives for that position alone)
        self._cos, self._sin = rope_angles(
            cfg, torch.arange(self.max_seq, device=self.device))

    def _empty_cache(self, B: int) -> dict:
        # kv-head-major [L, B, nKV, S, dH]: K10's native layout
        shape = (self.cfg.n_layers, B, self.cfg.n_kv_heads, self.max_seq,
                 self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.cfg.dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.cfg.dtype,
                                 device=self.device)}

    def _prefill_impl(self, tokens, cache):
        """The prefill through the fusion compiler: the rotated k escaping
        into the cache makes the rope template take its q-only arm."""
        return fused_call(("llama_prefill", self.cfg),
                          functools.partial(_prefill_unfused, cfg=self.cfg),
                          self.params, tokens, cache)

    def _decode_impl(self, cache, token, pos: int):
        cfg, params = self.cfg, self.params
        B = token.shape[0]
        x = params["wte"][token.long()].to(cfg.dtype).reshape(B, 1, cfg.hidden)
        cos = self._cos[pos][None, None, None, :]
        sin = self._sin[pos][None, None, None, :]
        for i, bp in enumerate(self._layers):
            x, _, _ = _decode_block(bp, x, cache["k"][i], cache["v"][i], pos,
                                    cfg, cos, sin)
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        logits = _mm(x, params["head"], cfg).float()
        return logits[:, 0], cache

    def _decode_n_impl(self, cache, first_token, start_pos: int, key,
                       temperature, top_p, *, n: int, greedy: bool):
        """n decode steps, a new key split off per step (the reference's
        scan body)."""
        tok, toks = first_token, []
        for step in range(n):
            logits, cache = self._decode_impl(cache, tok, start_pos + step)
            key, sub = split(key)
            tok = self._sample(logits, sub, temperature, top_p, greedy)
            toks.append(tok)
        return torch.stack(toks), cache

    @staticmethod
    def _sample(logits, key, temperature, top_p, greedy: bool):
        """Greedy argmax, or nucleus sampling at ``temperature``: the
        logits under the smallest kept sorted logit go to -1e30, then a
        categorical draw keyed on ``key`` (bit for bit JAX's)."""
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        temp = torch.tensor(temperature, dtype=torch.float32,
                            device=logits.device)
        logits = logits / torch.clamp_min(temp, 1e-6)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = nucleus_keep(probs, top_p)
        cutoff = torch.where(keep, sorted_logits, math.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -1e30, logits)
        return categorical(key.to(logits.device), logits).to(torch.int32)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Prefill + greedy/nucleus decode. input_ids: [B, T] ints (numpy
        or tensor); returns int32 numpy [B, n] with n = max_new_tokens, or
        fewer when every row reached ``eos_token_id``."""
        tokens = (input_ids if isinstance(input_ids, torch.Tensor)
                  else torch.as_tensor(np.asarray(input_ids))).to(self.device)
        B, T = tokens.shape
        assert T + max_new_tokens <= self.max_seq, "exceeds KV cache length"
        cache = self._empty_cache(B)
        key = prng_key(seed)
        greedy = temperature == 0.0
        logits, cache = self._prefill_impl(tokens, cache)
        key, sub = split(key)
        first = self._sample(logits, sub, temperature, top_p, greedy)
        if max_new_tokens == 1:
            return first.cpu().numpy()[:, None]
        if eos_token_id is None:
            # the first decoded token goes to cache slot T (slots 0..T-1
            # hold the prompt)
            toks, cache = self._decode_n_impl(
                cache, first, T, key, temperature, top_p,
                n=max_new_tokens - 1, greedy=greedy)
            return torch.cat([first[:, None], toks.t()],
                             dim=1).cpu().numpy()
        # early exit: the host reads each step's tokens to stop at eos
        out = [first]
        nxt = first
        for step in range(max_new_tokens - 1):
            logits, cache = self._decode_impl(cache, nxt, T + step)
            key, sub = split(key)
            nxt = self._sample(logits, sub, temperature, top_p, greedy)
            out.append(nxt)
            if bool((nxt == eos_token_id).all()):
                break
        return torch.stack(out, dim=1).cpu().numpy()
