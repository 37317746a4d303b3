"""GPT, the flagship decoder-only LM, for training (port of
paddle_tpu/models/gpt.py).

The parameter tree has the reference's names, shapes and dtypes, with
``blocks.*`` stacked on a leading layer axis. Every cast point of the
reference is kept: LayerNorm computes in fp32 and casts back, matmuls
take and return ``cfg.dtype``, the gelu is tanh-approximate and the
logits are fp32. Attention on the fused qkv projection goes through the
flash kernels (K1 forward, K2 or K3 backward); where that gate fails,
through ``flash_attention_raw`` on the split q, k, v (K1-sep and K3-sep,
or the head-major K17 under ``flash_attention_native_layout=0`` or with
d 64 and an odd head count), as the reference's ``_attention``. The
chunked loss goes through the vocab-streaming cross-entropy kernels (K4,
K5) on CUDA.

The model is written as the plain op-by-op composition
(``_model_apply_unfused``); ``model_apply`` runs it through the fusion
compiler (``compiler.fused_call``), which places K6 (residual + bias +
LayerNorm) and K7 (bias + gelu) in the forward, as the reference's
default path does. Eager PyTorch always runs the layer loop unrolled, so
``unroll`` changes nothing. MoE layers, ring attention and the sharding
hooks belong to later slices and raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..compiler import fused_call, remat_call
from ..core.flags import GLOBAL_FLAGS
from ..ops.kernels.flash_attention import (flash_attention_qkv,
                                           flash_attention_raw,
                                           flash_qkv_supported,
                                           flash_supported)
from ..ops.kernels.fused_ce import fused_ce_supported, fused_softmax_ce

__all__ = ["GPTConfig", "gpt_presets", "init_params", "block_apply",
           "model_apply", "loss_fn", "gpt_flops_per_token"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    seq_len: int = 1024
    ffn_mult: int = 4
    n_experts: int = 0
    n_moe_layers: int = 0
    moe_capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16          # activation / compute dtype
    param_dtype: Any = torch.float32     # master params
    tie_embeddings: bool = True
    use_flash: bool = True
    # False | True | "full": each block runs through compiler.remat_call
    # (torch.utils.checkpoint with a selective policy, the reference's):
    # True saves the weight matmuls' outputs and the flash o/lse, "full"
    # the flash o/lse only; everything else (K6, K7, the elementwise work)
    # is recomputed in the backward, K1 never
    remat: bool | str = True
    unroll: bool = False                 # eager: always unrolled
    ring_axis: Optional[str] = None
    eps: float = 1e-5

    def __post_init__(self):
        if self.remat not in (False, True, "full"):
            raise ValueError(f"remat must be False, True, or 'full'; got "
                             f"{self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


def gpt_presets(name: str) -> GPTConfig:
    """GPT-3 family sizes (the reference's table)."""
    table = {
        "gpt3-125m": dict(hidden=768, n_layers=12, n_heads=12),
        "gpt3-350m": dict(hidden=1024, n_layers=24, n_heads=16),
        "gpt3-760m": dict(hidden=1536, n_layers=24, n_heads=16),
        "gpt3-1.3b": dict(hidden=2048, n_layers=24, n_heads=16),
        "gpt3-2.7b": dict(hidden=2560, n_layers=32, n_heads=32),
        "gpt3-6.7b": dict(hidden=4096, n_layers=32, n_heads=32),
        "gpt3-13b": dict(hidden=5120, n_layers=40, n_heads=40),
    }
    return GPTConfig(**table[name])


def _refuse_later_slices(cfg: GPTConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("later slice: MoE layers (n_experts > 0)")
    if cfg.ring_axis:
        raise NotImplementedError("later slice: ring attention (ring_axis)")


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters drawn on ``device`` from ``generator``: normal
    (0.02), wpe 0.01, residual projections 0.02 / sqrt(2L), LayerNorm
    gains 1 and biases 0. The numbers differ from the reference's (another
    generator); the tree, names, shapes and dtypes are the same."""
    _refuse_later_slices(cfg)
    H, L, Fd = cfg.hidden, cfg.n_layers, cfg.ffn_mult * cfg.hidden
    std = 0.02
    pstd = std / math.sqrt(2 * L)
    pd = cfg.param_dtype

    def nrm(shape, s=std):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, s, generator=generator)
        return w.to(pd)

    def const(shape, v):
        return torch.full(shape, v, dtype=pd, device=device)

    params = {
        "wte": nrm((cfg.vocab_size, H)),
        "wpe": nrm((cfg.seq_len, H), 0.01),
        "blocks": {
            "ln1_g": const((L, H), 1.0),
            "ln1_b": const((L, H), 0.0),
            "qkv_w": nrm((L, H, 3 * H)),
            "qkv_b": const((L, 3 * H), 0.0),
            "proj_w": nrm((L, H, H), pstd),
            "proj_b": const((L, H), 0.0),
            "ln2_g": const((L, H), 1.0),
            "ln2_b": const((L, H), 0.0),
            "fc_w": nrm((L, H, Fd)),
            "fc_b": const((L, Fd), 0.0),
            "fc2_w": nrm((L, Fd, H), pstd),
            "fc2_b": const((L, H), 0.0),
        },
        "lnf_g": const((H,), 1.0),
        "lnf_b": const((H,), 0.0),
    }
    if not cfg.tie_embeddings:
        params["head_w"] = nrm((H, cfg.vocab_size))
    return params


def _layer_norm(x, g, b, eps):
    """fp32 statistics (population variance), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _mm(x, w, cfg: GPTConfig):
    return torch.matmul(x, w.to(cfg.dtype))


def _attention(q, k, v, cfg: GPTConfig):
    """Causal attention on [B, T, nH, dH] where the fused-qkv gate fails,
    as the reference's: ``flash_attention_raw`` (K1-sep, or the
    head-major K17) where the flash gate holds, else plain attention
    (fp32 logits, fill -1e30, probabilities cast to q's dtype)."""
    if cfg.use_flash and flash_supported(q.shape, q.dtype):
        return flash_attention_raw(q, k, v, causal=True)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    T = q.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def block_apply(bp: dict, x, cfg: GPTConfig):
    """One pre-LN transformer block; ``bp`` leaves are one layer's slice."""
    B, T, H = x.shape
    dt = cfg.dtype
    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"], cfg.eps)
    qkv = _mm(h, bp["qkv_w"], cfg) + bp["qkv_b"].to(dt)
    if cfg.use_flash and flash_qkv_supported(qkv.shape, cfg.n_heads,
                                             qkv.dtype):
        # K1/K2 read q, k and v from the projection output in place
        o = flash_attention_qkv(qkv, cfg.n_heads, causal=True).reshape(
            B, T, H)
    else:
        q, k, v = (t.reshape(B, T, cfg.n_heads, cfg.head_dim)
                   for t in qkv.split(H, dim=-1))
        o = _attention(q, k, v, cfg).reshape(B, T, H)
    o = _mm(o, bp["proj_w"], cfg)
    x = x + o + bp["proj_b"].to(dt)
    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"], cfg.eps)
    h = _mm(h, bp["fc_w"], cfg)
    h = F.gelu(h + bp["fc_b"].to(dt), approximate="tanh")
    h = _mm(h, bp["fc2_w"], cfg)
    return x + h + bp["fc2_b"].to(dt)


def model_apply(params: dict, tokens, cfg: GPTConfig, sp_constraint=None,
                blocks_fn=None, return_hidden: bool = False,
                emb_constraint=None):
    """Forward to fp32 logits [B, T, V] (or, with ``return_hidden``, the
    final hidden states), and the MoE aux loss (0 here). Routed through
    the fusion compiler, as the reference's when no sharding hooks are
    passed: the plan places K6 at every LayerNorm and K7 at every FFN
    gelu (with ``use_auto_fusion=0``, the plain composition runs)."""
    if sp_constraint is not None or blocks_fn is not None or \
            emb_constraint is not None:
        raise NotImplementedError("later slice: sp_constraint, blocks_fn "
                                  "and emb_constraint (sharded steps)")
    _refuse_later_slices(cfg)
    return fused_call(("gpt_apply", cfg, bool(return_hidden)),
                      functools.partial(_model_apply_unfused, cfg=cfg,
                                        return_hidden=return_hidden),
                      params, tokens)


# remat setting -> compiler.remat_call policy (reference gpt.py's
# save_from_both_policies(dots_with_no_batch_dims_saveable, flash names)
# and save_only_these_names("flash_o", "flash_lse"))
_REMAT_POLICY = {True: "save_dots_and_flash", "full": "save_flash"}


def _model_apply_unfused(params: dict, tokens, cfg: GPTConfig,
                         return_hidden: bool = False):
    """The plain op-by-op forward. With ``remat`` each block runs through
    ``compiler.remat_call`` with its policy: recomputed in the backward
    but for what the policy saves, and planned by the compiler as a
    nested program of its own."""
    B, T = tokens.shape
    x = params["wte"][tokens.long()].to(cfg.dtype) + \
        params["wpe"][:T].to(cfg.dtype)
    for i in range(cfg.n_layers):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        if cfg.remat:
            x = remat_call(("gpt_block", cfg),
                           functools.partial(block_apply, cfg=cfg), bp, x,
                           policy=_REMAT_POLICY[cfg.remat])
        else:
            x = block_apply(bp, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.eps)
    if return_hidden:
        return x, aux
    head = params["wte"].t() if cfg.tie_embeddings else params["head_w"]
    return torch.matmul(x.float(), head.to(cfg.dtype).float()), aux


def _ce_chunk(xc, head, lc):
    logits = torch.matmul(xc.float(), head.float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - gold).sum()


def _chunked_ce(x, head, labels, chunk: int):
    """Mean cross-entropy over token chunks of the sequence, each chunk's
    fp32 logits recomputed in the backward (the reference's
    jax.checkpoint'ed scan): peak extra memory [B, chunk, V]."""
    B, T, H = x.shape
    n = max(1, T // chunk)
    while T % n:
        n -= 1
    c = T // n
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        total = total + checkpoint(_ce_chunk, x[:, i * c:(i + 1) * c], head,
                                   labels[:, i * c:(i + 1) * c].long(),
                                   use_reentrant=False)
    return total / (B * T)


def loss_fn(params, tokens, labels, cfg: GPTConfig, sp_constraint=None,
            blocks_fn=None, loss_chunk: int = 512, emb_constraint=None):
    """Causal LM cross-entropy in fp32. ``loss_chunk`` > 0 never holds
    the full logits: on CUDA with ``use_fused_ce`` on, the vocab-streaming
    kernels (K4/K5); elsewhere the chunked expression. 0 materializes the
    full logits."""
    if loss_chunk:
        hidden, aux = model_apply(params, tokens, cfg, sp_constraint,
                                  blocks_fn, return_hidden=True,
                                  emb_constraint=emb_constraint)
        head = params["wte"].t() if cfg.tie_embeddings else params["head_w"]
        B, T = tokens.shape
        if (hidden.is_cuda and GLOBAL_FLAGS.get("use_fused_ce")
                and fused_ce_supported(B * T, cfg.hidden, cfg.vocab_size,
                                       cfg.dtype)):
            nll_tok = fused_softmax_ce(hidden.reshape(B * T, cfg.hidden),
                                       head.to(cfg.dtype),
                                       labels.reshape(B * T))
            return nll_tok.mean() + 0.01 * aux
        nll = _chunked_ce(hidden, head.to(cfg.dtype), labels, loss_chunk)
        return nll + 0.01 * aux
    logits, aux = model_apply(params, tokens, cfg, sp_constraint, blocks_fn,
                              emb_constraint=emb_constraint)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean() + 0.01 * aux


def gpt_flops_per_token(cfg: GPTConfig) -> float:
    """Matmul-only MFU accounting, 6 * P_dense + causal attention (the
    port's copy of the reference bench's count)."""
    H, L, S, V, Fd = (cfg.hidden, cfg.n_layers, cfg.seq_len, cfg.vocab_size,
                      cfg.ffn_mult * cfg.hidden)
    p_dense = V * H + L * (4 * H * H + 2 * H * Fd) + (
        0 if cfg.tie_embeddings else H * V)
    return 6 * p_dense + 6 * L * S * H
