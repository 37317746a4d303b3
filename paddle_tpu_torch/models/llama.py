"""LLaMA building blocks for serving (port of paddle_tpu/models/llama.py).

The parameter tree has the reference's names and shapes: ``blocks.*``
leaves are stacked on a leading layer axis, so weights carry across
packages one leaf at a time. Every cast point of the reference is kept:
RMSNorm and RoPE compute in fp32 and cast back, matmuls accumulate in
fp32 and return ``cfg.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..ops.kernels.quant_matmul import quant_matmul
from ..ops.quant import absmax_quantize_int8

__all__ = ["LlamaConfig", "llama_presets", "init_llama_params", "rms_norm",
           "rope_angles", "apply_rope", "quantize_weights_int8"]


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

