"""The port's copy of the runtime flags its serving and training slices
read.

Same names, defaults and ``FLAGS_<name>`` environment override as the
reference registry (paddle_tpu/core/flags.py). Flags of paths the port
does not have yet are defined so that turning one on can be refused.

The training step runs the reference's default path: the fusion
compiler (``compiler/``) plans GPT's forward with ``use_auto_fusion``
on, and ``use_fused_norm_epilogue`` / ``use_fused_rope_attention`` /
``use_fused_bias_act`` are the kill switches of its templates (LLaMA's
prefill runs through the same compiler).
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = ["FlagRegistry", "GLOBAL_FLAGS"]


class FlagRegistry:
    """Typed flag store; ``FLAGS_<name>`` in the environment overrides
    the default when the flag is defined."""

    def __init__(self):
        self._flags: dict[str, tuple[type, Any]] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default: Any) -> None:
        with self._lock:
            if name in self._flags:
                raise ValueError(f"flag '{name}' already defined")
            value = default
            env = os.environ.get(f"FLAGS_{name}")
            if env is not None:
                value = self._parse(env, type(default))
            self._flags[name] = (type(default), value)

    @staticmethod
    def _parse(text: str, ty: type) -> Any:
        if ty is bool:
            return text.lower() in ("1", "true", "yes", "on")
        return ty(text)

    def get(self, name: str) -> Any:
        with self._lock:
            return self._flags[name][1]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            ty = self._flags[name][0]
            if not isinstance(value, ty):
                value = self._parse(str(value), ty)
            self._flags[name] = (ty, value)


GLOBAL_FLAGS = FlagRegistry()


# serving-engine defaults, read when the caller passes None
GLOBAL_FLAGS.define("serving_prefill_budget", 512)
GLOBAL_FLAGS.define("serving_prefix_cache", True)
GLOBAL_FLAGS.define("serving_prefix_cache_pages", 0)
GLOBAL_FLAGS.define("serving_unified_qb", 16)
GLOBAL_FLAGS.define("decode_weight_quant", False)
# n-gram self-drafting: drafts per decode row (0 = off), longest n-gram
GLOBAL_FLAGS.define("serving_speculative_k", 0)
GLOBAL_FLAGS.define("serving_spec_ngram", 3)
# int8 KV pages with per-page, per-kv-head fp32 scale planes
GLOBAL_FLAGS.define("serving_kv_quant", False)
# multi-tenancy: per-request LoRA adapters on the page pool, priority
# classes with preemption, schema-constrained decoding
GLOBAL_FLAGS.define("serving_lora", False)
GLOBAL_FLAGS.define("serving_priorities", False)
GLOBAL_FLAGS.define("serving_constrained", False)

# training: False runs the plain chunked cross-entropy, as the reference
GLOBAL_FLAGS.define("use_fused_ce", True)
# the fusion compiler: False calls the model untraced (the plain
# composition); the other three disable discovery of their templates
GLOBAL_FLAGS.define("use_auto_fusion", True)
GLOBAL_FLAGS.define("use_fused_norm_epilogue", True)
GLOBAL_FLAGS.define("use_fused_rope_attention", True)
GLOBAL_FLAGS.define("use_fused_bias_act", True)
# flash attention's layout: False sends flash_attention_raw to the
# head-major kernels (K17) and turns the fused-qkv and rope entries off,
# as the reference's
GLOBAL_FLAGS.define("flash_attention_native_layout", True)
# training paths of later slices (the XLA-expression flash backward, a
# library kernel): moving one off its default is refused by
# ops/kernels/flash_attention.py
GLOBAL_FLAGS.define("flash_attention_kernel_bwd", True)
GLOBAL_FLAGS.define("use_library_flash_attention", False)
# the fused-qkv flash backward: True takes the merged kernel (K2) where the
# reference's gate holds, False the split dq + dk/dv kernels (K3) always;
# read when the backward runs
GLOBAL_FLAGS.define("flash_attention_fused_dqkv", True)
# sharded training (later slice): turning it on is refused
GLOBAL_FLAGS.define("dist_allreduce_quant", False)
