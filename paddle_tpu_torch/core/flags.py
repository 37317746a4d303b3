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

__all__ = ["FlagRegistry", "GLOBAL_FLAGS", "get_flags", "set_flags"]


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

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._flags

    def all(self) -> dict[str, Any]:
        with self._lock:
            return {k: v for k, (_, v) in self._flags.items()}


GLOBAL_FLAGS = FlagRegistry()


def _bare(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def get_flags(flags) -> dict[str, Any]:
    """Query one flag name or a list of names (``FLAGS_`` prefix
    optional); returns a dict keyed as asked."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: GLOBAL_FLAGS.get(_bare(name)) for name in flags}


def set_flags(flags: dict[str, Any]) -> None:
    for name, value in flags.items():
        GLOBAL_FLAGS.set(_bare(name), value)


# the eager op funnel (core/dispatch.py): check every op's floating
# outputs for NaN/Inf; level 0 raises FloatingPointError naming the op,
# a level above 0 prints a warning and goes on
GLOBAL_FLAGS.define("check_nan_inf", False)
GLOBAL_FLAGS.define("check_nan_inf_level", 0)
# nn.functional.scaled_dot_product_attention: with no mask and no
# dropout, shapes the flash gate takes go to the flash kernels
GLOBAL_FLAGS.define("use_pallas_attention", True)


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
# sharded training: the dp gradient sync of make_sharded_train_step as
# the int8-wire all-reduce (distributed/autograd_collectives.py), each dp
# rank's forward and backward on its own rows; nothing to sync on one
# device
GLOBAL_FLAGS.define("dist_allreduce_quant", False)

# the fleet (inference/fleet/): read only by FleetRouter, never by a lone
# ServingEngine. The overlapped migration wire is the engine's, read when
# its constructor gets no wire_overlap
GLOBAL_FLAGS.define("serving_wire_overlap", False)
GLOBAL_FLAGS.define("serving_fleet_engines", 0)
GLOBAL_FLAGS.define("serving_fleet_migration", True)
GLOBAL_FLAGS.define("serving_fleet_affinity", True)
GLOBAL_FLAGS.define("serving_fleet_retry_max", 3)
GLOBAL_FLAGS.define("serving_fleet_retry_base_delay", 0.05)
GLOBAL_FLAGS.define("serving_fleet_step_budget", 0.0)
GLOBAL_FLAGS.define("serving_fleet_fail_threshold", 1)
GLOBAL_FLAGS.define("serving_fleet_shed_backlog", 0.0)
GLOBAL_FLAGS.define("serving_fleet_tight_deadline", 0.25)
# disaggregated prefill / decode pools
GLOBAL_FLAGS.define("serving_disagg_prefill", 0)
GLOBAL_FLAGS.define("serving_disagg_ship_deadline", 0.0)
GLOBAL_FLAGS.define("serving_disagg_dynamic", False)
GLOBAL_FLAGS.define("serving_disagg_ewma", 0.3)
GLOBAL_FLAGS.define("serving_disagg_hysteresis", 0.2)
# zero-downtime operations (FleetRouter.rollout, autoscale, SLO shed)
GLOBAL_FLAGS.define("serving_fleet_rollout_canary", 4)
GLOBAL_FLAGS.define("serving_fleet_autoscale", False)
GLOBAL_FLAGS.define("serving_fleet_min_engines", 1)
GLOBAL_FLAGS.define("serving_fleet_max_engines", 4)
GLOBAL_FLAGS.define("serving_fleet_scale_high", 0.85)
GLOBAL_FLAGS.define("serving_fleet_scale_low", 0.2)
GLOBAL_FLAGS.define("serving_fleet_scale_ewma", 0.3)
GLOBAL_FLAGS.define("serving_fleet_scale_cooldown", 1.0)
GLOBAL_FLAGS.define("serving_fleet_slo_shed", False)
GLOBAL_FLAGS.define("serving_fleet_slo_rate", 0.0)
# the self-healing training runtime (parallel/resilient_loop.py reads
# these when the caller passes None; FLAGS_* in the environment reaches
# the workers a launcher starts)
# consecutive NaN/Inf steps tolerated (skipped) before the loop rolls
# state back to the last good checkpoint
GLOBAL_FLAGS.define("resilient_max_bad_steps", 3)
# seconds a step may block before the StepWatchdog escalates (comm-task
# dump -> checkpoint -> elastic exit)
GLOBAL_FLAGS.define("resilient_step_timeout", 120.0)
# rotated checkpoints kept by the loop (save_checkpoint keep_last_k)
GLOBAL_FLAGS.define("resilient_keep_last_k", 3)
# retry attempts for store / checkpoint IO in with_retries
GLOBAL_FLAGS.define("resilient_retry_max", 5)
# base backoff seconds for with_retries (exponential, full jitter)
GLOBAL_FLAGS.define("resilient_retry_base_delay", 0.05)
# the observability plane (obs/): host-side span tracing into a bounded
# ring and flight-recorder dumps on death paths
GLOBAL_FLAGS.define("obs_trace", False)
GLOBAL_FLAGS.define("obs_buffer_events", 65536)
GLOBAL_FLAGS.define("obs_dir", "artifacts")
