"""The port's copy of the runtime flags its serving slice reads.

Same names, defaults and ``FLAGS_<name>`` environment override as the
reference registry (paddle_tpu/core/flags.py). Flags of paths the port
does not have yet are defined so that turning one on can be refused.
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
# paths of later slices: read only so that turning one on is refused
GLOBAL_FLAGS.define("serving_speculative_k", 0)
GLOBAL_FLAGS.define("serving_kv_quant", False)
GLOBAL_FLAGS.define("serving_lora", False)
GLOBAL_FLAGS.define("serving_priorities", False)
GLOBAL_FLAGS.define("serving_constrained", False)
