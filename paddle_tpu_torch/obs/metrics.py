"""Typed metrics: Counter / Gauge / exponential-bucket Histogram, the
declared schema of the engine's and the router's ``stats`` counters,
and a registry with JSON and Prometheus-text exporters.

Keep the schemas in step with the ``self.stats`` initializers of
``inference/serving.py`` and ``inference/fleet/router.py``.

Histograms replace raw latency lists at fleet scale: an exponential
bucket ladder (growth 1.2, ~1e-5 s .. ~1.5e3 s) holds any request count
in O(buckets) memory, its percentiles within the growth factor of the
exact ones.
"""

from __future__ import annotations

import json
import math
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SERVING_STATS_SCHEMA", "FLEET_STATS_SCHEMA"]


# -- declared stats schemas (name -> (kind, help)) ---------------------------

SERVING_STATS_SCHEMA = {
    "unified_steps": ("counter", "unified scheduler steps executed"),
    "decode_steps": ("counter", "steps that ran a decode program"),
    "prefills": ("counter", "steps that ran a prefill grid"),
    "prefill_tokens": ("counter", "prompt tokens prefilled (useful)"),
    "prefill_grid_tokens": ("counter", "prefill grid slots launched"),
    "prefill_cached_tokens": ("counter",
                              "prompt tokens served from the prefix "
                              "cache instead of the grid"),
    "decode_slot_tokens": ("counter",
                           "decode slot-token capacity offered"),
    "decode_active_tokens": ("counter", "decode slot-tokens kept"),
    "waste_prefill_slot_tokens": ("counter",
                                  "slot-tokens idle mid-prefill"),
    "waste_queue_empty_slot_tokens": ("counter",
                                      "slot-tokens idle, queue empty"),
    "waste_admission_blocked_slot_tokens": ("counter",
                                            "slot-tokens idle, admission "
                                            "blocked on pages"),
    "waste_overrun_slot_tokens": ("counter",
                                  "slot-tokens past a finished stream"),
    "waste_spec_rejected_slot_tokens": ("counter",
                                        "speculative draft tokens "
                                        "rejected"),
    "waste_preempted_slot_tokens": ("counter",
                                    "slot-tokens re-prefilled after "
                                    "preemption"),
    "spec_proposed_tokens": ("counter", "speculative tokens proposed"),
    "spec_accepted_tokens": ("counter", "speculative tokens accepted"),
    "preemptions": ("counter", "requests preempted for pages"),
    "wire_export_ms": ("counter",
                       "donor-side host ms materializing migration-wire "
                       "export payloads"),
}

FLEET_STATS_SCHEMA = {
    "n_submitted": ("counter", "requests submitted to the router"),
    "n_killed": ("counter", "replicas declared dead"),
    "n_recovered": ("counter", "accepted victim streams resumed"),
    "migrated_pages": ("counter", "pages shipped donor -> survivor"),
    "migration_bytes": ("counter", "payload bytes of death migrations"),
    "migration_dropped": ("counter", "shipments lost on the wire"),
    "migration_rejected": ("counter", "shipments the adopter refused"),
    "migration_failed": ("counter", "shipments failing adoption"),
    "n_shed": ("counter", "requests shed under pressure"),
    "n_retry_exhausted": ("counter", "requests out of placement retries"),
    "n_deadline_dropped": ("counter", "requests past their e2e deadline"),
    "disagg_shipped_pages": ("counter",
                             "pages handed prefill -> decode pool"),
    "disagg_ship_bytes": ("counter", "payload bytes of disagg handoffs"),
    "degraded_steps": ("counter", "router ticks in degraded mode"),
    "n_resplit": ("counter", "pool splits recomputed"),
    "n_ship_retries": ("counter", "ship jobs sent back to backoff"),
    "n_ship_deadline": ("counter", "ship jobs past the ship deadline"),
    "shipped_bytes": ("counter", "total bytes over the migration wire"),
    "wire_adopt_ms": ("counter", "adopter-side wall ms on the wire"),
    "n_handoffs": ("counter", "successful page-bearing handoffs"),
    "ship_queue_depth": ("gauge", "peak outbox + ship-retry depth"),
    "n_rollouts": ("counter", "live weight rollouts started"),
    "n_rollback": ("counter", "fleet-wide rollout rollbacks"),
    "n_canary_fail": ("counter", "post-swap canary failures"),
    "n_swap_deaths": ("counter", "engines dead mid-swap"),
    "rollout_ms": ("counter", "total drain->swap->canary wall ms"),
    "n_slo_shed": ("counter", "requests shed by the SLO predictor"),
    "n_scale_up": ("counter", "autoscale engine additions"),
    "n_scale_down": ("counter", "autoscale engine retirements"),
}


class Counter:
    """Monotonically increasing value (float to absorb *_ms totals)."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exponential-bucket histogram with interpolated percentiles.

    Bounds are ``LO * GROWTH**i``; an observation lands in the first
    bucket whose upper bound exceeds it (plus an underflow and an
    overflow bucket). Percentiles interpolate linearly inside the
    winning bucket and clamp to the observed min/max, so relative error
    is bounded by ``GROWTH - 1`` (20%) and is typically far smaller.
    """

    LO = 1e-5
    GROWTH = 1.2
    N_BUCKETS = 104          # LO * GROWTH**104 ~ 1.6e3 s

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.bounds = [self.LO * self.GROWTH ** i
                       for i in range(self.N_BUCKETS)]
        # counts[0] = underflow (< LO); counts[-1] = overflow
        self.counts = [0] * (self.N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _index(self, x: float) -> int:
        if x < self.LO:
            return 0
        i = int(math.log(x / self.LO) / math.log(self.GROWTH)) + 1
        # float log can land one bucket early/late at a boundary
        while i <= self.N_BUCKETS and i >= 1 and x >= self.bounds[i - 1]:
            i += 1
        i -= 1
        return min(max(i, 0), self.N_BUCKETS)

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[self._index(x)] += 1
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile (0..100) of the observations;
        0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = (p / 100.0) * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = (self.bounds[i] if i < self.N_BUCKETS
                      else (self.max if self.max is not None else lo))
                frac = (target - acc) / c
                v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                if self.min is not None:
                    v = max(v, self.min)
                if self.max is not None:
                    v = min(v, self.max)
                return v
            acc += c
        return self.max if self.max is not None else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min or 0.0, "max": self.max or 0.0,
                "p50": self.percentile(50.0),
                "p90": self.percentile(90.0),
                "p99": self.percentile(99.0)}


class MetricsRegistry:
    """Name -> typed metric, with schema-driven absorption of the
    legacy ``stats`` dicts and JSON / Prometheus-text snapshots."""

    def __init__(self):
        self._metrics: dict = {}

    # -- construction -----------------------------------------------------

    def _make(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise TypeError(f"metric '{name}' already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._make(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._make(Histogram, name, help)

    # -- compat with the legacy stats dicts -------------------------------

    def absorb(self, stats: dict, schema: dict) -> None:
        """Load a legacy ``stats`` dict through its declared schema:
        counters/gauges take the dict's current totals. Keys absent
        from the schema are ignored (derived keys like ``fleet_*``
        summaries ride through ``snapshot`` consumers instead)."""
        for key, value in stats.items():
            decl = schema.get(key)
            if decl is None or not isinstance(value, (int, float)):
                continue
            kind, help = decl
            if kind == "gauge":
                self.gauge(key, help).set(value)
            else:
                c = self.counter(key, help)
                c.value = float(value)

    def get(self, name: str, default: float = 0.0) -> float:
        """Compat accessor: the scalar value of a counter/gauge (or a
        histogram's count), like ``stats.get(name, 0)``."""
        m = self._metrics.get(name)
        if m is None:
            return default
        return m.count if isinstance(m, Histogram) else m.value

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): HELP/TYPE per metric,
        histogram as cumulative ``_bucket{le=...}`` + ``_sum``/
        ``_count``."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                acc = 0
                for i, c in enumerate(m.counts[:-1]):
                    acc += c
                    if c:
                        lines.append(f'{name}_bucket{{le="'
                                     f'{m.bounds[i]:.6g}"}} {acc}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.sum:.6g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {m.value:.6g}")
        return "\n".join(lines) + "\n"
