"""Serving metrics over a completed open-loop run.

Latency definitions (all relative to each request's ARRIVAL, the
open-loop convention — queueing delay counts against the scheduler):

- TTFT: first token wall time - arrival.
- TPOT: (last token - first token) / (n_tokens - 1) — steady decode
  pace, undefined (excluded) for 1-token requests.
- e2e: completion - arrival.
- goodput: completed-request tokens per second (aborted/incomplete
  requests' tokens are excluded; raw throughput counts them).
- occupancy: the engine's slot-token ledger, reused as-is — active
  fraction plus the six waste buckets (queue-empty, admission-blocked,
  prefill, overrun, spec-rejected, preempted) sum to 1 by construction,
  so a drop in occupancy always carries its cause.
"""

from __future__ import annotations

import numpy as np

from ...obs.metrics import (FLEET_STATS_SCHEMA, MetricsRegistry,
                            SERVING_STATS_SCHEMA)

__all__ = ["percentile", "summarize", "summarize_fleet",
           "fleet_registry"]


def percentile(xs, p: float) -> float:
    if not len(xs):
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), p))


def _aggregate(requests, st: dict, hits: int, misses: int,
               wall_s: float) -> dict:
    """The shared request-record + step-ledger aggregation; ``st`` is
    one engine's stats dict or the element-wise sum across a fleet's
    replicas (the ledger identities survive summation)."""
    done = [r for r in requests
            if not r.aborted and r.t_done is not None
            and len(r.out_tokens) >= r.max_new_tokens]
    aborted = [r for r in requests if r.aborted]
    ttft = [r.t_first - r.arrival for r in done if r.t_first is not None]
    e2e = [r.t_done - r.arrival for r in done]
    tpot = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1)
            for r in done
            if r.t_first is not None and len(r.out_tokens) > 1]
    total_tok = sum(len(r.out_tokens) for r in requests)
    good_tok = sum(len(r.out_tokens) for r in done)
    slot_tok = max(1, st["decode_slot_tokens"])
    out = {
        "n_requests": len(requests),
        "n_completed": len(done),
        "n_aborted": len(aborted),
        "wall_s": round(wall_s, 3),
        "total_new_tokens": total_tok,
        "throughput_tok_s": round(total_tok / max(wall_s, 1e-9), 1),
        "goodput_tok_s": round(good_tok / max(wall_s, 1e-9), 1),
        "ttft_p50_s": round(percentile(ttft, 50), 4),
        "ttft_p99_s": round(percentile(ttft, 99), 4),
        "tpot_p50_s": round(percentile(tpot, 50), 5),
        "tpot_p99_s": round(percentile(tpot, 99), 5),
        "e2e_p50_s": round(percentile(e2e, 50), 4),
        "e2e_p99_s": round(percentile(e2e, 99), 4),
        "slot_occupancy": round(st["decode_active_tokens"] / slot_tok, 3),
        "occ_waste_queue_empty": round(
            st["waste_queue_empty_slot_tokens"] / slot_tok, 3),
        "occ_waste_admission_blocked": round(
            st["waste_admission_blocked_slot_tokens"] / slot_tok, 3),
        "occ_waste_prefill": round(
            st["waste_prefill_slot_tokens"] / slot_tok, 3),
        "occ_waste_overrun": round(
            st["waste_overrun_slot_tokens"] / slot_tok, 3),
        "occ_waste_spec_rejected": round(
            st["waste_spec_rejected_slot_tokens"] / slot_tok, 3),
        "occ_waste_preempted": round(
            st.get("waste_preempted_slot_tokens", 0) / slot_tok, 3),
        "preemption_rate": round(
            st.get("preemptions", 0) / max(1, len(requests)), 3),
        "n_preemptions": st.get("preemptions", 0),
        "spec_accept_rate": round(
            st["spec_accepted_tokens"] / st["spec_proposed_tokens"], 3)
        if st["spec_proposed_tokens"] else 0.0,
        "prefix_cache_hit_rate": round(
            hits / (hits + misses), 3) if hits + misses else 0.0,
        "unified_steps": st["unified_steps"],
    }
    return out


def summarize(requests, engine, wall_s: float) -> dict:
    """Aggregate per-request records + the engine's step ledger into the
    metric dict a benchmark reports."""
    return _aggregate(requests, engine.stats, engine.pool.hits,
                      engine.pool.misses, wall_s)


def summarize_fleet(requests, router, wall_s: float) -> dict:
    """Fleet aggregation: the same request-level percentiles over the
    whole request set, the step/occupancy ledger summed across every
    replica (dead ones included — their pre-kill work happened), plus
    the router's own counters (kills, migrated pages/bytes, recovery
    latency, shed/retry/deadline drops; under disaggregated pools also
    shipped pages/bytes, pool census, degraded-mode ticks and the
    longest degraded episode — ``disagg_recovery_ms``). TTFT under
    disaggregation is measured at the *prefill* engine's first-token
    emission, which is exactly the pool split's claimed benefit."""
    st: dict = {}
    hits = misses = 0
    for rep in router.replicas:
        for k, v in rep.engine.stats.items():
            st[k] = st.get(k, 0) + v
        hits += rep.engine.pool.hits
        misses += rep.engine.pool.misses
    out = _aggregate(requests, st, hits, misses, wall_s)
    out.update(router.fleet_stats())
    # at fleet scale the raw-list percentiles above are replaced by
    # exponential-bucket histograms: O(buckets) memory for any request
    # count, relative error bounded by the bucket growth (obs.metrics)
    reg = fleet_registry(requests, st)
    done = [r for r in requests
            if not r.aborted and r.t_done is not None
            and len(r.out_tokens) >= r.max_new_tokens]
    if done:
        ttft_h = reg.histogram("ttft_seconds")
        tpot_h = reg.histogram("tpot_seconds")
        out["ttft_p50_s"] = round(ttft_h.percentile(50), 4)
        out["ttft_p99_s"] = round(ttft_h.percentile(99), 4)
        out["tpot_p50_s"] = round(tpot_h.percentile(50), 5)
        out["tpot_p99_s"] = round(tpot_h.percentile(99), 5)
    return out


def fleet_registry(requests, st: dict) -> MetricsRegistry:
    """A :class:`MetricsRegistry` over a completed fleet run: the
    summed engine counters absorbed through their declared schema, plus
    TTFT/TPOT histograms over the request records, exportable as JSON or
    Prometheus text."""
    reg = MetricsRegistry()
    reg.absorb(st, SERVING_STATS_SCHEMA)
    reg.absorb(st, FLEET_STATS_SCHEMA)
    ttft_h = reg.histogram("ttft_seconds",
                           "arrival -> first token (fleet-wide)")
    tpot_h = reg.histogram("tpot_seconds", "steady decode pace")
    for r in requests:
        if r.aborted or r.t_done is None \
                or len(r.out_tokens) < r.max_new_tokens:
            continue
        if r.t_first is not None:
            ttft_h.observe(max(0.0, r.t_first - r.arrival))
            if len(r.out_tokens) > 1:
                tpot_h.observe(max(0.0, (r.t_done - r.t_first)
                                   / (len(r.out_tokens) - 1)))
    return reg
