"""The port's load generator against the JAX package's on the CPU: the
arrival processes and ``synthesize`` (every decoration: multi-tenant,
fleet, prefill-heavy, phase imbalance) give equal traffic for the same
seeds; ``percentile`` and the fleet metrics; the rush-clock drivers end
to end against the JAX drivers on the same fleet; the wall-clock
deadline sweep; ``summarize_fleet``'s keys cover ``FLEET_STATS_SCHEMA``;
and with every fleet, disaggregation and wire flag turned on a lone
engine's streams, counters and ledger are unchanged (the engine reads
none of them) and equal the reference engine's."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import dataclasses
import inspect

import numpy as np
import pytest

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.inference import loadgen as jlg
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.inference import loadgen as tlg
from paddle_tpu_torch.inference.serving import Request as TRequest
from paddle_tpu_torch.obs import metrics as tmetrics

from torch_fleet_common import (TIMING_KEYS, assert_port_ledger,
                                assert_same_fleet, engines, isolate,
                                routers, settle, solo_port)

__all__ = ["isolate"]

SPECS = [
    dict(n_requests=40, seed=3, vocab_size=256, process="poisson", rate=8.0,
         max_seq=128, tail_max=64, new_min=4, new_max=16, sampled_frac=0.5),
    dict(n_requests=40, seed=5, vocab_size=256, process="gamma", cv=3.0,
         prefix_len=16, n_prefixes=2, max_seq=256, n_tenants=4,
         n_adapters=2, priority_levels=3, constrained_frac=0.3),
    dict(n_requests=40, seed=9, vocab_size=256, process="burst",
         burst_size=4, max_seq=512, tenant_skew=1.5, n_tenants=4,
         n_sessions=3, deadline_ttft=2.0, deadline_e2e=9.0,
         prefill_heavy_frac=0.5, prefill_heavy_len=64),
    dict(n_requests=64, seed=17, vocab_size=256, rate=8.0, new_min=4,
         new_max=16, tail_min=8, tail_max=64, max_seq=128,
         phase_imbalance=0.8, phase_epoch_s=2.0, phase_imbalance_len=48),
]


def _fields(r) -> dict:
    d = dataclasses.asdict(r)
    d["prompt"] = np.asarray(r.prompt, np.int32).tobytes()
    return d


@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_processes_equal_reference(seed):
    for name, args in (("poisson_arrivals", (5.0, 64)),
                       ("gamma_arrivals", (5.0, 2.5, 64)),
                       ("burst_arrivals", (5.0, 64))):
        a = getattr(jlg, name)(*args, seed=seed)
        b = getattr(tlg, name)(*args, seed=seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    with pytest.raises(ValueError):
        tlg.poisson_arrivals(0.0, 4)


@pytest.mark.parametrize("spec", SPECS, ids=["legacy", "tenants", "fleet",
                                             "phases"])
def test_synthesize_equals_reference(spec):
    """Every field of every request equal, decorations included."""
    assert [f.name for f in dataclasses.fields(tlg.WorkloadSpec)] == \
        [f.name for f in dataclasses.fields(jlg.WorkloadSpec)]
    assert [f.name for f in dataclasses.fields(TRequest)] == \
        [f.name for f in dataclasses.fields(JRequest)]
    a = jlg.synthesize(jlg.WorkloadSpec(**spec))
    b = tlg.synthesize(tlg.WorkloadSpec(**spec))
    assert all(isinstance(r, TRequest) for r in b)
    assert [_fields(r) for r in a] == [_fields(r) for r in b]


def test_percentile_and_fleet_registry():
    xs = np.random.RandomState(0).exponential(size=200)
    for p in (0, 50, 90, 99, 100):
        assert tlg.percentile(xs, p) == jlg.percentile(xs, p)
    assert tlg.percentile([], 50) == 0.0
    h = tmetrics.Histogram("x")
    for x in xs:
        h.observe(x)
    for p in (50, 99):
        assert abs(h.percentile(p) - np.percentile(xs, p)) <= \
            0.2 * np.percentile(xs, p)
    reg = tmetrics.MetricsRegistry()
    reg.absorb({"n_killed": 2, "ship_queue_depth": 3, "nope": 1},
               tmetrics.FLEET_STATS_SCHEMA)
    assert reg.get("n_killed") == 2.0 and reg.get("nope", -1) == -1
    assert "# TYPE ship_queue_depth gauge" in reg.to_prometheus()


def _fleet_reqs(cls):
    rng = np.random.RandomState(13)
    return [cls(rid=i, prompt=rng.randint(1, 256, size=rng.randint(
        24, 48)).astype(np.int32), max_new_tokens=6,
        **(dict(temperature=0.8, top_p=0.9, seed=104) if i == 4 else {}))
        for i in range(6)]


@pytest.mark.parametrize("disagg", [0, 1])
def test_fleet_driver_rush_kill_equals_reference(disagg):
    """FleetDriver under the rush clock with a step-indexed kill (a
    colocated fleet, and a split one losing its prefill pool): every
    request completes, the metric dicts agree with the JAX driver's
    outside wall-clock readings, and the summary carries every
    FLEET_STATS_SCHEMA counter."""
    jr, tr = routers(disagg_prefill=disagg)
    jreqs, treqs = _fleet_reqs(JRequest), _fleet_reqs(TRequest)
    kills = {4: "pool:prefill"} if disagg else {4: 1}
    mj = jlg.FleetDriver(jr, clock="rush").run(jreqs, kills=kills)
    mt = tlg.FleetDriver(tr, clock="rush").run(treqs, kills=kills)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in treqs)
    for r in treqs:
        assert r.out_tokens == solo_port(r), r.rid
    assert_same_fleet(jr, tr, jreqs, treqs)
    assert set(mt) == set(mj)
    wall = TIMING_KEYS | {"wall_s", "throughput_tok_s", "goodput_tok_s",
                          "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                          "tpot_p99_s", "e2e_p50_s", "e2e_p99_s"}
    assert {k: v for k, v in mt.items() if k not in wall} == \
        {k: v for k, v in mj.items() if k not in wall}
    assert set(tmetrics.FLEET_STATS_SCHEMA) <= set(mt)
    assert set(tmetrics.FLEET_STATS_SCHEMA) == set(tr.stats)
    assert mt["fleet_n_alive"] == 1 and mt["n_completed"] == 6
    assert mt["goodput_tok_s"] > 0
    settle(tr)
    assert_port_ledger(tr)


def test_open_loop_driver_rush_and_wall_deadline():
    """OpenLoopDriver on one port engine: the rush clock equals the JAX
    driver's counters; on the wall clock a request whose TTFT budget
    lapses is aborted and counted, the rest unaffected."""
    (je,), (te,) = engines(1)
    mj = jlg.OpenLoopDriver(je, clock="rush").run(_fleet_reqs(JRequest),
                                                  aborts={3: 2})
    treqs = _fleet_reqs(TRequest)
    mt = tlg.OpenLoopDriver(te, clock="rush").run(treqs, aborts={3: 2})
    for k in ("n_completed", "n_aborted", "total_new_tokens", "steps",
              "unified_steps", "slot_occupancy", "prefix_cache_hit_rate"):
        assert mt[k] == mj[k], k
    assert treqs[2].aborted
    (te2,) = engines(1)[1]
    doomed = TRequest(rid=0, prompt=np.arange(1, 30, dtype=np.int32),
                      max_new_tokens=6, deadline_ttft=1e-9)
    fine = TRequest(rid=1, prompt=np.arange(1, 30, dtype=np.int32),
                    max_new_tokens=6, deadline_ttft=60.0)
    m = tlg.OpenLoopDriver(te2, clock="wall").run([doomed, fine])
    assert doomed.aborted and m["n_deadline_expired"] == 1
    assert m["deadline_miss_rate"] == 0.5 and not fine.aborted
    assert len(fine.out_tokens) == 6


_ON = {"serving_fleet_engines": 2, "serving_fleet_migration": False,
       "serving_fleet_affinity": False, "serving_fleet_retry_max": 0,
       "serving_fleet_step_budget": 0.5, "serving_fleet_shed_backlog": 0.5,
       "serving_fleet_tight_deadline": 9.0, "serving_disagg_prefill": 1,
       "serving_disagg_ship_deadline": 2.0, "serving_disagg_dynamic": True}


def test_fleet_flags_leave_a_lone_engine_unchanged():
    """The engine's source reads no fleet or disagg flag, and a lone
    engine run with all of them on (and the wire overlap flag, which it
    reads but only a fleet exercises) gives the streams, counters and
    ledger of the run with them off, equal to the reference engine's."""
    from paddle_tpu_torch.inference import serving

    src = inspect.getsource(serving)
    assert "serving_fleet" not in src and "serving_disagg" not in src

    def run(flags_on):
        saved = {k: TFLAGS.get(k) for k in _ON}
        saved["serving_wire_overlap"] = TFLAGS.get("serving_wire_overlap")
        try:
            if flags_on:
                for k, v in _ON.items():
                    TFLAGS.set(k, v)
                TFLAGS.set("serving_wire_overlap", True)
            (_,), (te,) = engines(1)
            reqs = _fleet_reqs(TRequest)
            te.run(reqs)
            settle_engine(te)
            return ([r.out_tokens for r in reqs],
                    {k: v for k, v in te.stats.items()
                     if k not in TIMING_KEYS}, te.page_accounting(), te)
        finally:
            for k, v in saved.items():
                TFLAGS.set(k, v)

    off, on = run(False), run(True)
    assert on[:3] == off[:3] and on[3]._wire_overlap
    (je,), _ = engines(1)
    jreqs = _fleet_reqs(JRequest)
    je.run(jreqs)
    assert [r.out_tokens for r in jreqs] == off[0]
    assert je.page_accounting() == off[2]
    assert off[3].stats["wire_export_ms"] == 0
    assert JFLAGS.get("serving_fleet_engines") == 0


def settle_engine(e):
    if e._deferred_free or e.pool.pending_evict:
        e.pool.release(e._deferred_free)
        e._deferred_free = []
        e.pool.commit_evictable()


def test_decode_quantum_is_a_deprecated_no_op():
    """The reference's deprecated kwarg warns and changes nothing."""
    with pytest.warns(DeprecationWarning, match="decode_quantum"):
        (_,), (te,) = engines(1, decode_quantum=4)
    assert te.decode_quantum == 4
    reqs = _fleet_reqs(TRequest)[:2]
    te.run(reqs)
    assert [r.out_tokens for r in reqs] == [solo_port(r) for r in reqs]
