"""The port's FleetRouter against the JAX package's on the CPU: the same
weights, requests and chaos plans through both fleets, stepped in
lockstep. Streams must be exact, the owner engine of each request equal,
``fleet_stats()`` and every engine's counters equal (wall-clock readings
aside) and ``page_accounting()`` equal after every tick, for replica
kills (greedy and sampled), dropped and corrupt migrations, randomized
kill / abort schedules, placement, affinity and deadlines, pressure
shedding and retry exhaustion. The port's own properties, as
tests/test_fleet.py holds the reference's: every resumed stream equals a
lone port engine's uninterrupted one, and the 7-class page ledger sums
per engine and fleet-wide on every tick."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.inference.fleet import FleetRouter as TRouter
from paddle_tpu_torch.inference.fleet import ship_pages
from paddle_tpu_torch.inference.serving import Request as TRequest
from paddle_tpu_torch.testing import chaos as tchaos

from torch_fleet_common import (EKW, TCFG, arm, assert_port_ledger,
                                assert_same_fleet, engines, isolate,
                                lockstep, owners, requests, routers,
                                settle, solo_port, submit)

__all__ = ["isolate"]


def _kill_run(*chaos_specs, sampled=(1, 3)):
    """Engine 0 dies on its own 6th step under ``chaos_specs``; both
    fleets drain in lockstep. Returns (jr, tr, jreqs, treqs)."""
    arm(("engine.step", "raise", dict(at=6, engine=0)), *chaos_specs)
    jr, tr = routers()
    jreqs, treqs = requests(seed=11, n=4, sampled=sampled)
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    assert_same_fleet(jr, tr, jreqs, treqs)
    assert [rep.alive for rep in tr.replicas] == [False, True]
    for r in treqs:
        assert not r.aborted and len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == solo_port(r), r.rid
    settle(tr)
    assert_port_ledger(tr)
    return jr, tr, jreqs, treqs


def test_engine_loss_greedy_and_sampled_matches_reference():
    """Chaos kills engine 0 mid-decode: pages migrate, accepted streams
    recover, and both fleets agree on every tick and every counter."""
    _, tr, _, _ = _kill_run()
    st = tr.fleet_stats()
    assert st["n_killed"] == 1 and st["migrated_pages"] > 0
    assert st["n_recovered"] > 0 and st["recovery_ms_max"] > 0


@pytest.mark.parametrize("kind,counter", [("drop", "migration_dropped"),
                                          ("corrupt", "migration_rejected")])
def test_engine_loss_with_lost_or_corrupt_migration(kind, counter):
    """Every shipment dropped on the wire, or flipped in transit and
    rejected by the adopter's crc: recovery re-prefills, nothing enters
    the survivor's cache, and the streams stay the uninterrupted ones."""
    _, tr, _, _ = _kill_run(("migration.ship", kind, dict(once=False)))
    assert tr.stats[counter] > 0 and tr.stats["migrated_pages"] == 0


@pytest.mark.parametrize("seed", [29, 31])
def test_randomized_kill_migrate_abort(seed):
    """A random replica kill and random aborts under load, the same in
    both fleets; survivors settle with nothing stuck in a slot,
    deferred or in-flight class."""
    rng = np.random.RandomState(seed)
    jr, tr = routers()
    jreqs, treqs = requests(seed=seed, n=8, max_new=8, sampled=(2, 5))
    submit(jr, tr, jreqs, treqs)
    kill_at = int(rng.randint(4, 9))
    victim = int(rng.randint(2))
    abort_at = {int(rng.randint(2, 12)): int(rng.randint(8))
                for _ in range(2)}

    def on_step(n, router):
        if n == kill_at:
            router.kill_engine(victim, now=1e18)
        if n in abort_at:
            router.abort(abort_at[n])

    lockstep(jr, tr, on_step)
    assert_same_fleet(jr, tr, jreqs, treqs)
    assert tr.stats["n_killed"] == 1
    for r in treqs:
        assert r.aborted or r.out_tokens == solo_port(r), r.rid
    settle(jr)
    settle(tr)
    assert tr.page_accounting() == jr.page_accounting()
    for rep in tr.replicas:
        if rep.alive:
            a = rep.engine.page_accounting()
            assert not (a["slot_owned"] or a["slot_shared"]
                        or a["deferred_free"] or a["in_flight"]), a


def test_migration_two_phase_adopt_ledger_and_ship_statuses():
    """export -> begin_adopt (in_flight) -> abort (back to free) ->
    begin_adopt -> commit (cache_idle); the victim's re-prefill hits the
    adopted pages; a duplicate shipment stages nothing; ship_pages
    reports ok and, for a request under one page, nothing."""
    _, (donor, recv, fresh) = engines(3)
    req = TRequest(rid=0, prompt=np.arange(1, 41, dtype=np.int32),
                   max_new_tokens=8)
    donor.submit(req)
    while len(req.out_tokens) < 4:
        donor.step(now=1e18)
    ship = donor.export_request_pages(0)
    assert ship is not None and len(ship["hashes"]) >= 2
    h = recv.begin_adopt(ship)
    assert recv.page_accounting()["in_flight"] == len(ship["hashes"])
    recv.abort_adopt(h)
    free0 = len(recv.pool.free)
    assert recv.page_accounting()["in_flight"] == 0
    h = recv.begin_adopt(ship)
    acc = recv.page_accounting()
    assert acc["in_flight"] == len(ship["hashes"])
    assert acc["total"] == recv.n_pages - 1
    n = recv.commit_adopt(h)
    acc = recv.page_accounting()
    assert n == len(ship["hashes"]) and acc["in_flight"] == 0
    assert acc["cache_idle"] >= n and len(recv.pool.free) == free0 - n
    hits0 = recv.pool.hits
    full = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])
    re_req = TRequest(rid=1, prompt=full, max_new_tokens=4)
    recv.run([re_req])
    assert recv.pool.hits - hits0 >= n
    assert recv.adopt_pages(donor.export_request_pages(0)) == 0
    assert ship_pages(donor, recv, 0)["status"] == "rejected"  # all cached
    res = ship_pages(donor, fresh, 0)
    assert res["status"] == "ok" and res["pages"] >= 2 and res["bytes"] > 0
    short = TRequest(rid=7, prompt=np.arange(1, 6, dtype=np.int32),
                     max_new_tokens=4)
    donor.submit(short)
    while short.t_first is None:
        donor.step(now=1e18)
    assert ship_pages(donor, recv, 7)["status"] == "nothing"


def _warm_engine1(jr, tr):
    prefix = np.arange(1, 33, dtype=np.int32)           # 2 full pages
    for router, cls in ((jr, JRequest), (tr, TRequest)):
        warm = cls(rid=50, prompt=np.concatenate(
            [prefix, np.asarray([7, 8, 9], np.int32)]), max_new_tokens=2)
        router.replicas[1].engine.run([warm])
    return prefix


def test_placement_cache_gravity_and_load_spread():
    """Empty fleet: tie to engine 0, then load spreads to engine 1; a
    warm prefix on engine 1 attracts the matching request."""
    jr, tr = routers()
    prefix = _warm_engine1(jr, tr)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, 40).astype(np.int32) for _ in range(2)]
    prompts.append(np.concatenate([prefix, np.asarray([4, 5], np.int32)]))
    for router, cls in ((jr, JRequest), (tr, TRequest)):
        for rid, p in enumerate(prompts):
            router.submit(cls(rid=rid, prompt=p.copy(), max_new_tokens=4),
                          now=1e18)
    assert owners(tr) == owners(jr) == {0: 0, 1: 1, 2: 1}
    lockstep(jr, tr)


def test_session_affinity_and_tight_deadline():
    """A session sticks to its replica against the load; a TTFT-tight
    request ignores every gravity term and goes least-loaded."""
    jr, tr = routers()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 256, 30).astype(np.int32) for _ in range(3)]
    for router, cls in ((jr, JRequest), (tr, TRequest)):
        for rid, p in enumerate(prompts[:2]):
            router.submit(cls(rid=rid, prompt=p.copy(), max_new_tokens=4,
                              session="s1"), now=1e18)
        router.submit(cls(rid=2, prompt=prompts[2].copy(), max_new_tokens=4,
                          session="s1", deadline_ttft=0.2), now=0.0)
    assert owners(tr) == owners(jr) == {0: 0, 1: 0, 2: 1}
    lockstep(jr, tr)


def test_shed_never_accepted_lowest_priority_first():
    """A death under serving_fleet_shed_backlog sheds only never-accepted
    requests, lowest priority first; the accepted stream completes."""
    jr, tr = routers(shed_backlog=0.1)
    rng = np.random.RandomState(2)
    queued = [rng.randint(1, 256, 30).astype(np.int32) for _ in range(6)]
    reqs = {}
    for router, cls in ((jr, JRequest), (tr, TRequest)):
        active = cls(rid=0, prompt=np.arange(1, 41, dtype=np.int32),
                     max_new_tokens=6)
        router.submit(active, now=1e18)
        while not active.out_tokens:
            router.step(now=1e18)
        q = [cls(rid=10 + i, prompt=p.copy(), max_new_tokens=8,
                 arrival=1e17, priority=prio)
             for i, (p, prio) in enumerate(zip(queued, (0, 0, 1, 1, 2, 2)))]
        for r in q:
            router.submit(r, now=0.0)
        router.kill_engine(router._owner[0].engine.engine_id, now=0.0)
        reqs[router is tr] = [active] + q
    assert [r.aborted for r in reqs[True]] == [r.aborted for r in reqs[False]]
    shed = [r for r in reqs[True] if r.aborted]
    kept = [r for r in reqs[True][1:] if not r.aborted]
    assert shed and tr.stats["n_shed"] == jr.stats["n_shed"] > 0
    assert max(r.priority for r in shed) <= min(
        [r.priority for r in kept] or [2])
    for r in kept:
        jr.abort(r.rid)
        tr.abort(r.rid)
    lockstep(jr, tr)
    assert_same_fleet(jr, tr, reqs[False], reqs[True])
    assert len(reqs[True][0].out_tokens) == 6


def test_retry_exhaustion_when_every_replica_is_dead():
    """No live replica: a submission backs off, exhausts
    serving_fleet_retry_max and drops, in both fleets alike."""
    jr, tr = routers(retry_max=2, retry_base_delay=0.0)
    for router in (jr, tr):
        router.kill_engine(0, now=0.0)
        router.kill_engine(1, now=0.0)
    jreqs, treqs = requests(seed=3, n=1, max_new=4)
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    assert_same_fleet(jr, tr, jreqs, treqs)
    assert treqs[0].aborted and tr.stats["n_retry_exhausted"] == 1
    assert tr.fleet_stats()["fleet_n_alive"] == 0


def test_fleet_built_from_cfg_shares_one_params_dict():
    """FleetRouter(cfg, n_engines=, engine_kwargs=) builds replicas that
    share the first engine's params dict, on the device the kwargs name,
    with engine ids 0..n-1; add_engine joins on the same dict and
    device."""
    r = TRouter(TCFG["float32"], n_engines=3, seed=0,
                engine_kwargs=dict(EKW, device="cpu"))
    es = [rep.engine for rep in r.replicas]
    assert [e.engine_id for e in es] == [0, 1, 2]
    assert all(e.params is es[0].params for e in es)
    assert all(e.device.type == "cpu" for e in es)
    eid = r.add_engine(engine_kwargs=EKW)
    assert eid == 3 and r.replicas[3].engine.params is es[0].params
    assert r.replicas[3].engine.device.type == "cpu"


def test_zero_downtime_flags_defined_and_honoured():
    """The zero-downtime flags carry the reference's defaults and are
    honoured: the router takes autoscale and SLO shed, from its
    arguments or from the flags, and rollout() runs (its cases are
    tests/test_torch_rollout.py's). Nothing is refused any more."""
    defaults = {"serving_fleet_rollout_canary": 4,
                "serving_fleet_autoscale": False,
                "serving_fleet_min_engines": 1,
                "serving_fleet_max_engines": 4,
                "serving_fleet_scale_high": 0.85,
                "serving_fleet_scale_low": 0.2,
                "serving_fleet_scale_ewma": 0.3,
                "serving_fleet_scale_cooldown": 1.0,
                "serving_fleet_slo_shed": False,
                "serving_fleet_slo_rate": 0.0}
    for k, v in defaults.items():
        assert TFLAGS.get(k) == v, k
    _, te = engines()
    for kw in (dict(autoscale=True), dict(slo_shed=True)):
        r = TRouter(engines=te, **kw)
        assert all(getattr(r, k) is True for k in kw)
    try:
        TFLAGS.set("serving_fleet_autoscale", True)
        assert TRouter(engines=te).autoscale is True
    finally:
        TFLAGS.set("serving_fleet_autoscale", False)
    r = TRouter(engines=te)
    assert (r.rollout_canary, r.min_engines, r.max_engines) == (4, 1, 4)
    assert r.rollout(params=te[0].params) in r.catalog
    assert r.rollout_active


def test_fleet_flag_defaults_equal_the_reference():
    """Every serving_fleet_*, serving_disagg_*, serving_wire_overlap and
    obs_* flag the reference defines, with its default."""
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS

    names = [n for n in JFLAGS._flags
             if n.startswith(("serving_fleet_", "serving_disagg_", "obs_"))
             or n == "serving_wire_overlap"]
    assert len([n for n in names if n.startswith("serving_fleet_")]) == 19
    assert len([n for n in names if n.startswith("serving_disagg_")]) == 5
    for n in names:
        jv, tv = JFLAGS.get(n), TFLAGS.get(n)
        if n == "obs_dir":
            continue              # the tests point both at tmp_path
        assert tv == jv and type(tv) is type(jv), n


def test_chaos_ctx_selector_and_per_ctx_counters():
    """A spec with engine=0 fires only for ctx engine=0, at=N counts
    that ctx's own invocations, and a pool-scoped spec never matches a
    probe that reports no pool."""
    tchaos.arm(tchaos.FaultPlan(seed=0)
               .add("engine.step", "raise", at=1, engine=0)
               .add("migration.commit", "raise", once=False,
                    pool="decode"))
    for _ in range(5):
        assert tchaos.fire("engine.step", ctx={"engine": 1}) is None
    assert tchaos.fire("engine.step", ctx={"engine": 0}) is None
    spec = tchaos.fire("engine.step", ctx={"engine": 0})
    assert spec is not None and spec.kind == "raise"
    assert tchaos.fire("engine.step", ctx={"engine": 0}) is None
    assert tchaos.fire("migration.commit", ctx={"engine": 0}) is None
    assert tchaos.fire("migration.commit",
                       ctx={"engine": 0, "pool": "decode"}) is not None
    plan = tchaos.FaultPlan.from_json(
        tchaos.FaultPlan(seed=3).add("pool.alloc", "fail", at=2).to_json())
    assert plan.seed == 3 and plan.faults[0].at == 2
    assert list(plan.to_env()) == ["PT_CHAOS_PLAN"]


def test_disarmed_probes_never_reach_chaos_fire(monkeypatch):
    """Disarmed, every serving probe is one global load: fire() is never
    called on an engine's path or a fleet's."""
    assert not tchaos.active()

    def boom(*a, **k):
        raise AssertionError("disarmed probe called chaos.fire")

    monkeypatch.setattr(tchaos, "fire", boom)
    jr, tr = routers(disagg_prefill=1)
    jreqs, treqs = requests(seed=4, n=2, max_new=4)
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    assert all(len(r.out_tokens) == 4 for r in treqs)
    assert tr.stats["n_handoffs"] > 0


def test_obs_armed_traces_a_death_without_changing_streams(tmp_path):
    """With the observability plane armed the kill run's streams are
    unchanged, the trace holds the engine spans, lifecycle flow and the
    fired chaos fault, and the death leaves a flight-recorder dump in
    obs_dir."""
    from paddle_tpu_torch import obs

    obs.arm()
    try:
        _kill_run()
        doc = obs.export()
        dumps = list(obs._armed.dumps)
    finally:
        obs.disarm()
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"engine.step", "fleet.death", "fleet.migrate",
            "chaos.engine.step", "req"} <= names
    assert dumps and all(str(tmp_path) in p for p in dumps)
    assert not obs.active()
