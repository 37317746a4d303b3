"""The port's disaggregated prefill / decode pools against the JAX
package's on the CPU: the same weights, requests and chaos plans through
both fleets in lockstep, streams exact, owners, counters and per-tick
page ledgers equal, for the static split, the loss of the whole prefill
pool (degraded colocated serving, then a re-split when a prefill engine
joins), ship retries and deadlines falling back to colocated serving, a
donor dying with shipments in its outbox, and the measured-load dynamic
split and its static pin (tests/test_disagg.py and
tests/test_disagg_wire.py hold the reference to the same cases). Every
stream also equals a lone port engine's."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu_torch.inference.serving import Request as TRequest

from torch_fleet_common import (EKW, JRouter, TRouter, arm,
                                assert_port_ledger, assert_same_fleet,
                                disarm, engines, isolate, lockstep, requests,
                                routers, settle, solo_port, submit)

__all__ = ["isolate"]


def _check(jr, tr, jreqs, treqs):
    assert_same_fleet(jr, tr, jreqs, treqs)
    for r in treqs:
        assert not r.aborted and len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == solo_port(r), r.rid
    settle(tr)
    assert_port_ledger(tr)


@pytest.mark.parametrize("overlap", [False, True])
def test_static_split_ships_pages_and_matches_reference(overlap):
    """1 prefill + 1 decode: the prefill engine emits the first token,
    ships the prompt's full pages (staged on the overlapped wire) and
    releases the slot; the decode engine adopts them and decodes the
    rest. Slots and outboxes end empty on both sides."""
    jr, tr = routers(disagg_prefill=1, engine_kw=dict(wire_overlap=overlap))
    assert [rep.role for rep in tr.replicas] == ["prefill", "decode"]
    jreqs, treqs = requests(seed=3, n=4, sampled=(1, 3))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    _check(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["disagg_shipped_pages"] >= 4 and st["n_handoffs"] == 4
    assert st["degraded_steps"] == 0
    pre, dec = (rep.engine for rep in tr.replicas)
    assert pre.stats["decode_steps"] == 0 and dec.stats["decode_steps"] > 0
    for e in (pre, dec):
        assert all(s is None for s in e.slots) and not e.outbox
        assert not e._commit_pending


def test_prefill_pool_loss_degrades_then_resplits():
    """2 prefill + 2 decode: once a page has shipped, a pool-scoped chaos
    spec kills the whole prefill pool; both fleets go degraded colocated
    and finish every stream. A joined prefill engine re-splits them and
    the next request ships again."""
    jr, tr = routers(n=4, disagg_prefill=2)
    jreqs, treqs = requests(seed=7, n=6, max_new=8, sampled=(1, 3, 5))
    submit(jr, tr, jreqs, treqs)
    armed = []

    def on_step(n, router):
        if (router is tr and not armed
                and tr.stats["disagg_shipped_pages"] >= 1):
            arm(("engine.step", "raise", dict(once=False, pool="prefill")))
            armed.append(n)

    lockstep(jr, tr, on_step)
    assert armed
    _check(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["fleet_n_prefill"] == 0 and st["n_killed"] == 2
    assert tr.degraded and st["degraded_steps"] >= 1
    disarm()
    for router in (jr, tr):
        router.add_engine(role="prefill", engine_kwargs=EKW)
        router.step(now=1e18)
        assert not router.degraded and router.stats["n_resplit"] == 1
    (j2,), (t2,) = requests(seed=8, n=1, max_new=6)
    shipped0 = tr.stats["disagg_shipped_pages"]
    submit(jr, tr, [j2], [t2])
    lockstep(jr, tr)
    assert tr.stats["disagg_shipped_pages"] > shipped0
    _check(jr, tr, jreqs + [j2], treqs + [t2])


@pytest.mark.parametrize("case", ["retries", "deadline"])
def test_ship_exhaustion_falls_back_to_colocated(case):
    """Every shipment dropped (retries run out) or stalled past the
    per-shipment deadline: the request is delivered colocated, the fleet
    degrades and re-splits once the ship queue is empty."""
    if case == "retries":
        arm(("migration.ship", "drop", dict(once=False)))
        kw = dict(retry_max=2, retry_base_delay=0.0)
    else:
        arm(("migration.ship", "stall", dict(once=False, seconds=0.05)))
        kw = dict(retry_max=2, retry_base_delay=0.0, ship_deadline=0.01)
    jr, tr = routers(disagg_prefill=1, **kw)
    jreqs, treqs = requests(seed=9, n=3, max_new=6, sampled=(2,))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    _check(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_retry_exhausted"] >= 1 and st["degraded_steps"] >= 1
    if case == "retries":
        assert st["migration_dropped"] >= 1 and st["n_ship_retries"] >= 1
        assert st["n_resplit"] >= 1
    else:
        assert st["n_ship_deadline"] >= 1


def test_donor_death_with_pending_outbox():
    """A prefill engine dies with shipments still in its outbox: the
    payloads die with it, the requests are recovered by re-prefill."""
    jr, tr = routers(disagg_prefill=1)
    jreqs, treqs = requests(seed=21, n=2, max_new=6, sampled=(1,))
    submit(jr, tr, jreqs, treqs)
    for router in (jr, tr):
        pre = router.replicas[0].engine
        steps = 0
        while not pre.outbox:
            if not pre.step(now=1e18):
                router.step(now=1e18)
            steps += 1
            assert steps < 500
        router.kill_engine(0, now=1e18)
    lockstep(jr, tr)
    assert tr.degraded and jr.degraded
    _check(jr, tr, jreqs, treqs)


def _wave(cls, rng_seed, n, plen, max_new, rid0):
    rng = np.random.RandomState(rng_seed)
    return [cls(rid=rid0 + i, prompt=rng.randint(1, 256, size=plen).astype(
        np.int32), max_new_tokens=max_new) for i in range(n)]


def test_dynamic_split_follows_the_measured_load():
    """serving_disagg_dynamic on an unpinned 3-engine fleet: a
    prefill-heavy wave promotes a decode engine, a decode-heavy one
    demotes it back; the trajectories are equal."""
    je, te = engines(3)
    kw = dict(disagg_dynamic=True, dynamic_ewma=0.5, dynamic_hysteresis=0.2,
              retry_max=2, retry_base_delay=0.0)
    jr, tr = JRouter(engines=je, **kw), TRouter(engines=te, **kw)
    assert tr.disagg and not tr._split_pinned
    waves = ((11, 4, 90, 2, 0), (12, 4, 24, 12, 10))
    for i, (seed, n, plen, new, rid0) in enumerate(waves):
        jreqs, treqs = (_wave(c, seed, n, plen, new, rid0)
                        for c in (JRequest, TRequest))
        submit(jr, tr, jreqs, treqs)
        lockstep(jr, tr)
        _check(jr, tr, jreqs, treqs)
        assert tr.fleet_stats()["fleet_n_prefill"] == (2 if i == 0 else 1)
    st = tr.fleet_stats()
    assert st["n_resplit"] >= 2
    assert st["split_trajectory"] == jr.fleet_stats()["split_trajectory"]
    assert max(st["split_trajectory"]) == pytest.approx(2 / 3, abs=1e-3)


def test_static_pin_disables_the_dynamic_controller():
    """An explicit disagg_prefill is a pin: the split never moves."""
    jr, tr = routers(disagg_prefill=1, disagg_dynamic=True,
                     retry_max=2, retry_base_delay=0.0)
    assert tr._split_pinned
    jreqs, treqs = (_wave(c, 13, 3, 90, 2, 0) for c in (JRequest, TRequest))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    _check(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_resplit"] == 0 and st["split_trajectory"] == [0.5]


def test_split_must_leave_a_decode_pool_and_flags_off_is_colocated():
    """A split without a decode engine is refused; with the disagg flags
    off the fleet has no roles and ships nothing."""
    _, te = engines()
    for dp in (2, 3):
        with pytest.raises(ValueError):
            TRouter(engines=te, disagg_prefill=dp)
    jr, tr = routers()
    assert not tr.disagg and all(rep.role is None for rep in tr.replicas)
    jreqs, treqs = requests(seed=17, n=3, max_new=6, sampled=(1,))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    _check(jr, tr, jreqs, treqs)
    assert tr.stats["disagg_shipped_pages"] == 0
