"""The port's zero-downtime fleet operations against the JAX package's on
the CPU: every case of tests/test_rollout.py (content-hash dedup, a clean
rollout mid-decode, a mid-swap raise, a mid-swap hang past the step
budget, a canary failure and its rollback, argument validation,
``add_engine`` on a chosen side, autoscale up then retire, autoscale
bounds, SLO shed, and everything dormant with the flags off) runs through
both routers in lockstep, on the same weights, requests and chaos plan.
After every tick the streams, owners, ``fleet_stats()`` (wall-clock keys
aside), ``health()`` and ``page_accounting()`` are equal. The port's own
properties, as the reference's test holds its own: every stream equals a
lone port engine's run on the weight version it was pinned to, the fleet
converges to one version, and the 7-class ledger sums on every tick.
Also: ``WeightCatalog`` ids equal across the packages (fp32, bf16 and
weight-only int8 trees) and ``FleetDriver.run(deploys=...)``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.fleet import WeightCatalog as JCatalog
from paddle_tpu.inference.loadgen import FleetDriver as JDriver
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models.llama import quantize_weights_int8 as jquant
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.inference.fleet import WeightCatalog as TCatalog
from paddle_tpu_torch.inference.loadgen import FleetDriver as TDriver
from paddle_tpu_torch.inference.serving import Request as TRequest
from paddle_tpu_torch.inference.serving import ServingEngine as TEngine
from paddle_tpu_torch.utils.convert import params_from_jax

from torch_fleet_common import (EKW, TCFG, TIMING_KEYS, arm,
                                assert_port_ledger, assert_same_fleet,
                                health, isolate, lockstep, owners,
                                requests, routers, submit, weights)

__all__ = ["isolate"]


@functools.lru_cache(maxsize=None)
def _v2():
    """A distinct but servable v2, as the reference's ``_perturb``: every
    leaf x 1.001 in numpy, dtypes kept; (JAX tree, the port's tree)."""
    jp, _ = weights()
    jv2 = jax.tree_util.tree_map(
        lambda w: (np.asarray(w) * 1.001).astype(np.asarray(w).dtype), jp)
    return jv2, params_from_jax(jv2, "cpu")


def _stats(router) -> dict:
    return {k: v for k, v in router.fleet_stats().items()
            if k not in TIMING_KEYS}


def _checker(jr, tr, jreqs, treqs):
    """The per-tick comparison: streams, owners, fleet_stats(), health()
    (page_accounting() and owners are lockstep's own)."""
    def check(n):
        for a, b in zip(jreqs, treqs):
            assert a.out_tokens == b.out_tokens, (n, a.rid)
            assert a.param_version == b.param_version, (n, a.rid)
        assert owners(tr) == owners(jr), n
        assert _stats(tr) == _stats(jr), n
        assert health(tr) == health(jr), n
    return check


def _run(jr, tr, jreqs, treqs, now: float = 1e18) -> int:
    return lockstep(jr, tr, now=now,
                    each_tick=_checker(jr, tr, jreqs, treqs))


def _until_mid_decode(jr, tr, jreqs, treqs, limit: int = 200) -> None:
    """Tick both fleets in lockstep until some stream is mid-decode."""
    check = _checker(jr, tr, jreqs, treqs)
    for n in range(limit):
        assert jr.step(now=1e18) == tr.step(now=1e18), n
        assert tr.page_accounting() == jr.page_accounting(), n
        check(n)
        if any(r is not None and 0 < len(r.out_tokens) < r.max_new_tokens
               for rep in tr.replicas for r in rep.engine.slots):
            return
    raise AssertionError("no mid-decode stream appeared")


@functools.lru_cache(maxsize=None)
def _solo(version_tree: int, prompt: bytes, max_new: int,
          temperature: float, top_p: float, seed: int) -> tuple:
    tp = weights()[1] if version_tree == 1 else _v2()[1]
    eng = TEngine(TCFG["float32"], params=tp, device="cpu", **EKW)
    ref = TRequest(rid=1000, prompt=np.frombuffer(prompt, np.int32).copy(),
                   max_new_tokens=max_new, temperature=temperature,
                   top_p=top_p, seed=seed)
    eng.run([ref])
    return tuple(ref.out_tokens)


def _assert_pinned_streams(tr, treqs) -> None:
    """Every stream finished and equals a lone port engine's run on the
    weights of the version it was pinned to."""
    v1 = TCatalog().put(weights()[1])
    for r in treqs:
        assert not r.aborted and len(r.out_tokens) == r.max_new_tokens, \
            (r.rid, r.aborted, len(r.out_tokens))
        assert r.param_version is not None, r.rid
        assert r.param_version in tr.catalog
        which = 1 if r.param_version == v1 else 2
        assert list(_solo(which, np.asarray(r.prompt, np.int32).tobytes(),
                          r.max_new_tokens, r.temperature, r.top_p,
                          r.seed)) == r.out_tokens, r.rid


# -- weight catalog ---------------------------------------------------------

def test_weight_catalog_content_hash_dedup():
    """The same bytes twice give one version id, other bytes another,
    both retrievable; the ids are the reference's for the same leaves."""
    p1 = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "b": (torch.ones(3), torch.zeros(3, dtype=torch.int8))}
    cat = TCatalog()
    v1 = cat.put(p1)
    assert cat.put({k: p1[k] for k in p1}) == v1
    p2 = {"w": p1["w"] * 2, "b": p1["b"]}
    v2 = cat.put(p2)
    assert v2 != v1
    assert cat.versions() == sorted([v1, v2])
    assert cat.get(v1) is p1 and v1 in cat
    jcat = JCatalog()
    for p, v in ((p1, v1), (p2, v2)):
        jp = {"w": p["w"].numpy(), "b": tuple(x.numpy() for x in p["b"])}
        assert jcat.put(jp) == v


def test_weight_catalog_rehashes_a_changed_tree():
    """A tree put again is not hashed again while its tensors are the
    same objects and none was written in place; a write in place, or a
    leaf replaced, is hashed anew and gets the id of its new bytes."""
    p = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": (torch.ones(3), torch.zeros(3, dtype=torch.int8))}
    cat = TCatalog()
    v0 = cat.put(p)
    assert cat.put(p) == v0
    p["w"].add_(1.0)                      # in place: same object
    v1 = cat.put(p)
    assert v1 != v0 and v1 == TCatalog().put(p)
    p["b"] = (torch.ones(3), torch.ones(3, dtype=torch.int8))
    v2 = cat.put(p)
    assert v2 not in (v0, v1) and v2 == TCatalog().put(p)
    p["w"].sub_(1.0)
    p["b"] = (torch.ones(3), torch.zeros(3, dtype=torch.int8))
    assert cat.put(p) == v0


@pytest.mark.parametrize("tree", ["float32", "bfloat16", "int8"])
def test_weight_catalog_ids_equal_the_reference(tree):
    """LLaMA's parameter tree in fp32, in bf16 (hashed as ``bfloat16``
    over its 16-bit patterns) and weight-only int8 (``(int8, scales)``
    tuples, both legs): the port's version id is JAX's."""
    jp, _ = weights()
    if tree == "bfloat16":
        jp = jax.tree_util.tree_map(lambda w: w.astype(jnp.bfloat16), jp)
    elif tree == "int8":
        jp = jquant(jp)
        assert isinstance(jp["blocks"]["wq"], tuple)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    if tree == "bfloat16":
        assert tp["wte"].dtype == torch.bfloat16
    assert TCatalog().put(tp) == JCatalog().put(jp)


# -- rolling upgrade --------------------------------------------------------

def test_clean_rollout_mid_decode_converges_and_streams_bit_identical():
    """A clean deploy started mid-decode: both fleets agree on every
    tick, every stream completes on its pinned version, and the fleet
    ends with every live engine on the target."""
    jr, tr = routers(retry_base_delay=0.0)
    jreqs, treqs = requests(seed=0, n=5, sampled=(2,))
    submit(jr, tr, jreqs, treqs)
    _until_mid_decode(jr, tr, jreqs, treqs)
    jv2, tv2 = _v2()
    v2 = tr.rollout(params=tv2)
    assert jr.rollout(params=jv2) == v2
    _run(jr, tr, jreqs, treqs)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["fleet_versions"] == [v2]
    assert st["n_rollouts"] == 1 and st["n_rollback"] == 0
    assert st["rollout_stall_ms"] > 0.0
    _assert_pinned_streams(tr, treqs)


def test_midswap_chaos_raise_replaced_on_target_bit_identical():
    """``rollout.swap`` raises on engine 0: the corpse is declared dead
    and a fresh engine joins on the target; the rollout converges, and
    every stream (greedy and sampled) completes on its pinned version."""
    arm(("rollout.swap", "raise", dict(at=0, engine=0)))
    jr, tr = routers(retry_base_delay=0.0)
    jreqs, treqs = requests(seed=1, n=5, sampled=(1, 3))
    submit(jr, tr, jreqs, treqs)
    _until_mid_decode(jr, tr, jreqs, treqs)
    jv2, tv2 = _v2()
    v2 = tr.rollout(params=tv2)
    jr.rollout(params=jv2)
    _run(jr, tr, jreqs, treqs)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_swap_deaths"] == 1 and st["n_killed"] == 1
    assert st["fleet_versions"] == [v2] and st["n_rollback"] == 0
    _assert_pinned_streams(tr, treqs)
    assert_port_ledger(tr)


def test_midswap_chaos_hang_past_step_budget_is_a_death():
    """A swap that hangs past the step budget is a mid-swap death too:
    replaced on the target, streams unchanged. The budget (3 s) and the
    hang (4 s) are wide of a CPU step of this model under a loaded test
    run, where the reference test's 0.5 s budget let a plain step of one
    package overrun it."""
    jr, tr = routers(step_budget=3.0, retry_base_delay=0.0)
    # pay JAX's compile outside the watched window, in both fleets alike
    for router, cls in ((jr, JRequest), (tr, TRequest)):
        for i, rep in enumerate(router.replicas):
            rep.engine.run([cls(rid=-1 - i, prompt=np.ones(40, np.int32),
                                max_new_tokens=2, arrival=0.0)])
    arm(("rollout.swap", "hang", dict(at=0, engine=0, seconds=4.0)))
    jreqs, treqs = requests(seed=2, n=4, sampled=(2,))
    submit(jr, tr, jreqs, treqs)
    _until_mid_decode(jr, tr, jreqs, treqs)
    jv2, tv2 = _v2()
    v2 = tr.rollout(params=tv2)
    jr.rollout(params=jv2)
    _run(jr, tr, jreqs, treqs)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_swap_deaths"] == 1
    assert "budget" in next(r for r in tr.replicas
                            if not r.alive).last_error
    assert st["fleet_versions"] == [v2]
    _assert_pinned_streams(tr, treqs)


def test_canary_failure_rolls_the_fleet_back():
    """``rollout.canary`` fails on engine 0: it swaps straight back, the
    fleet retargets the prior version, and converges to the original
    version with nobody dead."""
    arm(("rollout.canary", "fail", dict(at=0, engine=0)))
    jr, tr = routers(retry_base_delay=0.0)
    v1 = tr.catalog.put(weights()[1])
    assert jr.catalog.put(weights()[0]) == v1
    jreqs, treqs = requests(seed=3, n=4, sampled=(0,))
    submit(jr, tr, jreqs, treqs)
    _until_mid_decode(jr, tr, jreqs, treqs)
    jv2, tv2 = _v2()
    v2 = tr.rollout(params=tv2)
    jr.rollout(params=jv2)
    assert v2 != v1
    _run(jr, tr, jreqs, treqs)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["fleet_versions"] == [v1]
    assert st["n_canary_fail"] == 1 and st["n_rollback"] == 1
    assert all(rep.alive for rep in tr.replicas)
    _assert_pinned_streams(tr, treqs)


def test_swapped_engine_never_serves_pages_of_the_old_weights():
    """A reference defect the port does not reproduce: its prefix cache is
    salted by adapter only, so after a swap an engine serves a request
    whose prompt shares a prefix with one served before the swap from KV
    pages of the OLD weights. The port salts the cache with the engine's
    weight version: after a rollout to independent weights, requests
    sharing the earlier requests' two-page prefix hit no page in the
    port and equal a lone engine's run on the new weights, where the
    reference's engines hit the stale pages (ROADMAP Queue 3)."""
    from paddle_tpu.models.llama import init_llama_params as jax_init

    from torch_fleet_common import JCFG

    jv2 = jax_init(JCFG["float32"], jax.random.PRNGKey(1))
    tv2 = params_from_jax(jax.tree.map(np.asarray, jv2), "cpu")
    jr, tr = routers(retry_base_delay=0.0)
    rng = np.random.RandomState(9)
    prefix = rng.randint(1, 256, size=32).astype(np.int32)    # 2 pages

    def reqs(cls, first, seed):
        tails = np.random.RandomState(seed)
        return [cls(rid=first + i, prompt=np.concatenate(
            [prefix, tails.randint(1, 256, size=8 + i).astype(np.int32)]),
            max_new_tokens=8) for i in range(2)]

    ja, ta = reqs(JRequest, 0, 10), reqs(TRequest, 0, 10)
    submit(jr, tr, ja, ta)
    _run(jr, tr, ja, ta)
    v2 = tr.rollout(params=tv2)
    assert jr.rollout(params=jv2) == v2
    _run(jr, tr, [], [])
    assert tr.fleet_stats()["fleet_versions"] == [v2]
    hits = [sum(rep.engine.pool.hits for rep in r.replicas)
            for r in (jr, tr)]
    jb, tb = reqs(JRequest, 10, 11), reqs(TRequest, 10, 11)
    for router, rs in ((jr, jb), (tr, tb)):
        for r in rs:
            router.submit(r, now=1e18)
        while router.step(now=1e18):
            pass
    stale = sum(rep.engine.pool.hits for rep in jr.replicas) - hits[0]
    assert stale >= 2                  # the reference hit old-weight pages
    assert sum(rep.engine.pool.hits for rep in tr.replicas) == hits[1]
    solo = TEngine(TCFG["float32"], params=tv2, device="cpu", **EKW)
    for r in tb:
        assert r.param_version == v2
        ref = TRequest(rid=100 + r.rid, prompt=r.prompt.copy(),
                       max_new_tokens=r.max_new_tokens)
        solo.run([ref])
        assert ref.out_tokens == r.out_tokens, r.rid
    assert_port_ledger(tr)


def test_rollout_argument_validation():
    """The reference's refusals, with its exception types."""
    jr, tr = routers()
    for router in (jr, tr):
        with pytest.raises(ValueError):
            router.rollout()
        with pytest.raises(ValueError):
            router.rollout(version="no-such-hash")
    tr.rollout(params=_v2()[1])
    jr.rollout(params=_v2()[0])
    for router in (jr, tr):
        with pytest.raises(RuntimeError):
            router.rollout(version=router._rollout.target)
    assert _stats(tr) == _stats(jr)


def test_add_engine_explicit_params_version_both_sides():
    """During a rollout a joiner lands on either side through ``params=``
    / ``version=``; one with neither takes replica 0's version. The v1
    joiner is upgraded by the same rollout."""
    jr, tr = routers(retry_base_delay=0.0)
    jv2, tv2 = _v2()
    v2 = tr.rollout(params=tv2)
    jr.rollout(params=jv2)
    v1 = tr._rollout.prior
    assert jr._rollout.prior == v1
    eids = []
    for router, p2 in ((jr, jv2), (tr, tv2)):
        eid_old = router.add_engine(params=router.catalog.get(v1),
                                    version=v1)
        eid_new = router.add_engine(params=p2, version=v2)
        eid_def = router.add_engine()
        by_eid = {r.engine.engine_id: r.engine for r in router.replicas}
        assert by_eid[eid_old].param_version == v1
        assert by_eid[eid_new].param_version == v2
        assert by_eid[eid_new].params is p2
        assert (by_eid[eid_def].param_version
                == router.replicas[0].engine.param_version)
        eids.append((eid_old, eid_new, eid_def))
    assert eids[0] == eids[1]
    assert health(tr) == health(jr)
    _run(jr, tr, [], [])
    assert tr.fleet_stats()["fleet_versions"] == [v2]
    assert _stats(tr) == _stats(jr)


# -- demand-driven autoscale ------------------------------------------------

def test_autoscale_up_then_retire_never_drops_requests():
    """Census utilization above the high watermark adds an engine; once
    the burst drains, engines retire by drain-then-remove down to
    ``min_engines``; no request is dropped."""
    kw = dict(autoscale=True, min_engines=1, max_engines=3,
              scale_high=0.5, scale_low=0.1, scale_ewma=1.0,
              scale_cooldown=0.0, retry_base_delay=0.0)
    jr, tr = routers(**kw)
    jreqs, treqs = requests(seed=4, n=12, max_new=8)
    submit(jr, tr, jreqs, treqs)
    check = _checker(jr, tr, jreqs, treqs)
    _run(jr, tr, jreqs, treqs)
    for n in range(12):
        assert jr.step(now=1e18) == tr.step(now=1e18), n
        assert tr.page_accounting() == jr.page_accounting(), n
        check(n)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_scale_up"] >= 1 and st["autoscale_n_engines_max"] == 3
    assert st["n_scale_down"] >= 1
    assert sum(1 for rep in tr.replicas if rep.alive) == 1
    assert all(not r.aborted and len(r.out_tokens) == r.max_new_tokens
               for r in treqs)
    assert_port_ledger(tr)


def test_autoscale_bounds_respected_when_idle():
    """An idle fleet never scales below ``min_engines``."""
    kw = dict(autoscale=True, min_engines=2, max_engines=3, scale_low=0.9,
              scale_ewma=1.0, scale_cooldown=0.0, retry_base_delay=0.0)
    jr, tr = routers(**kw)
    jreqs, treqs = [[cls(rid=0, prompt=np.arange(1, 30, dtype=np.int32),
                         max_new_tokens=4, arrival=0.0)]
                    for cls in (JRequest, TRequest)]
    submit(jr, tr, jreqs, treqs)
    _run(jr, tr, jreqs, treqs)
    check = _checker(jr, tr, jreqs, treqs)
    for n in range(8):
        assert jr.step(now=1e18) == tr.step(now=1e18), n
        check(n)
    st = tr.fleet_stats()
    assert st["n_scale_down"] == 0
    assert sum(1 for rep in tr.replicas if rep.alive) == 2
    assert _stats(tr) == _stats(jr)


# -- SLO-aware admission shed -----------------------------------------------

def test_slo_shed_drops_only_never_accepted_predicted_misses():
    """With a pinned rate prior, queued never-accepted requests whose
    predicted wait exceeds their remaining TTFT budget shed at once;
    requests without a TTFT deadline are never shed."""
    jr, tr = routers(slo_shed=True, slo_rate=1.0, retry_base_delay=0.0)
    jsafe, tsafe = requests(seed=5, n=4, max_new=8)
    jdoom, tdoom = [[cls(rid=100 + i, prompt=np.arange(1, 25,
                                                       dtype=np.int32),
                         max_new_tokens=8, arrival=0.0, deadline_ttft=0.5)
                     for i in range(3)] for cls in (JRequest, TRequest)]
    submit(jr, tr, jsafe + jdoom, tsafe + tdoom, now=0.0)
    _run(jr, tr, jsafe + jdoom, tsafe + tdoom, now=0.0)
    assert_same_fleet(jr, tr, jsafe + jdoom, tsafe + tdoom)
    st = tr.fleet_stats()
    assert st["n_slo_shed"] == 3
    assert all(d.aborted and not d.out_tokens for d in tdoom)
    assert all(not r.aborted and len(r.out_tokens) == r.max_new_tokens
               for r in tsafe)
    assert_port_ledger(tr)


def test_slo_shed_measured_rate_ewma_in_lockstep():
    """With no rate prior the predictor is the measured throughput EWMA,
    read on the driver clock: both routers see the same ticks, so they
    measure the same rate and shed the same requests."""
    jr, tr = routers(slo_shed=True, retry_base_delay=0.0)
    jreqs, treqs = requests(seed=7, n=6, max_new=6, deadline_ttft=3.0)
    submit(jr, tr, jreqs, treqs, now=0.0)
    check = _checker(jr, tr, jreqs, treqs)
    for n in range(400):
        bj, bt = jr.step(now=0.5 * n), tr.step(now=0.5 * n)
        assert bj == bt, n
        assert tr.page_accounting() == jr.page_accounting(), n
        check(n)
        assert tr._rate_ewma == jr._rate_ewma, n
        if not bt:
            break
    assert tr._rate_ewma is not None
    assert_same_fleet(jr, tr, jreqs, treqs)


# -- flags off = pinned single-version fleet --------------------------------

def test_flags_off_rollout_machinery_fully_dormant():
    """Every operations flag defaults off (with the reference's knob
    defaults): a plain router never pins a version and never enters the
    rollout, autoscale or shed paths; streams equal the reference's."""
    assert TFLAGS.get("serving_fleet_autoscale") is False
    assert TFLAGS.get("serving_fleet_slo_shed") is False
    assert float(TFLAGS.get("serving_fleet_slo_rate")) == 0.0
    assert int(TFLAGS.get("serving_fleet_rollout_canary")) == 4
    assert int(TFLAGS.get("serving_fleet_min_engines")) == 1
    assert int(TFLAGS.get("serving_fleet_max_engines")) == 4
    assert float(TFLAGS.get("serving_fleet_scale_high")) == 0.85
    assert float(TFLAGS.get("serving_fleet_scale_low")) == 0.2
    assert float(TFLAGS.get("serving_fleet_scale_ewma")) == 0.3
    assert float(TFLAGS.get("serving_fleet_scale_cooldown")) == 1.0
    jr, tr = routers()
    assert not tr.autoscale and not tr.slo_shed and not tr.rollout_active
    jreqs, treqs = requests(seed=6, n=4, sampled=(3,))
    submit(jr, tr, jreqs, treqs)
    _run(jr, tr, jreqs, treqs)
    assert_same_fleet(jr, tr, jreqs, treqs)
    st = tr.fleet_stats()
    assert st["n_rollouts"] == 0 and st["n_slo_shed"] == 0
    assert st["n_scale_up"] == 0 and st["n_scale_down"] == 0
    assert st["fleet_versions"] == []
    assert all(r.param_version is None for r in treqs)


# -- the load generator fires a deploy mid-run ------------------------------

def test_fleet_driver_deploys_mid_run():
    """``FleetDriver.run(deploys=...)`` on the rush clock: a params tree
    fires a rollout once its threshold passes, and the traffic is
    measured through it; a second deploy, a version string, waits while
    that rollout is in flight (it ends with the traffic here, so the
    second never fires: one rollout at a time). A version string alone
    deploys a published version. Both packages' drivers give the same
    streams, steps and counters."""
    jv2, tv2 = _v2()
    for deploy_v2_by_id in (False, True):
        out = []
        for i, v2p in ((0, jv2), (1, tv2)):
            router = routers(retry_base_delay=0.0)[i]
            v1 = router.catalog.put(router.replicas[0].engine.params)
            v2 = router.catalog.put(v2p)
            reqs = requests(seed=8, n=6, max_new=10, sampled=(1,))[i]
            drv = (JDriver, TDriver)[i](router, clock="rush")
            res = drv.run(reqs, deploys={2: v2 if deploy_v2_by_id else v2p,
                                         3: v1})
            out.append((router, reqs, res))
        (jr, jreqs, jres), (tr, treqs, tres) = out
        assert_same_fleet(jr, tr, jreqs, treqs)
        assert jres["steps"] == tres["steps"]
        st = tr.fleet_stats()
        assert st["n_rollouts"] == 1 and st["fleet_versions"] == [v2]
        assert {r.param_version for r in treqs} == {v1, v2}
        assert all(not r.aborted and len(r.out_tokens) == r.max_new_tokens
                   for r in treqs)
        _assert_pinned_streams(tr, treqs)
