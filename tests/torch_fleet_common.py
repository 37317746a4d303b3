"""Shared by tests/test_torch_{fleet,disagg,wire,loadgen,rollout}.py: the fleet
of the JAX package and the port's side by side on the CPU.

Both packages get the same weights (drawn in JAX, carried over with
``params_from_jax``), the same engine geometry (the reference's fleet
tests' tiny config: vocab 256, hidden 64, 2 layers, 4 heads, 2 kv heads,
ffn 128; max_batch 2, page 16, max_seq 128, 24 pages), the same
requests and the same chaos plan, armed in each package's own chaos
module. ``lockstep`` steps the two routers on one clock and holds their
page ledgers, owners and return values equal after every tick."""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.inference.fleet import FleetRouter as JRouter
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import init_llama_params as jax_init
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.inference.fleet import FleetRouter as TRouter
from paddle_tpu_torch.inference.serving import Request as TRequest
from paddle_tpu_torch.inference.serving import ServingEngine as TEngine
from paddle_tpu_torch.models.llama import LlamaConfig as TConfig
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
             n_kv_heads=2, ffn_hidden=128, max_seq_len=256)
JCFG = {"float32": JConfig(**SHAPE, dtype=jnp.float32,
                           param_dtype=jnp.float32),
        "bfloat16": JConfig(**SHAPE, dtype=jnp.bfloat16,
                            param_dtype=jnp.float32)}
TCFG = {"float32": TConfig(**SHAPE, dtype=torch.float32,
                           param_dtype=torch.float32),
        "bfloat16": TConfig(**SHAPE, dtype=torch.bfloat16,
                            param_dtype=torch.float32)}
EKW = dict(max_batch=2, page_size=16, max_seq=128, n_pages=1 + 24,
           prefill_budget=32)
# wall-clock readings: each package measures its own
TIMING_KEYS = {"wire_adopt_ms", "wire_export_ms", "recovery_ms_max",
               "recovery_ms_mean", "disagg_recovery_ms", "rollout_ms",
               "rollout_stall_ms"}


@functools.lru_cache(maxsize=None)
def weights(dtype: str = "float32"):
    """(JAX params, the port's params) drawn from PRNGKey(0)."""
    jp = jax_init(JCFG[dtype], jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def isolate(tmp_path):
    """Flight-recorder dumps under tmp_path; chaos disarmed afterwards."""
    old = JFLAGS.get("obs_dir"), TFLAGS.get("obs_dir")
    JFLAGS.set("obs_dir", str(tmp_path))
    TFLAGS.set("obs_dir", str(tmp_path))
    yield
    disarm()
    JFLAGS.set("obs_dir", old[0])
    TFLAGS.set("obs_dir", old[1])


def engines(n: int = 2, dtype: str = "float32", per_engine=(), **kw):
    """n engines of each package on shared weights; ``per_engine[i]``
    adds keyword arguments to engine i (e.g. kv_quant)."""
    jp, tp = weights(dtype)
    je, te = [], []
    for i in range(n):
        ekw = {**EKW, **kw, **(per_engine[i] if i < len(per_engine)
                               else {})}
        je.append(JEngine(JCFG[dtype], params=jp, seed=0, engine_id=i,
                          **ekw))
        te.append(TEngine(TCFG[dtype], params=tp, engine_id=i,
                          device="cpu", **ekw))
    return je, te


def routers(n: int = 2, engine_kw=None, per_engine=(), **kw):
    je, te = engines(n, per_engine=per_engine, **(engine_kw or {}))
    return JRouter(engines=je, **kw), TRouter(engines=te, **kw)


def arm(*specs, seed: int = 0) -> None:
    """Arm the same plan in both packages: specs are (point, kind, kw)."""
    for mod in (jchaos, tchaos):
        plan = mod.FaultPlan(seed=seed)
        for point, kind, kw in specs:
            plan.add(point, kind, **kw)
        mod.arm(plan)


def disarm() -> None:
    jchaos.disarm()
    tchaos.disarm()


def requests(seed: int = 11, n: int = 4, max_new: int = 10, sampled=(),
             **kw):
    """The reference fleet tests' requests (24-47 token prompts), one
    list per package."""
    out = []
    for cls in (JRequest, TRequest):
        rng = np.random.RandomState(seed)
        reqs = []
        for i in range(n):
            prompt = rng.randint(1, SHAPE["vocab_size"],
                                 size=rng.randint(24, 48)).astype(np.int32)
            skw = (dict(temperature=0.8, top_p=0.9, seed=100 + i)
                   if i in sampled else {})
            reqs.append(cls(rid=i, prompt=prompt, max_new_tokens=max_new,
                            arrival=0.0, **skw, **kw))
        out.append(reqs)
    return out


def owners(router) -> dict:
    return {rid: rep.engine.engine_id for rid, rep in router._owner.items()}


def assert_port_ledger(router) -> None:
    """The port's 7-class census sums per engine and fleet-wide."""
    acc = router.page_accounting()
    for eid, a in acc["engines"].items():
        eng = next(r.engine for r in router.replicas
                   if r.engine.engine_id == eid)
        assert a["total"] == eng.n_pages - 1, (eid, a)
    assert acc["fleet"]["total"] == acc["expected"], acc


def submit(jr, tr, jreqs, treqs, now: float = 1e18) -> None:
    for a, b in zip(jreqs, treqs):
        jr.submit(a, now=now)
        tr.submit(b, now=now)


def lockstep(jr, tr, on_step=None, limit: int = 3000, now: float = 1e18,
             each_tick=None) -> int:
    """Step both routers on the clock reading ``now`` until idle, holding
    equal return values, page ledgers (per engine, every class) and
    owners after every tick, and the port's ledger summing. ``on_step(n,
    router)`` runs on each router after tick n, ``each_tick(n)`` once
    after both. Returns the number of ticks."""
    n = 0
    while True:
        bj, bt = jr.step(now=now), tr.step(now=now)
        assert bj == bt, n
        n += 1
        if on_step is not None:
            on_step(n, jr)
            on_step(n, tr)
        assert tr.page_accounting() == jr.page_accounting(), n
        assert_port_ledger(tr)
        assert owners(tr) == owners(jr), n
        if each_tick is not None:
            each_tick(n)
        assert n < limit, "fleet did not drain"
        if not bt:
            return n


def health(router) -> list:
    """``health()`` without its wall-clock readings: the step time, and
    the seconds a hung step or swap took inside ``last_error``."""
    return [{k: (re.sub(r"\d+\.\d+s", "<t>s", v)
                 if k == "last_error" and v else v)
             for k, v in h.items() if k != "last_step_ms"}
            for h in router.health()]


def assert_same_fleet(jr, tr, jreqs, treqs) -> None:
    """Streams, flags of every request, owners, ``health()``, the router's
    counters and every engine's counters equal (wall-clock readings
    aside)."""
    for a, b in zip(jreqs, treqs):
        assert a.out_tokens == b.out_tokens, a.rid
        assert (a.aborted, a.t_done is None) == (b.aborted,
                                                  b.t_done is None), a.rid
    assert owners(tr) == owners(jr)
    sj, st = jr.fleet_stats(), tr.fleet_stats()
    assert set(sj) == set(st)
    assert {k: v for k, v in st.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in sj.items() if k not in TIMING_KEYS}
    assert health(tr) == health(jr)
    for rj, rt in zip(jr.replicas, tr.replicas):
        assert (rj.alive, rj.role) == (rt.alive, rt.role)
        for k, v in rt.engine.stats.items():
            if k not in TIMING_KEYS:
                assert rj.engine.stats[k] == v, (rt.engine.engine_id, k)


def settle(router) -> None:
    for rep in router.replicas:
        e = rep.engine
        if rep.alive and (e._deferred_free or e.pool.pending_evict):
            e.pool.release(e._deferred_free)
            e._deferred_free = []
            e.pool.commit_evictable()


@functools.lru_cache(maxsize=None)
def _solo(prompt: bytes, max_new: int, temperature: float, top_p: float,
          seed: int, kv_quant: bool) -> tuple:
    _, tp = weights()
    eng = TEngine(TCFG["float32"], params=tp, device="cpu",
                  kv_quant=kv_quant, **EKW)
    ref = TRequest(rid=1000, prompt=np.frombuffer(prompt, np.int32).copy(),
                   max_new_tokens=max_new, temperature=temperature,
                   top_p=top_p, seed=seed)
    eng.run([ref])
    return tuple(ref.out_tokens)


def solo_port(req, kv_quant: bool = False) -> list:
    """A lone port engine's uninterrupted stream for ``req``."""
    return list(_solo(np.asarray(req.prompt, np.int32).tobytes(),
                      req.max_new_tokens, req.temperature, req.top_p,
                      req.seed, kv_quant))
