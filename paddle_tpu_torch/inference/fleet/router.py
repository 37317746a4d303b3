"""FleetRouter: N ServingEngine replicas behind one admission surface
(the port's copy of paddle_tpu/inference/fleet/router.py, its data
plane).

Placement is cache gravity with a load term, in token units:

    score = cached_prefix_tokens              (pages resident, peeked)
          + adapter_bonus + session_bonus     (residency, affinity)
          - load_penalty                      (queued + resident work)

A deadline-tight request (remaining TTFT budget under
``serving_fleet_tight_deadline``) ignores the gravity terms and goes to
the least-loaded replica. Ties break to the lowest engine id, so
placement is deterministic for a given fleet state.

Health: a replica dies after ``serving_fleet_fail_threshold``
consecutive step exceptions, or when one step takes longer than
``serving_fleet_step_budget`` wall seconds (seen once the step
returns). Death is permanent; a new engine is a new replica.

Recovery: the dead replica's residents and queue become victims.
Never-accepted victims may be shed under pressure
(``_shed_for_pressure``). Each accepted victim's full KV pages migrate
from the dead pool to the chosen target (``serving_fleet_migration``;
chaos ``migration.ship`` models a lost or corrupt shipment, and
recovery then re-prefills). Victims re-enter through ``submit``: the
engine re-prefills prompt + emitted history, mostly through the
migrated pages, and keyed (seed, position) sampling makes the resumed
stream the uninterrupted one. Placement failures retry with a
deterministic exponential backoff up to ``serving_fleet_retry_max``.

Disaggregated pools (``serving_disagg_prefill`` > 0): the first N
replicas form the prefill pool (``prefill_only`` engines: chunked
prefill and the first token, then the prompt's full pages go to the
engine's ``outbox`` and the slot is released), the rest the decode pool.
The router drains outboxes into ship jobs on the same backoff (plus the
per-shipment ``serving_disagg_ship_deadline``), delivers the pages over
the crc'd wire into a decode engine's prefix cache and submits the
request there; the decode engine re-prefills the unshipped tail and the
stream goes on unchanged. A shipment that exhausts its retries or its
deadline falls back to colocated serving, and a pool with no live
engine (or that exhaustion) flips the fleet to degraded colocated mode
until both roles are live again, when it re-splits (``n_resplit``).
``serving_disagg_dynamic`` moves one replica at a time toward the
measured prefill share; an explicit split is a pin.

Zero-downtime operations (primitives in ``rollout.py``): ``rollout()``
upgrades the fleet's weights one engine at a time. Drain: the engine
leaves placement, its queued work is placed again, and its accepted
residents travel over the wire to a peer on the same version. Swap:
``set_params`` under the ``rollout.swap`` chaos point; a swap that
raises or hangs past the step budget is a death, and a fresh engine
joins already on the target. Canary: a real lone decode plus the
``rollout.canary`` point; a failure rolls the whole fleet back to the
prior version. Rejoin. Every request keeps the weight version it was
admitted under and resumes only on an engine of that version, so
streams are unchanged through a deploy. The same drain retires engines
for the autoscaler (``serving_fleet_autoscale``), and the SLO shed
(``serving_fleet_slo_shed``) drops never-accepted requests whose
predicted queue wait already exceeds their remaining TTFT budget.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np

from ... import obs as _obs
from ...core.flags import GLOBAL_FLAGS
from ...obs import clock as _clock
from ...testing import chaos as _chaos
from ..serving import Request, ServingEngine
from .migration import ship_pages, ship_shipment
from .rollout import RolloutState, WeightCatalog, run_canary

__all__ = ["FleetRouter"]


class _Replica:
    """One engine + its health state."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self.alive = True
        self.failures = 0          # consecutive step exceptions
        self.last_step_s = 0.0
        self.last_error: Optional[str] = None
        self.role: Optional[str] = None   # "prefill"/"decode" when disagg
        # out of placement while its rollout/retire episode evacuates
        # it (rollout.py); flipped back at rejoin
        self.draining = False

    def load_tokens(self) -> int:
        """Outstanding work in token units: queued prompt+decode plus
        remaining decode of resident requests."""
        e = self.engine
        n = sum(len(r.prompt) + r.max_new_tokens for r in e.queue)
        for r in e.slots:
            if r is not None:
                n += max(0, r.max_new_tokens - len(r.out_tokens))
        return n


class FleetRouter:
    """Route requests across N replicas of one model; survive replica
    loss with bit-identical streams. See the module docstring. Built
    from ``cfg`` and ``n_engines``, the replicas share the first engine's
    params dict (no copy per engine) and take ``engine_kwargs``,
    ``device`` included (CUDA when none is given)."""

    def __init__(self, cfg=None, n_engines: Optional[int] = None,
                 engines: Optional[list] = None, seed: int = 0,
                 engine_kwargs: Optional[dict] = None,
                 migration: Optional[bool] = None,
                 affinity: Optional[bool] = None,
                 retry_max: Optional[int] = None,
                 retry_base_delay: Optional[float] = None,
                 step_budget: Optional[float] = None,
                 fail_threshold: Optional[int] = None,
                 shed_backlog: Optional[float] = None,
                 tight_deadline: Optional[float] = None,
                 disagg_prefill: Optional[int] = None,
                 ship_deadline: Optional[float] = None,
                 disagg_dynamic: Optional[bool] = None,
                 dynamic_ewma: Optional[float] = None,
                 dynamic_hysteresis: Optional[float] = None,
                 rollout_canary: Optional[int] = None,
                 autoscale: Optional[bool] = None,
                 min_engines: Optional[int] = None,
                 max_engines: Optional[int] = None,
                 scale_high: Optional[float] = None,
                 scale_low: Optional[float] = None,
                 scale_ewma: Optional[float] = None,
                 scale_cooldown: Optional[float] = None,
                 slo_shed: Optional[bool] = None,
                 slo_rate: Optional[float] = None):

        if engines is None:
            if n_engines is None:
                n_engines = int(GLOBAL_FLAGS.get("serving_fleet_engines"))
            if n_engines < 1:
                raise ValueError(
                    "FleetRouter needs engines or n_engines >= 1 "
                    "(serving_fleet_engines is 0 = fleet off)")
            if cfg is None:
                raise ValueError("FleetRouter needs cfg to build engines")
            kw = dict(engine_kwargs or {})
            engines = [ServingEngine(cfg, seed=seed, engine_id=0, **kw)]
            # replicas share ONE params dict — the premise that makes
            # cross-engine page bytes (and thus migration) exchangeable
            for i in range(1, n_engines):
                engines.append(ServingEngine(
                    cfg, params=engines[0].params, seed=seed,
                    engine_id=i, **kw))
        self.replicas = [_Replica(e) for e in engines]
        if len({r.engine.engine_id for r in self.replicas}) \
                != len(self.replicas):
            raise ValueError("replica engine_ids must be unique")
        g = GLOBAL_FLAGS.get
        self.migration = bool(g("serving_fleet_migration")
                              if migration is None else migration)
        self.affinity = bool(g("serving_fleet_affinity")
                             if affinity is None else affinity)
        self.retry_max = int(g("serving_fleet_retry_max")
                             if retry_max is None else retry_max)
        self.retry_base_delay = float(
            g("serving_fleet_retry_base_delay")
            if retry_base_delay is None else retry_base_delay)
        self.step_budget = float(g("serving_fleet_step_budget")
                                 if step_budget is None else step_budget)
        self.fail_threshold = max(1, int(
            g("serving_fleet_fail_threshold")
            if fail_threshold is None else fail_threshold))
        self.shed_backlog = float(g("serving_fleet_shed_backlog")
                                  if shed_backlog is None else shed_backlog)
        self.tight_deadline = float(
            g("serving_fleet_tight_deadline")
            if tight_deadline is None else tight_deadline)
        # disaggregated pools: the first disagg_prefill replicas become
        # the prefill pool (prefill_only engines), the rest the decode
        # pool. 0 = no split: every replica serves both phases.
        dp = int(g("serving_disagg_prefill")
                 if disagg_prefill is None else disagg_prefill)
        self.ship_deadline = float(
            g("serving_disagg_ship_deadline")
            if ship_deadline is None else ship_deadline)
        if dp >= len(self.replicas):
            raise ValueError(
                f"serving_disagg_prefill={dp} leaves no decode engine "
                f"(fleet has {len(self.replicas)} replicas)")
        # measured-load pool splitting (serving_disagg_dynamic): the
        # router EWMAs per-role demand and moves one replica per tick
        # when the measured prefill share leaves the hysteresis band.
        # An explicit serving_disagg_prefill=N is a PIN — the static
        # split holds and the dynamic controller never moves it.
        self.dynamic = bool(g("serving_disagg_dynamic")
                            if disagg_dynamic is None else disagg_dynamic)
        self.split_alpha = float(g("serving_disagg_ewma")
                                 if dynamic_ewma is None else dynamic_ewma)
        self.split_band = float(
            g("serving_disagg_hysteresis")
            if dynamic_hysteresis is None else dynamic_hysteresis)
        self._split_pinned = dp > 0
        if self.dynamic and dp == 0 and len(self.replicas) >= 2:
            dp = max(1, len(self.replicas) // 2)
        self._pf_ewma: Optional[float] = None
        self._dec_ewma: Optional[float] = None
        self._split_traj: list[float] = []
        self.disagg = dp > 0
        self.degraded = False
        self._degraded_t0 = 0.0
        self._degraded_ms: list[float] = []
        if self.disagg:
            for i, rep in enumerate(self.replicas):
                rep.role = "prefill" if i < dp else "decode"
                rep.engine.pool_role = rep.role
                rep.engine.prefill_only = rep.role == "prefill"
            self._split_traj.append(round(dp / len(self.replicas), 3))
        # zero-downtime operations (rollout.py): weight catalog, the
        # in-flight rollout cursor, the autoscale controller and the
        # SLO-shed predictor. Everything below is inert until
        # rollout()/autoscale/slo_shed is actually used.
        self.catalog = WeightCatalog()
        self._rollout: Optional[RolloutState] = None
        self._rollout_stall_ms = 0.0
        self._engine_kwargs = dict(engine_kwargs) if engine_kwargs else None
        self.rollout_canary = int(g("serving_fleet_rollout_canary")
                                  if rollout_canary is None
                                  else rollout_canary)
        self.autoscale = bool(g("serving_fleet_autoscale")
                              if autoscale is None else autoscale)
        self.min_engines = max(1, int(g("serving_fleet_min_engines")
                                      if min_engines is None
                                      else min_engines))
        self.max_engines = int(g("serving_fleet_max_engines")
                               if max_engines is None else max_engines)
        self.scale_high = float(g("serving_fleet_scale_high")
                                if scale_high is None else scale_high)
        self.scale_low = float(g("serving_fleet_scale_low")
                               if scale_low is None else scale_low)
        self.scale_alpha = float(g("serving_fleet_scale_ewma")
                                 if scale_ewma is None else scale_ewma)
        self.scale_cooldown = float(g("serving_fleet_scale_cooldown")
                                    if scale_cooldown is None
                                    else scale_cooldown)
        self.slo_shed = bool(g("serving_fleet_slo_shed")
                             if slo_shed is None else slo_shed)
        self.slo_rate = float(g("serving_fleet_slo_rate")
                              if slo_rate is None else slo_rate)
        self._util_ewma: Optional[float] = None
        self._last_scale_t = float("-inf")
        self._retiring: Optional[_Replica] = None
        self._rate_ewma: Optional[float] = None
        self._rate_mark: Optional[tuple] = None   # (now, total out toks)
        self._n_eng_min = self._n_eng_max = len(self.replicas)
        # rids whose prefill phase is done (shipped or fallen back):
        # placement routes them to the decode pool from here on
        self._decode_phase: set[int] = set()
        self._owner: dict[int, _Replica] = {}      # rid -> placement
        self._requests: dict[int, Request] = {}
        # retry entries: [ready_monotonic, attempt, request, ship_job]
        # (ship_job None = placement retry; else a dict — see
        # _drain_outboxes — riding the same deterministic backoff)
        self._retry: list[list] = []
        self._sessions: dict = {}                   # session -> engine_id
        # accepted victims awaiting their first post-kill token:
        # [request, len(out_tokens) at kill, monotonic at kill]
        self._recovering: list[list] = []
        self._recovery_ms: list[float] = []
        self.stats = {
            "n_submitted": 0, "n_killed": 0, "n_recovered": 0,
            "migrated_pages": 0, "migration_bytes": 0,
            "migration_dropped": 0, "migration_rejected": 0,
            "migration_failed": 0, "n_shed": 0, "n_retry_exhausted": 0,
            "n_deadline_dropped": 0,
            # disaggregated-pool counters (all zero when disagg off)
            "disagg_shipped_pages": 0, "disagg_ship_bytes": 0,
            "degraded_steps": 0, "n_resplit": 0,
            "n_ship_retries": 0, "n_ship_deadline": 0,
            # wire observability: total payload bytes over the migration
            # wire (disagg handoffs + death migrations), adopter-side
            # wall ms, successful page-bearing handoffs, and the peak
            # outbox + ship-retry depth seen on any tick
            "shipped_bytes": 0, "wire_adopt_ms": 0.0,
            "n_handoffs": 0, "ship_queue_depth": 0,
            # zero-downtime ops counters (rollout / autoscale / SLO)
            "n_rollouts": 0, "n_rollback": 0, "n_canary_fail": 0,
            "n_swap_deaths": 0, "rollout_ms": 0.0, "n_slo_shed": 0,
            "n_scale_up": 0, "n_scale_down": 0,
        }
        # FLAGS_obs_trace=1 arms the observability plane from any entry
        # point (the engines' constructors do the same)
        _obs.arm_from_flags()

    # -- registration broadcast ------------------------------------------

    def register_adapter(self, adapter_id, weights: dict) -> None:
        """Register a LoRA adapter on every replica (placement may send
        an adapter request anywhere; digests — and so cache salts —
        match because the weights do)."""
        for r in self.replicas:
            r.engine.register_adapter(adapter_id, weights)

    def register_schema(self, schema_id, factory) -> None:
        for r in self.replicas:
            r.engine.register_schema(schema_id, factory)

    # -- placement --------------------------------------------------------

    def _alive(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive]

    def _cached_tokens(self, rep: _Replica, req: Request) -> int:
        """Tokens of ``req``'s effective prompt resident in ``rep``'s
        prefix cache — a pure peek (no incref, no side effects)."""
        e = rep.engine
        if not e._cache_on:
            return 0
        P = (np.concatenate([np.asarray(req.prompt, np.int32),
                             np.asarray(req.out_tokens, np.int32)])
             if req.out_tokens else np.asarray(req.prompt, np.int32))
        n = 0
        for h in e._page_hashes(P, e._cache_salt(req)):
            if h not in e.pool.cache:
                break
            n += 1
        return n * e.bs

    def _role_for(self, req: Request) -> Optional[str]:
        """Which pool this request belongs to right now. None = any
        engine (disagg off, or degraded colocated mode)."""
        if not self.disagg or self.degraded:
            return None
        if req.rid in self._decode_phase or req.out_tokens:
            return "decode"
        return "prefill"

    def _choose(self, req: Request, now: float,
                role: Optional[str] = None) -> Optional[_Replica]:
        alive = self._alive()
        if not alive:
            return None
        # a draining replica (mid-rollout/retire) takes no new work; if
        # EVERYTHING is draining (single-engine rollout) fall through —
        # availability beats the drain
        live = [r for r in alive if not r.draining]
        if live:
            alive = live
        if role is not None:
            # pool-scoped placement; an empty pool falls back to any
            # live engine (that IS colocated degradation — the census
            # flips the degraded flag on the next fleet tick)
            pool = [r for r in alive if r.role == role]
            if pool:
                alive = pool
        # weight-version pin: an ACCEPTED stream (tokens emitted or
        # TTFT recorded) must resume on the version it was served
        # under — cross-version resume would change its tokens. A
        # never-accepted request re-pins freely. No same-version
        # replica alive falls back to any (availability; the drain
        # protocol keeps a peer alive in every non-total-loss case).
        pin = (req.param_version
               if (req.out_tokens or req.t_first is not None) else None)
        if pin is not None:
            same = [r for r in alive if r.engine.param_version == pin]
            if same:
                alive = same
        rem_ttft = None
        if req.deadline_ttft > 0 and req.t_first is None:
            rem_ttft = (req.arrival + req.deadline_ttft) - now
        tight = rem_ttft is not None and rem_ttft <= self.tight_deadline
        best = None
        for rep in alive:
            e = rep.engine
            if tight:
                # deadline-aware routing: cache gravity is worthless to
                # a request about to miss TTFT — pure least-loaded
                score = -float(rep.load_tokens())
            else:
                score = float(self._cached_tokens(rep, req))
                if (req.adapter_id is not None and e.adapters is not None
                        and req.adapter_id in e.adapters._resident):
                    score += 2.0 * e.bs
                if (self.affinity and req.session is not None
                        and self._sessions.get(req.session)
                        == e.engine_id):
                    score += 4.0 * e.bs
                score -= float(rep.load_tokens())
            key = (score, -e.engine_id)
            if best is None or key > best[0]:
                best = (key, rep)
        return best[1]

    def _expired(self, req: Request, now: float) -> bool:
        return (req.deadline_e2e > 0
                and now > req.arrival + req.deadline_e2e)

    def _place(self, req: Request, now: float) -> bool:
        """Choose a replica and hand the request to its engine. False =
        no alive replica (caller retries/sheds); a structurally
        impossible request (engine.submit ValueError) propagates on
        first submission and sheds on recovery paths."""
        if self._expired(req, now):
            self._drop(req, "n_deadline_dropped")
            return True                     # handled, don't retry
        rep = self._choose(req, now, self._role_for(req))
        if rep is None:
            return False
        rep.engine.submit(req)
        self._owner[req.rid] = rep
        if not req.out_tokens and req.t_first is None:
            # admission-time version pin (None until a rollout names
            # versions — unpinned placement is the pre-rollout router)
            req.param_version = rep.engine.param_version
        if self.affinity and req.session is not None:
            self._sessions[req.session] = rep.engine.engine_id
        return True

    def _drop(self, req: Request, counter: str) -> None:
        req.aborted = True
        req.t_done = _clock.now()
        self._owner.pop(req.rid, None)
        self._decode_phase.discard(req.rid)
        self.stats[counter] += 1

    def _queue_retry(self, req: Request, attempt: int) -> None:
        """Deterministic exponential backoff on the real clock (driver
        clocks — wall offsets or the rush constant — don't advance
        between router steps, so backoff can't key off them)."""
        if attempt > self.retry_max:
            self._drop(req, "n_retry_exhausted")
            return
        delay = (0.0 if attempt == 0
                 else self.retry_base_delay * (2.0 ** (attempt - 1)))
        self._retry.append([_clock.now() + delay, attempt, req, None])

    def submit(self, req: Request, now: float = 0.0) -> None:
        self._requests[req.rid] = req
        self.stats["n_submitted"] += 1
        if not self._place(req, now):
            self._queue_retry(req, 0)

    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it is: placed on a replica, in the
        router retry queue, or recovering."""
        self._recovering = [e for e in self._recovering
                            if e[0].rid != rid]
        rep = self._owner.pop(rid, None)
        if rep is not None and rep.engine.abort(rid):
            self._decode_phase.discard(rid)
            return True
        for i, (_rdy, _att, req, _job) in enumerate(self._retry):
            if req.rid == rid:
                self._retry.pop(i)
                req.aborted = True
                req.t_done = _clock.now()
                self._decode_phase.discard(rid)
                return True
        for rep2 in self.replicas:      # swept into an engine outbox,
            for i, (req, _sh) in enumerate(rep2.engine.outbox):  # not yet
                if req.rid == rid:                       # picked up
                    rep2.engine.outbox.pop(i)
                    req.aborted = True
                    req.t_done = _clock.now()
                    self._decode_phase.discard(rid)
                    return True
        return False

    # -- stepping + health ------------------------------------------------

    def step(self, now: float = 0.0) -> bool:
        """One fleet tick: pool-role census (enter/leave degraded
        colocated mode), drain ready retries (placement + ship jobs),
        step every live engine (exceptions/hangs -> death + recovery),
        drain prefill outboxes into ship jobs, track stream recoveries.
        Returns True while any work remains anywhere."""
        if self.disagg:
            self._roles_census(now)
            if (self.dynamic and not self._split_pinned
                    and not self.degraded):
                self._dynamic_resplit(now)
        if self._rollout is not None:
            self._rollout_tick(now)
        if self.autoscale or self._retiring is not None:
            self._autoscale_tick(now)
        if self.slo_shed:
            self._slo_tick(now)
        if self._retry:
            t = _clock.now()
            ready = [e for e in self._retry if e[0] <= t]
            self._retry = [e for e in self._retry if e[0] > t]
            for _rdy, attempt, req, job in ready:
                if req.aborted:
                    continue
                if job is not None:
                    self._attempt_ship(job, attempt, now)
                    continue
                try:
                    placed = self._place(req, now)
                except ValueError:
                    self._drop(req, "n_shed")   # can never fit anywhere
                    continue
                if not placed:
                    self._queue_retry(req, attempt + 1)
        busy = False
        for rep in self.replicas:
            if not rep.alive:
                continue
            t0 = _clock.now()
            try:
                more = rep.engine.step(now=now)
            except Exception as exc:          # noqa: BLE001 — a replica
                rep.failures += 1             # loss is any step escape
                rep.last_error = f"{type(exc).__name__}: {exc}"
                if rep.failures >= self.fail_threshold:
                    self._declare_dead(rep, now)
                busy = True
                continue
            rep.failures = 0
            rep.last_step_s = _clock.now() - t0
            if self.step_budget > 0 and rep.last_step_s > self.step_budget:
                # hang detection, single-threaded: the stall is observed
                # as elapsed wall time once the step finally returns
                rep.last_error = (f"step took {rep.last_step_s:.3f}s > "
                                  f"budget {self.step_budget:.3f}s")
                self._declare_dead(rep, now)
                busy = True
                continue
            busy = busy or more
        if self.disagg:
            busy = self._drain_outboxes(now) or busy
            if self.degraded:
                # counted at tick end so a same-tick enter (shipment
                # exhaustion during the drain above) registers
                self.stats["degraded_steps"] += 1
        if self._recovering:
            t = _clock.now()
            still = []
            for entry in self._recovering:
                req, n0, t0 = entry
                if req.aborted:
                    continue
                if len(req.out_tokens) > n0:
                    self._recovery_ms.append((t - t0) * 1000.0)
                    self.stats["n_recovered"] += 1
                else:
                    still.append(entry)
            self._recovering = still
        n_live = len(self._alive())
        if n_live < self._n_eng_min:
            self._n_eng_min = n_live
        if n_live > self._n_eng_max:
            self._n_eng_max = n_live
        return (busy or bool(self._retry) or bool(self._recovering)
                or self._rollout is not None
                or self._retiring is not None)

    def kill_engine(self, engine_id: int, now: float = 0.0) -> None:
        """Deterministic replica kill (bench/smoke hook): same death +
        recovery path as a chaos-injected step failure."""
        for rep in self.replicas:
            if rep.engine.engine_id == engine_id and rep.alive:
                rep.last_error = "killed"
                self._declare_dead(rep, now)
                return
        raise ValueError(f"no live replica with engine_id {engine_id}")

    def kill_pool(self, role: str, now: float = 0.0) -> None:
        """Kill every live engine of a pool role (bench/smoke hook for
        pool death; chaos pool-scoped ``engine.step`` specs exercise
        the same outcome through the fault path)."""
        for rep in [r for r in self._alive() if r.role == role]:
            rep.last_error = f"killed ({role} pool)"
            self._declare_dead(rep, now)

    def add_engine(self, engine: Optional[ServingEngine] = None,
                   role: Optional[str] = None,
                   engine_kwargs: Optional[dict] = None,
                   seed: int = 0, params=None,
                   version: Optional[str] = None) -> int:
        """Join a fresh replica (death is permanent, a new engine is a
        new replica). A built engine shares replica 0's params dict and
        its device unless ``engine_kwargs`` names one; during a rollout
        pass ``params=`` / ``version=`` so that the joiner lands on a
        chosen side of the upgrade (replica 0 may hold either one). In
        disaggregated mode it takes ``role`` (or the thinner live pool);
        a degraded fleet serves it colocated until the next census
        re-splits. Returns the new engine_id."""
        eid = 1 + max(r.engine.engine_id for r in self.replicas)
        if engine is None:
            ref = self.replicas[0].engine
            engine = ServingEngine(ref.cfg,
                                   params=(ref.params if params is None
                                           else params),
                                   seed=seed, engine_id=eid,
                                   **{"device": ref.device,
                                      **(engine_kwargs or {})})
            if params is None and version is None:
                version = ref.param_version
        if version is not None:
            engine.param_version = version
        rep = _Replica(engine)
        if self.disagg:
            alive = self._alive()
            n_pre = sum(1 for r in alive if r.role == "prefill")
            n_dec = sum(1 for r in alive if r.role == "decode")
            rep.role = role or ("prefill" if n_pre <= n_dec else "decode")
            engine.pool_role = rep.role
            engine.prefill_only = (rep.role == "prefill"
                                   and not self.degraded)
        self.replicas.append(rep)
        if len({r.engine.engine_id for r in self.replicas}) \
                != len(self.replicas):
            raise ValueError("replica engine_ids must be unique")
        return engine.engine_id

    # -- zero-downtime operations: rollout, autoscale, SLO shed -----------

    @property
    def rollout_active(self) -> bool:
        return self._rollout is not None

    def rollout(self, params=None, version: Optional[str] = None) -> str:
        """Start a rolling weight upgrade to ``params`` (published to
        the catalog here) or to an already-published ``version``. The
        upgrade advances incrementally inside ``step()`` — one engine
        at a time through drain -> swap -> canary -> rejoin — so the
        fleet keeps serving throughout; see ``_rollout_tick`` for the
        fault model. Returns the target version id."""
        if self._rollout is not None:
            raise RuntimeError("a rollout is already in flight")
        # name the fleet's current weights so A/B placement has a pin
        # for both sides (and a rollback destination)
        base = self.catalog.put(self.replicas[0].engine.params)
        for rep in self.replicas:
            if rep.engine.param_version is None:
                rep.engine.param_version = base
        # streams admitted before versions existed pin retroactively to
        # their current engine's (= the baseline) version — a stream
        # must never straddle the upgrade
        for req in self._requests.values():
            if (req.param_version is None and not req.aborted
                    and len(req.out_tokens) < req.max_new_tokens):
                owner = self._owner.get(req.rid)
                req.param_version = (owner.engine.param_version
                                     if owner is not None else base)
        if params is not None:
            version = self.catalog.put(params)
        if version is None:
            raise ValueError("rollout needs params or version")
        if version not in self.catalog:
            raise ValueError(f"unknown weight version {version!r}")
        prior = next((r.engine.param_version for r in self._alive()
                      if r.engine.param_version != version), base)
        self._rollout = RolloutState(target=version, prior=prior,
                                     t0=_clock.now())
        self.stats["n_rollouts"] += 1
        return version

    def _rollout_tick(self, now: float) -> None:
        """Advance the in-flight rolling upgrade. Protocol, one engine
        at a time (lowest engine_id first, engines already on the
        target skipped): (1) DRAIN — out of placement, queued work
        re-placed on peers, accepted residents swept out through the
        outbox and delivered over the migration wire to a same-version
        peer (no peer: they finish in place, the drain waits); (2)
        SWAP — ``set_params`` under the ``rollout.swap`` chaos probe; a
        raise, or a hang past the step budget, is a *mid-swap death*:
        the corpse is declared dead (it is empty — nothing to recover)
        and a replacement joins already ON the target version, so the
        rollout still converges; (3) CANARY — ``rollout.canary`` probe
        plus a real solo decode; failure swaps this engine straight
        back and retargets the whole fleet at the prior version (a
        rollback is a rollout with canary failures ignored, so it
        always converges to ONE version); (4) REJOIN placement."""
        ro = self._rollout
        rep = None
        if ro.current_eid is not None:
            rep = next((r for r in self.replicas
                        if r.engine.engine_id == ro.current_eid), None)
            if rep is None or not rep.alive:
                # the engine died mid-episode (a chaos engine.step kill
                # landing during its drain): _declare_dead already
                # recovered its victims — replace it straight on the
                # target version and move on
                if rep is not None:
                    rep.draining = False
                self.add_engine(params=self.catalog.get(ro.target),
                                version=ro.target,
                                engine_kwargs=self._replacement_kwargs())
                self._end_episode(ro)
                return
        if rep is None:
            cand = [r for r in self._alive()
                    if r.engine.param_version != ro.target
                    and r is not self._retiring]
            if not cand:
                self.stats["rollout_ms"] += round(
                    (_clock.now() - ro.t0) * 1000.0, 3)
                self._rollout = None
                return
            rep = min(cand, key=lambda r: r.engine.engine_id)
            ro.current_eid = rep.engine.engine_id
            ro.episode_t0 = _clock.now()
            _obs.instant("rollout.drain", engine=rep.engine.engine_id,
                         target=ro.target)
            self._begin_drain(rep, now)
            return
        if not self._drain_tick(rep, now):
            return                              # still evacuating
        e = rep.engine
        died = False
        t0 = _clock.now()
        try:
            with _obs.span("rollout.swap", engine=e.engine_id,
                           target=ro.target):
                self._swap_probe(e)
                e.set_params(self.catalog.get(ro.target),
                             version=ro.target)
        except Exception as exc:    # noqa: BLE001 — any swap escape is
            rep.last_error = (      # a mid-swap death
                f"rollout.swap: {type(exc).__name__}: {exc}")
            died = True
        if (not died and self.step_budget > 0
                and _clock.now() - t0 > self.step_budget):
            # a hung swap past the step budget: same verdict as a hung
            # step — the replica's weight state is not trustworthy
            rep.last_error = (f"rollout.swap took "
                              f"{_clock.now() - t0:.3f}s > budget "
                              f"{self.step_budget:.3f}s")
            died = True
        if died:
            self.stats["n_swap_deaths"] += 1
            rep.draining = False
            self._declare_dead(rep, now, reason="rollout-swap-death")
            self.add_engine(params=self.catalog.get(ro.target),
                            version=ro.target,
                            engine_kwargs=self._replacement_kwargs())
            self._end_episode(ro)
            return
        ok = True
        if _chaos.active():
            ctx = {"engine": e.engine_id}
            if e.pool_role is not None:
                ctx["pool"] = e.pool_role
            spec = _chaos.fire("rollout.canary", ctx=ctx)
            if spec is not None and spec.kind == "fail":
                ok = False
        if ok and self.rollout_canary > 0:
            try:
                with _obs.span("rollout.canary", engine=e.engine_id,
                               target=ro.target):
                    ok = run_canary(e, self.rollout_canary, now=now)
            except Exception as exc:  # noqa: BLE001 — a canary that
                rep.last_error = (    # raises is a dead engine
                    f"rollout.canary: {type(exc).__name__}: {exc}")
                rep.draining = False
                self._declare_dead(rep, now,
                                   reason="rollout-canary-death")
                self.add_engine(params=self.catalog.get(ro.target),
                                version=ro.target,
                                engine_kwargs=self._replacement_kwargs())
                self._end_episode(ro)
                return
        if not ok and not ro.is_rollback:
            # automatic rollback: this engine is drained and out of
            # placement, so swapping it straight back is safe; the
            # engines already upgraded drain and swap back through the
            # same machinery
            self.stats["n_canary_fail"] += 1
            self.stats["n_rollback"] += 1
            _obs.flight_dump("canary-rollback",
                             detail=f"engine {e.engine_id} canary "
                                    f"failed on {ro.target}; fleet "
                                    f"retargets {ro.prior}")
            e.set_params(self.catalog.get(ro.prior), version=ro.prior)
            self._rejoin(rep)
            self._end_episode(ro)
            self._rollout = RolloutState(target=ro.prior,
                                         prior=ro.target,
                                         is_rollback=True, t0=ro.t0)
            return
        if not ok:
            self.stats["n_canary_fail"] += 1   # rollback: noted, ignored
        self._rejoin(rep)
        self._end_episode(ro)

    def _swap_probe(self, e: ServingEngine) -> None:
        """Armed-only ``rollout.swap`` fault probe (kinds: ``raise`` —
        the swap dies mid-flight; ``hang`` — sleep ``seconds`` so the
        step-budget watchdog sees an over-budget swap). Same
        ``engine=``/``pool=`` ctx targeting as ``engine.step``."""
        if not _chaos.active():
            return
        ctx = {"engine": e.engine_id}
        if e.pool_role is not None:
            ctx["pool"] = e.pool_role
        spec = _chaos.fire("rollout.swap", ctx=ctx)
        if spec is None:
            return
        if spec.kind == "hang":
            time.sleep(float(spec.args.get("seconds", 0.05)))
        else:
            raise _chaos.ChaosInjected(
                f"chaos: engine {e.engine_id} rollout swap failure")

    def _version_peer(self, rep: _Replica) -> Optional[_Replica]:
        """A live non-draining replica on the same weight version as
        ``rep`` — the only legal resume target for its accepted
        streams."""
        v = rep.engine.param_version
        for r in self._alive():
            if (r is not rep and not r.draining
                    and r.engine.param_version == v):
                return r
        return None

    def _begin_drain(self, rep: _Replica, now: float) -> None:
        """Take ``rep`` out of placement and start evacuating it.
        Queued never-accepted work re-places on peers immediately
        (re-pinning to the new engine's version); accepted residents
        are swept out through the ``prefill_only`` outbox path —
        export full pages, in-flight-safe, the exact disagg handoff
        plane — and delivered by ``_drain_tick``. With no same-version
        peer (the last engine on its version) accepted streams finish
        in place and the drain simply waits for them."""
        rep.draining = True
        e = rep.engine
        any_peer = any(r for r in self._alive()
                       if r is not rep and not r.draining)
        vpeer = self._version_peer(rep) is not None
        keep, moved = [], []
        for r in e.queue:
            if r.aborted:
                continue
            accepted = bool(r.out_tokens) or r.t_first is not None
            if not any_peer or (accepted and not vpeer):
                keep.append(r)
                continue
            moved.append(r)
        e.queue = keep
        for r in moved:
            if self._owner.get(r.rid) is rep:
                del self._owner[r.rid]
            r.age = 0
            if not self._place(r, now):
                self._queue_retry(r, 0)
        if vpeer:
            e.prefill_only = True

    def _drain_tick(self, rep: _Replica, now: float) -> bool:
        """Deliver what the draining engine swept into its outbox —
        pages over the crc'd migration wire, request re-submitted on a
        same-version peer, the bit-identical resume every other
        recovery path uses — and report whether the engine is empty
        (no queue, no residents, no outbox). If the same-version peer
        vanished mid-drain the sweep stops and the stream finishes in
        place on the donor."""
        e = rep.engine
        if e.outbox:
            jobs, e.outbox = e.outbox, []
            for req, shipment in jobs:
                if (req.aborted
                        or len(req.out_tokens) >= req.max_new_tokens):
                    continue
                if self._owner.get(req.rid) is rep:
                    del self._owner[req.rid]
                if shipment is not None and shipment.get("staged"):
                    shipment = e.finalize_shipment(shipment)
                target = self._choose(req, now, self._role_for(req))
                pin = req.param_version
                if (pin is not None and rep.alive
                        and (target is None
                             or target.engine.param_version != pin)):
                    e.prefill_only = False
                    target = rep
                if target is None:
                    self._queue_retry(req, 0)
                    continue
                if (target is not rep and shipment is not None
                        and self.migration):
                    res = ship_shipment(shipment, e.engine_id,
                                        target.engine,
                                        donor_pool=rep.role)
                    self.stats["migrated_pages"] += res["pages"]
                    self.stats["migration_bytes"] += res["bytes"]
                    self.stats["shipped_bytes"] += res["bytes"]
                    self.stats["wire_adopt_ms"] += res.get(
                        "adopt_ms", 0.0)
                    if res["pages"]:
                        self.stats["n_handoffs"] += 1
                self._deliver(req, target)
        return (not e.queue and not e.outbox
                and all(r is None for r in e.slots))

    def _rejoin(self, rep: _Replica) -> None:
        rep.draining = False
        rep.engine.prefill_only = (self.disagg and not self.degraded
                                   and rep.role == "prefill")

    def _end_episode(self, ro: RolloutState) -> None:
        if ro.current_eid is not None:
            ms = (_clock.now() - ro.episode_t0) * 1000.0
            if ms > self._rollout_stall_ms:
                self._rollout_stall_ms = ms
        ro.current_eid = None

    def _replacement_kwargs(self) -> dict:
        """Geometry for a replacement/scale-up engine: the ctor's
        engine_kwargs when the router built its fleet, else derived
        from replica 0 (externally built engines)."""
        if self._engine_kwargs is not None:
            return dict(self._engine_kwargs)
        ref = self.replicas[0].engine
        return dict(max_batch=ref.B, page_size=ref.bs,
                    max_seq=ref.max_seq, n_pages=ref.n_pages)

    def _autoscale_tick(self, now: float) -> None:
        """Demand-driven engine count (``serving_fleet_autoscale``):
        the dynamic-split demand census totalled fleet-wide, EWMA'd
        against aggregate pool capacity in token units. Above the high
        watermark a replica joins on the fleet's current weight
        version; below the low watermark the least-loaded replica is
        retired by drain-then-REMOVE (its queue re-places, its
        residents resume on peers over the migration wire — requests
        are never dropped). Bounded by min/max engines, a wall-clock
        cooldown between actions, paused while a rollout is in flight
        (one membership change at a time)."""
        if self._retiring is not None:
            rep = self._retiring
            if not rep.alive:
                self._retiring = None   # died mid-retire: stays as a
                return                  # dead replica (frozen pool)
            if self._drain_tick(rep, now):
                self.replicas.remove(rep)
                self._retiring = None
            return
        if not self.autoscale or self._rollout is not None:
            return
        pool = [r for r in self._alive() if not r.draining]
        cap = sum((r.engine.n_pages - 1) * r.engine.bs for r in pool)
        if not pool or cap <= 0:
            return
        pf, dec = self._census_tokens()
        util = (pf + dec) / cap
        a = self.scale_alpha
        self._util_ewma = (util if self._util_ewma is None
                           else a * util + (1.0 - a) * self._util_ewma)
        t = _clock.now()
        if t - self._last_scale_t < self.scale_cooldown:
            return
        if (self._util_ewma > self.scale_high
                and len(pool) < self.max_engines):
            ref = pool[0].engine
            self.add_engine(params=ref.params,
                            version=ref.param_version,
                            engine_kwargs=self._replacement_kwargs())
            self.stats["n_scale_up"] += 1
            self._last_scale_t = t
        elif (self._util_ewma < self.scale_low
                and len(pool) > self.min_engines):
            rep = min(pool, key=lambda r: (r.load_tokens(),
                                           r.engine.engine_id))
            self.stats["n_scale_down"] += 1
            self._last_scale_t = t
            self._retiring = rep
            self._begin_drain(rep, now)

    def _slo_tick(self, now: float) -> None:
        """SLO-aware admission control (``serving_fleet_slo_shed``):
        per never-accepted queued request, predicted wait (tokens
        ahead of it in its queue / per-engine service rate) vs its
        remaining TTFT budget — a request that cannot make its
        deadline sheds NOW (``n_slo_shed``) instead of missing it
        later. The pressure-shed rule extended from backlog-vs-
        capacity to time-vs-deadline: accepted streams are never shed,
        and the engine's admission order (priority-sorted when
        serving_priorities is on) is the shed order, so the lowest
        classes go first. Rate = ``serving_fleet_slo_rate`` per engine
        when set (deterministic in rush-clock tests), else a measured
        fleet-throughput EWMA; with neither, a no-op."""
        pool = [r for r in self._alive() if not r.draining]
        if not pool:
            return
        if self.slo_rate > 0:
            per_engine = self.slo_rate
        else:
            self._measure_rate(now)
            if not self._rate_ewma or self._rate_ewma <= 0:
                return
            per_engine = self._rate_ewma / len(pool)
        for rep in pool:
            e = rep.engine
            ahead = float(sum(max(0, r.max_new_tokens
                                  - len(r.out_tokens))
                              for r in e.slots if r is not None))
            for r in list(e.queue):
                if r.aborted:
                    continue
                accepted = bool(r.out_tokens) or r.t_first is not None
                if not accepted and r.deadline_ttft > 0:
                    remain = (r.arrival + r.deadline_ttft) - now
                    if ahead / per_engine > remain:
                        e.abort(r.rid)     # shed: its removal frees
                        self._owner.pop(r.rid, None)   # the queue for
                        self._decode_phase.discard(r.rid)  # the rest
                        self.stats["n_slo_shed"] += 1
                        continue
                ahead += len(r.prompt) + r.max_new_tokens
        if self._retry:
            base = min(float(r.load_tokens()) for r in pool)
            keep = []
            for entry in self._retry:
                _rdy, _att, r, job = entry
                if (job is None and not r.aborted and not r.out_tokens
                        and r.t_first is None and r.deadline_ttft > 0
                        and base / per_engine
                        > (r.arrival + r.deadline_ttft) - now):
                    self._drop(r, "n_slo_shed")
                    continue
                keep.append(entry)
            self._retry = keep

    def _measure_rate(self, now: float) -> None:
        """Fleet decode-throughput EWMA on the driver clock (tokens
        emitted across all submitted requests per ``now`` second); the
        SLO predictor's fallback when no rate prior is pinned."""
        total = float(sum(len(r.out_tokens)
                          for r in self._requests.values()))
        if self._rate_mark is None:
            self._rate_mark = (now, total)
            return
        t0, n0 = self._rate_mark
        dt = now - t0
        if dt <= 0:
            return
        inst = (total - n0) / dt
        self._rate_mark = (now, total)
        a = self.scale_alpha
        self._rate_ewma = (inst if self._rate_ewma is None
                           else a * inst + (1.0 - a) * self._rate_ewma)

    # -- disaggregated pools: census, shipping, degraded mode -------------

    def _roles_census(self, now: float) -> None:
        """Enter degraded colocated mode when a pool role has no live
        engine; re-split as soon as both roles are live again AND no
        ship job is still in flight (a pending shipment finishing under
        the colocated regime keeps its simple fallback semantics)."""
        roles = {r.role for r in self._alive()}
        whole = "prefill" in roles and "decode" in roles
        if not self.degraded and not whole:
            self._set_degraded()
        elif self.degraded and whole and not any(
                e[3] is not None for e in self._retry):
            self._resplit()

    def _set_degraded(self) -> None:
        """Pool death -> colocated: every survivor serves both phases
        (prefill_only off), placement stops filtering by role."""
        self.degraded = True
        self._degraded_t0 = _clock.now()
        for rep in self._alive():
            rep.engine.prefill_only = False
        _obs.flight_dump("pool-death",
                         detail="degraded to colocated serving")

    def _resplit(self) -> None:
        """Both roles live again: restore the pool split. Mid-decode
        residents of engines returning to the prefill role are swept
        out through their outboxes on their next step and ship to the
        decode pool — the same bit-identical resume as a first
        handoff."""
        self.degraded = False
        self._degraded_ms.append(
            (_clock.now() - self._degraded_t0) * 1000.0)
        self.stats["n_resplit"] += 1
        for rep in self._alive():
            if rep.role == "prefill":
                rep.engine.prefill_only = True
        self._record_split()

    def _record_split(self) -> None:
        alive = self._alive()
        if alive:
            n_pre = sum(1 for r in alive if r.role == "prefill")
            self._split_traj.append(round(n_pre / len(alive), 3))

    def _census_tokens(self) -> tuple:
        """Per-phase demand census in token units — queued + mid-
        prefill prompt tokens vs remaining decode tokens, over every
        live engine plus the retry queue. Shared by the dynamic-split
        controller (which cares about the pf/dec ratio) and the
        autoscaler (which cares about the total vs capacity)."""
        pf = dec = 0.0
        for rep in self._alive():
            e = rep.engine
            for r in e.queue:
                if r.aborted:
                    continue
                if r.out_tokens or r.rid in self._decode_phase:
                    dec += max(0, r.max_new_tokens - len(r.out_tokens))
                else:
                    pf += len(r.prompt)
            for s, r in enumerate(e.slots):
                if r is None or r.aborted:
                    continue
                if s in e._prefilling:
                    pf += max(0, len(e._slot_prompt[s])
                              - e._prefilling[s])
                else:
                    dec += max(0, r.max_new_tokens - len(r.out_tokens))
        for _rdy, _att, r, job in self._retry:
            if r.aborted:
                continue
            if (job is not None or r.out_tokens
                    or r.rid in self._decode_phase):
                dec += max(0, r.max_new_tokens - len(r.out_tokens))
            else:
                pf += len(r.prompt)
        return pf, dec

    def _dynamic_resplit(self, now: float) -> None:
        """Measured-load split controller (``serving_disagg_dynamic``,
        unpinned fleets only): census per-role demand in token units —
        queued + mid-prefill prompt tokens vs remaining decode tokens —
        EWMA both, and when the smoothed prefill share leaves the
        hysteresis band around the current pool share, move ONE replica
        per tick toward the measured split (each pool always keeps at
        least one live engine). A promoted decode engine's mid-decode
        residents are swept back out through its outbox on its next
        step — the same bit-identical resume as any handoff."""
        alive = self._alive()
        n = len(alive)
        if n < 2:
            return
        pf, dec = self._census_tokens()
        a = self.split_alpha
        self._pf_ewma = (pf if self._pf_ewma is None
                         else a * pf + (1.0 - a) * self._pf_ewma)
        self._dec_ewma = (dec if self._dec_ewma is None
                          else a * dec + (1.0 - a) * self._dec_ewma)
        tot = self._pf_ewma + self._dec_ewma
        if tot <= 0.0:
            return
        share = self._pf_ewma / tot
        n_pre = sum(1 for r in alive if r.role == "prefill")
        desired = min(n - 1, max(1, int(round(share * n))))
        if desired == n_pre or abs(share - n_pre / n) <= self.split_band:
            return
        moved = (self._flip_role(alive, "decode", "prefill")
                 if desired > n_pre
                 else self._flip_role(alive, "prefill", "decode"))
        if moved:
            self.stats["n_resplit"] += 1
            self._record_split()

    def _flip_role(self, alive: list, src: str, dst: str) -> bool:
        """Move the least-loaded live ``src``-pool replica to ``dst``
        (ties break to the lowest engine id — deterministic). Refuses
        to empty a pool."""
        cands = [r for r in alive if r.role == src]
        if len(cands) <= 1:
            return False
        rep = min(cands, key=lambda r: (r.load_tokens(),
                                        r.engine.engine_id))
        rep.role = dst
        rep.engine.pool_role = dst
        rep.engine.prefill_only = dst == "prefill"
        return True

    def _drain_outboxes(self, now: float) -> bool:
        """Pick up (request, shipment) pairs the prefill engines swept
        out and attempt delivery to the decode pool. A wire_overlap
        donor's staged shipment is finalized HERE — the async staging
        copy is read back and crc'd at drain time, not inside the
        donor's step. Returns True if anything was processed (the
        driver must keep ticking)."""
        any_work = False
        n_tick = 0
        for rep in self.replicas:
            if not rep.alive or not rep.engine.outbox:
                continue
            if rep.draining:
                continue    # rollout/retire evacuation: _drain_tick
                # delivers this outbox version-pinned, not the ship plane
            jobs, rep.engine.outbox = rep.engine.outbox, []
            for req, shipment in jobs:
                if (req.aborted
                        or len(req.out_tokens) >= req.max_new_tokens):
                    continue        # cancelled / completed at prefill
                any_work = True
                n_tick += 1
                if self._owner.get(req.rid) is rep:
                    del self._owner[req.rid]
                if shipment is not None and shipment.get("staged"):
                    # chaos migration.stage ``drop`` surfaces as a None
                    # shipment: the request still hands off, the decode
                    # pool re-prefills (bit-identical, more FLOPs)
                    shipment = rep.engine.finalize_shipment(shipment)
                job = {"req": req, "shipment": shipment,
                       "donor": rep.engine.engine_id, "pool": rep.role,
                       "t0": _clock.now(),
                       # the wire closure: everything about the delivery
                       # is pre-bound at sweep time except the target,
                       # chosen per attempt (the decode pool may change
                       # between retries)
                       "wire": functools.partial(
                           ship_shipment, shipment, rep.engine.engine_id,
                           donor_pool=rep.role)}
                self._attempt_ship(job, 0, now)
        depth = n_tick + sum(1 for e in self._retry if e[3] is not None)
        if depth > self.stats["ship_queue_depth"]:
            self.stats["ship_queue_depth"] = depth
        return any_work

    def _attempt_ship(self, job: dict, attempt: int, now: float) -> None:
        """One delivery attempt of a prefill->decode handoff. Wire or
        adopter failure (and a delivery landing past the per-shipment
        deadline) re-queues on the deterministic backoff; exhaustion
        falls back to colocated serving — the request is never
        dropped."""
        req = job["req"]
        if req.aborted:
            return
        if self._expired(req, now):
            self._drop(req, "n_deadline_dropped")
            return
        target = self._choose(req, now, role="decode")
        if target is None:          # nothing alive anywhere right now
            self._queue_ship_retry(job, attempt + 1, now)
            return
        res = {"status": "ok", "pages": 0, "bytes": 0, "adopt_ms": 0.0}
        if job["shipment"] is not None and self.migration:
            res = job["wire"](target.engine)
        self.stats["wire_adopt_ms"] += res.get("adopt_ms", 0.0)
        late = (self.ship_deadline > 0
                and _clock.now() - job["t0"] > self.ship_deadline)
        if res["status"] in ("dropped", "rejected", "failed") or late:
            if res["status"] in ("dropped", "rejected", "failed"):
                # full-literal keys for TPL010 metrics hygiene
                self.stats["migration_dropped"
                           if res["status"] == "dropped"
                           else "migration_rejected"
                           if res["status"] == "rejected"
                           else "migration_failed"] += 1
            self.stats["n_ship_retries"] += 1
            self._queue_ship_retry(job, attempt + 1, now)
            return
        self.stats["disagg_shipped_pages"] += res["pages"]
        self.stats["disagg_ship_bytes"] += res["bytes"]
        self.stats["shipped_bytes"] += res["bytes"]
        if res["pages"]:
            self.stats["n_handoffs"] += 1
        self._deliver(req, target)

    def _queue_ship_retry(self, job: dict, attempt: int,
                          now: float) -> None:
        """Backoff for ship jobs — same deterministic exponential ladder
        as placement retries. Exhaustion (attempts past
        ``serving_fleet_retry_max``, or the shipment past its
        ``serving_disagg_ship_deadline``) is the second pool-death
        signal: degrade to colocated and deliver by re-prefill."""
        req = job["req"]
        expired = (self.ship_deadline > 0
                   and _clock.now() - job["t0"] > self.ship_deadline)
        if attempt > self.retry_max or expired:
            if expired:
                self.stats["n_ship_deadline"] += 1
            self.stats["n_retry_exhausted"] += 1
            self._decode_phase.add(req.rid)
            if self.disagg and not self.degraded:
                self._set_degraded()
            self._deliver_fallback(req, now)
            return
        delay = (0.0 if attempt == 0
                 else self.retry_base_delay * (2.0 ** (attempt - 1)))
        self._retry.append([_clock.now() + delay, attempt, req, job])

    def _deliver(self, req: Request, target: _Replica) -> None:
        """Re-submit the request on the decode target: it re-prefills
        prompt + emitted history through the just-adopted pages and the
        stream continues bit-identically from the first generated
        token."""
        try:
            target.engine.submit(req)
        except ValueError:
            self._drop(req, "n_shed")   # can never fit on this fleet
            return
        self._owner[req.rid] = target
        if not req.out_tokens and req.t_first is None:
            req.param_version = target.engine.param_version
        self._decode_phase.add(req.rid)
        if self.affinity and req.session is not None:
            self._sessions[req.session] = target.engine.engine_id

    def _deliver_fallback(self, req: Request, now: float) -> None:
        """Colocated fallback after shipment exhaustion: submit to any
        live engine (no pages shipped — re-prefill through whatever the
        prefix cache holds does the work; the stream is identical, the
        cost is FLOPs). No live engine at all -> placement retry
        queue."""
        if self._expired(req, now):
            self._drop(req, "n_deadline_dropped")
            return
        target = self._choose(req, now)
        if target is None:
            self._queue_retry(req, 0)
            return
        self._deliver(req, target)

    # -- death + recovery -------------------------------------------------

    def _declare_dead(self, rep: _Replica, now: float,
                      reason: str = "engine-death") -> None:
        rep.alive = False
        self.stats["n_killed"] += 1
        _obs.instant("fleet.death", engine=rep.engine.engine_id,
                     reason=reason, error=rep.last_error)
        e = rep.engine
        resident = [(s, r) for s, r in enumerate(e.slots)
                    if r is not None and not r.aborted
                    and len(r.out_tokens) < r.max_new_tokens]
        queued = [r for r in e.queue
                  if not r.aborted
                  and len(r.out_tokens) < r.max_new_tokens]
        # shipments exported but not yet picked up die with the donor
        # (the payload is the donor's host memory): those requests are
        # accepted streams — recover them by plain re-admission, the
        # decode-pool re-prefill rebuilds what the lost pages held
        shipped = [r for r, _sh in e.outbox
                   if not r.aborted
                   and len(r.out_tokens) < r.max_new_tokens]
        e.outbox = []
        for r in shipped:
            self._decode_phase.add(r.rid)
        for _s, r in resident:
            if r.out_tokens:       # an accepted stream: time its resume
                self._recovering.append([r, len(r.out_tokens),
                                         _clock.now()])
        for r in shipped:
            self._recovering.append([r, len(r.out_tokens),
                                     _clock.now()])
        for rid in ([r.rid for _s, r in resident]
                    + [r.rid for r in queued]
                    + [r.rid for r in shipped]):
            if self._owner.get(rid) is rep:
                del self._owner[rid]
        victims = ([r for _s, r in resident] + shipped
                   + sorted(queued, key=lambda r: (-r.priority, r.arrival)))
        victims = self._shed_for_pressure(victims, now)
        for req in victims:
            req.age = 0            # re-admission ages afresh
            if self._expired(req, now):
                self._drop(req, "n_deadline_dropped")
                continue
            if self.disagg and req.out_tokens:
                # an accepted stream is decode-phase wherever it died
                self._decode_phase.add(req.rid)
            target = self._choose(req, now, self._role_for(req))
            if target is None:
                self._queue_retry(req, 0)
                continue
            if self.migration and req.out_tokens:
                # ship the victim's full pages donor -> target BEFORE
                # re-admission so its re-prefill runs through the cache.
                # Any wire/adopter failure just means re-prefill does
                # the work — streams are identical either way.
                with _obs.span("fleet.migrate",
                               engine=target.engine.engine_id,
                               rid=req.rid, donor=e.engine_id):
                    res = ship_pages(e, target.engine, req.rid)
                _obs.lifecycle(req.rid, "migrate",
                               engine=target.engine.engine_id,
                               donor=e.engine_id, pages=res["pages"],
                               status=res["status"])
                self.stats["migrated_pages"] += res["pages"]
                self.stats["migration_bytes"] += res["bytes"]
                self.stats["shipped_bytes"] += res["bytes"]
                self.stats["wire_adopt_ms"] += res.get("adopt_ms", 0.0)
                if res["status"] in ("dropped", "rejected", "failed"):
                    # full-literal keys (TPL010 metrics hygiene: every
                    # written stats key is statically checkable against
                    # the declared schema)
                    self.stats["migration_dropped"
                               if res["status"] == "dropped"
                               else "migration_rejected"
                               if res["status"] == "rejected"
                               else "migration_failed"] += 1
            try:
                target.engine.submit(req)
            except ValueError:
                self._drop(req, "n_shed")   # can never fit on survivors
                continue
            self._owner[req.rid] = target
            if not req.out_tokens and req.t_first is None:
                req.param_version = target.engine.param_version
            if self.affinity and req.session is not None:
                self._sessions[req.session] = target.engine.engine_id
        # postmortem artifact: the ring now holds the death, every
        # migration span, and any chaos fault that caused it
        _obs.flight_dump(reason, detail=rep.last_error)

    def _shed_for_pressure(self, victims: list, now: float) -> list:
        """Graceful degradation under ``serving_fleet_shed_backlog``:
        when the fleet's never-accepted backlog (victims + every live
        queue + the retry queue, in pages) exceeds the factor times
        surviving pool capacity, shed lowest-priority latest-arrival
        never-accepted requests until it fits. Accepted streams
        (anything with an emitted token or a recorded TTFT) are never
        shed. Returns the surviving victims."""
        if self.shed_backlog <= 0 or not self._alive():
            return victims
        cap = sum(r.engine.n_pages - 1 for r in self._alive())

        def pages_needed(r, e) -> int:
            return -(-(len(r.prompt) + r.max_new_tokens) // e.bs)

        bs_engine = self._alive()[0].engine
        backlog = []
        for r in victims:
            if r.t_first is None and not r.out_tokens:
                backlog.append((r, None))
        for rep in self._alive():
            for r in rep.engine.queue:
                if r.t_first is None and not r.out_tokens:
                    backlog.append((r, rep))
        for _rdy, _att, r, _job in self._retry:
            if (r.t_first is None and not r.out_tokens
                    and not r.aborted):
                backlog.append((r, None))
        demand = sum(pages_needed(r, bs_engine) for r, _ in backlog)
        limit = int(self.shed_backlog * cap)
        if demand <= limit:
            return victims
        shed_rids = set()
        # lowest priority first, youngest (latest arrival) within a
        # class — mirrors the engine's own preemption victim order
        for r, rep in sorted(backlog,
                             key=lambda t: (t[0].priority, -t[0].arrival)):
            if demand <= limit:
                break
            demand -= pages_needed(r, bs_engine)
            shed_rids.add(r.rid)
            if rep is not None:
                rep.engine.abort(r.rid)
                self._owner.pop(r.rid, None)
                self.stats["n_shed"] += 1
            else:
                self._retry = [e2 for e2 in self._retry
                               if e2[2].rid != r.rid]
                self._drop(r, "n_shed")
        return [r for r in victims if r.rid not in shed_rids]

    # -- observability ----------------------------------------------------

    def health(self) -> list[dict]:
        out = []
        for rep in self.replicas:
            e = rep.engine
            out.append({
                "engine": e.engine_id, "alive": rep.alive,
                "role": rep.role,
                "version": e.param_version,
                "draining": rep.draining,
                "failures": rep.failures,
                "last_step_ms": round(rep.last_step_s * 1000.0, 3),
                "last_error": rep.last_error,
                "free_pages": len(e.pool.free),
                "resident": sum(1 for s in e.slots if s is not None),
                "queued": len(e.queue),
            })
        return out

    def page_accounting(self) -> dict:
        """Per-engine censuses plus the fleet-wide sum; each engine's
        ``total`` must equal its ``n_pages - 1`` (dead engines' frozen
        pools included — death loses a replica, not the invariant)."""
        per = {r.engine.engine_id: r.engine.page_accounting()
               for r in self.replicas}
        fleet: dict[str, int] = {}
        for acc in per.values():
            for k, v2 in acc.items():
                fleet[k] = fleet.get(k, 0) + v2
        expected = sum(r.engine.n_pages - 1 for r in self.replicas)
        return {"engines": per, "fleet": fleet, "expected": expected}

    def fleet_stats(self) -> dict:
        rms = self._recovery_ms
        dms = self._degraded_ms
        alive = self._alive()
        n_pre = sum(1 for r in alive if r.role == "prefill")
        out = {
            "fleet_n_engines": len(self.replicas),
            "fleet_n_alive": len(alive),
            "fleet_n_prefill": n_pre,
            "fleet_n_decode": sum(1 for r in alive
                                  if r.role == "decode"),
            "disagg_degraded": 1 if self.degraded else 0,
            # longest completed degraded episode, kill -> re-split
            "disagg_recovery_ms": round(max(dms), 3) if dms else 0.0,
            "recovery_ms_max": round(max(rms), 3) if rms else 0.0,
            "recovery_ms_mean": round(sum(rms) / len(rms), 3)
            if rms else 0.0,
            **self.stats,
        }
        out["wire_adopt_ms"] = round(out["wire_adopt_ms"], 3)
        # donor-side export cost lives on the engines; sum it here so
        # summarize_fleet sees one fleet-wide number next to adopt_ms
        out["wire_export_ms"] = round(
            sum(r.engine.stats.get("wire_export_ms", 0.0)
                for r in self.replicas), 3)
        out["split_ratio"] = (round(n_pre / len(alive), 3)
                              if self.disagg and alive else 0.0)
        out["split_trajectory"] = list(self._split_traj)
        # zero-downtime operations: longest single drain->swap->canary
        # episode (the rollout's availability cost), live engine-count
        # envelope, and the distinct weight versions still serving
        out["rollout_stall_ms"] = round(self._rollout_stall_ms, 3)
        out["rollout_ms"] = round(out["rollout_ms"], 3)
        out["autoscale_n_engines_min"] = self._n_eng_min
        out["autoscale_n_engines_max"] = self._n_eng_max
        out["fleet_versions"] = sorted(
            {r.engine.param_version for r in alive
             if r.engine.param_version is not None})
        return out
