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

Zero-downtime operations (rollout, autoscale, SLO shed) are a later
slice: their flags are defined, ``serving_fleet_autoscale`` and
``serving_fleet_slo_shed`` are refused when on, and ``rollout()``
raises. With them off the reference's router is this one.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ... import obs as _obs
from ...core.flags import GLOBAL_FLAGS
from ...obs import clock as _clock
from ..serving import Request, ServingEngine
from .migration import ship_pages, ship_shipment

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
                 autoscale: Optional[bool] = None,
                 slo_shed: Optional[bool] = None):
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
        # zero-downtime operations (a later slice): autoscale and SLO
        # shed are read only so that they can be refused when on
        self.autoscale = bool(g("serving_fleet_autoscale")
                              if autoscale is None else autoscale)
        self.slo_shed = bool(g("serving_fleet_slo_shed")
                             if slo_shed is None else slo_shed)
        for name, on in (("serving_fleet_autoscale", self.autoscale),
                         ("serving_fleet_slo_shed", self.slo_shed)):
            if on:
                raise NotImplementedError(
                    f"later slice: {name} is not ported yet (ROADMAP "
                    "Queue 1 item 3); only False is")
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
        return busy or bool(self._retry) or bool(self._recovering)

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
        new replica). A built engine shares replica 0's params dict (or
        takes ``params``/``version``) and its device unless
        ``engine_kwargs`` names one. In disaggregated mode it takes
        ``role`` (or the thinner live pool); a degraded fleet serves it
        colocated until the next census re-splits. Returns the new
        engine_id."""
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

    # -- zero-downtime operations: a later slice -------------------------

    def rollout(self, params=None, version: Optional[str] = None) -> str:
        """A rolling weight upgrade (drain, swap, canary, rejoin) is the
        next fleet slice's (ROADMAP, Queue 1 item 3)."""
        raise NotImplementedError(
            "FleetRouter.rollout is not ported yet (ROADMAP Queue 1 item 3: "
            "rollout, autoscale and SLO shed are the next fleet slice)")

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
                "draining": False,        # rollout is a later slice
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
        # zero-downtime operations (a later slice): the reference's keys,
        # with the live engine-count envelope and the versions serving
        out["rollout_stall_ms"] = 0.0
        out["rollout_ms"] = round(out["rollout_ms"], 3)
        out["autoscale_n_engines_min"] = self._n_eng_min
        out["autoscale_n_engines_max"] = self._n_eng_max
        out["fleet_versions"] = sorted(
            {r.engine.param_version for r in alive
             if r.engine.param_version is not None})
        return out
