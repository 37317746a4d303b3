"""Open-loop drivers: arrival-faithful traffic against one ServingEngine
(:class:`OpenLoopDriver`) or a FleetRouter of N replicas
(:class:`FleetDriver`).

Open loop means arrivals NEVER wait for the service side — every request
is queued up front with its arrival stamp and the engine's admission
sees it the moment the (wall or virtual) clock passes the stamp, however
deep the backlog grows. This is the regime where a scheduler's occupancy
and tail latency mean something; a closed loop self-throttles to the
engine's pace and hides both.

Two clocks:

- ``wall`` (default): arrivals happen in real time, what a measurement
  on hardware wants.
- ``rush``: every request's arrival is treated as already-passed (the
  driver passes now = +inf). The queue is maximally deep from step 0 —
  deterministic saturation for CPU smoke tests, where real arrival
  pacing would be noise.

Abort injection: ``aborts`` maps a wall/step threshold to a rid; the
driver fires each abort the first step after its threshold passes,
exercising mid-flight teardown under load. ``FleetDriver`` adds
``kills`` with the same threshold semantics mapping to an engine id —
mid-run replica loss — or to the string ``"pool:<role>"``, which kills
every live engine of a disaggregated pool role at once (pool death;
the router degrades to colocated serving).

Deadlines: a request carrying ``deadline_ttft``/``deadline_e2e`` (> 0,
seconds from arrival) is aborted the first step after its budget lapses
without the corresponding event, and counted in ``n_deadline_expired``.
Wall clock only — under ``rush`` the virtual now is +inf, which would
expire everything instantly and mean nothing.
"""

from __future__ import annotations

import time
from typing import Optional

from ...obs import clock as _clock
from .metrics import summarize, summarize_fleet

__all__ = ["OpenLoopDriver", "FleetDriver"]


def _rebase_times(requests, t0: float) -> None:
    """Convert the engine's absolute-monotonic t_first/t_done stamps to
    driver-relative seconds, the timebase ``arrival`` already uses — so
    the TTFT/e2e percentiles in metrics.py measure what they claim."""
    for r in requests:
        if r.t_first is not None and r.t_first >= t0:
            r.t_first -= t0
        if r.t_done is not None and r.t_done >= t0:
            r.t_done -= t0


def _sweep_deadlines(requests, abort_fn, now: float) -> int:
    """Abort every live request past its TTFT/e2e budget; returns how
    many expired this sweep."""
    n = 0
    for r in requests:
        if (r.aborted or r.t_done is not None
                or len(r.out_tokens) >= r.max_new_tokens):
            continue
        miss_ttft = (r.deadline_ttft > 0 and r.t_first is None
                     and now > r.arrival + r.deadline_ttft)
        miss_e2e = (r.deadline_e2e > 0
                    and now > r.arrival + r.deadline_e2e)
        if miss_ttft or miss_e2e:
            abort_fn(r.rid)
            r.aborted = True               # even if already untracked
            n += 1
    return n


class OpenLoopDriver:
    def __init__(self, engine, clock: str = "wall"):
        if clock not in ("wall", "rush"):
            raise ValueError(f"unknown clock '{clock}'")
        self.engine = engine
        self.clock = clock

    def run(self, requests, aborts: Optional[dict] = None,
            max_steps: int = 0) -> dict:
        """Drive ``requests`` to completion; returns metrics.summarize().

        ``aborts``: {threshold: rid} — wall seconds ("wall" clock) or
        step index ("rush" clock) after which the rid is aborted.
        ``max_steps``: safety valve; 0 derives a generous bound from the
        workload (smoke tests fail loudly instead of hanging)."""
        eng = self.engine
        for r in sorted(requests, key=lambda r: r.arrival):
            eng.submit(r)
        eng.stats = {k: 0 for k in eng.stats}
        pending = sorted((aborts or {}).items())
        deadlined = (self.clock == "wall"
                     and [r for r in requests
                          if r.deadline_ttft > 0 or r.deadline_e2e > 0])
        n_deadline = 0
        if not max_steps:
            total = sum(r.max_new_tokens + len(r.prompt)
                        for r in requests)
            max_steps = 200 + 4 * total
        t0 = _clock.now()
        steps = 0
        while True:
            now = (1e18 if self.clock == "rush"
                   else _clock.now() - t0)
            gate = steps if self.clock == "rush" else now
            while pending and pending[0][0] <= gate:
                eng.abort(pending.pop(0)[1])
            if deadlined:
                n_deadline += _sweep_deadlines(deadlined, eng.abort, now)
            if not eng.step(now=now):
                break
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"open-loop driver: engine did not drain in "
                    f"{max_steps} steps")
            if self.clock == "wall" and not any(
                    s is not None for s in eng.slots) \
                    and eng._inflight is None and eng.queue:
                nxt = min(r.arrival for r in eng.queue)
                wait = max(0.0, nxt - (_clock.now() - t0))
                time.sleep(min(max(wait, 0.001), 0.05))
        wall = _clock.now() - t0
        if eng._deferred_free or eng.pool.pending_evict:
            eng.pool.release(eng._deferred_free)
            eng._deferred_free = []
            eng.pool.commit_evictable()
        _rebase_times(requests, t0)
        out = summarize(requests, eng, wall)
        out["steps"] = steps
        out["n_deadline_expired"] = n_deadline
        out["deadline_miss_rate"] = round(
            n_deadline / max(1, len(requests)), 3)
        return out


class FleetDriver:
    """Open-loop traffic against a :class:`~..fleet.FleetRouter`: same
    clock/abort semantics as OpenLoopDriver, plus deterministic mid-run
    replica ``kills`` and fleet metrics (goodput/TTFT across replicas,
    migrated pages, recovery latency, shed/deadline drops)."""

    def __init__(self, router, clock: str = "wall"):
        if clock not in ("wall", "rush"):
            raise ValueError(f"unknown clock '{clock}'")
        self.router = router
        self.clock = clock

    def run(self, requests, aborts: Optional[dict] = None,
            kills: Optional[dict] = None,
            deploys: Optional[dict] = None,
            max_steps: int = 0) -> dict:
        """``kills``: {threshold: engine_id | "pool:<role>"} with abort
        threshold semantics — the replica (or every live replica of the
        named disaggregated pool role) is killed (router recovery path)
        the first step after the threshold passes.

        ``deploys``: {threshold: params_tree | version_str} — a live
        weight rollout (``router.rollout``) fired mid-run with the same
        threshold semantics, so goodput/TTFT are measured THROUGH a
        deploy. A deploy landing while a previous rollout is still in
        flight waits for it (one rollout at a time)."""
        router = self.router
        for rep in router.replicas:
            rep.engine.stats = {k: 0 for k in rep.engine.stats}
        pending = sorted((aborts or {}).items())
        pending_kills = sorted((kills or {}).items())
        pending_deploys = sorted((deploys or {}).items(),
                                 key=lambda kv: kv[0])
        deadlined = (self.clock == "wall"
                     and [r for r in requests
                          if r.deadline_ttft > 0 or r.deadline_e2e > 0])
        n_deadline = 0
        if not max_steps:
            total = sum(r.max_new_tokens + len(r.prompt)
                        for r in requests)
            max_steps = 200 + 4 * total
        t0 = _clock.now()
        for r in sorted(requests, key=lambda r: r.arrival):
            router.submit(r, now=0.0 if self.clock == "wall" else 1e18)
        steps = 0
        while True:
            now = (1e18 if self.clock == "rush"
                   else _clock.now() - t0)
            gate = steps if self.clock == "rush" else now
            while pending and pending[0][0] <= gate:
                router.abort(pending.pop(0)[1])
            while pending_kills and pending_kills[0][0] <= gate:
                tgt = pending_kills.pop(0)[1]
                if isinstance(tgt, str) and tgt.startswith("pool:"):
                    router.kill_pool(tgt[len("pool:"):], now=now)
                else:
                    router.kill_engine(tgt, now=now)
            while (pending_deploys and pending_deploys[0][0] <= gate
                   and not router.rollout_active):
                tgt = pending_deploys.pop(0)[1]
                if isinstance(tgt, str):
                    router.rollout(version=tgt)
                else:
                    router.rollout(params=tgt)
            if deadlined:
                n_deadline += _sweep_deadlines(deadlined, router.abort,
                                               now)
            if not router.step(now=now):
                break
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"fleet driver: fleet did not drain in "
                    f"{max_steps} steps")
            if self.clock == "wall":
                live = [rep.engine for rep in router.replicas
                        if rep.alive]
                if live and all(
                        not any(s is not None for s in e.slots)
                        and e._inflight is None for e in live) \
                        and any(e.queue for e in live):
                    nxt = min(r.arrival for e in live for r in e.queue)
                    wait = max(0.0, nxt - (_clock.now() - t0))
                    time.sleep(min(max(wait, 0.001), 0.05))
        wall = _clock.now() - t0
        for rep in router.replicas:
            e = rep.engine
            if rep.alive and (e._deferred_free or e.pool.pending_evict):
                e.pool.release(e._deferred_free)
                e._deferred_free = []
                e.pool.commit_evictable()
        _rebase_times(requests, t0)
        out = summarize_fleet(requests, router, wall)
        out["steps"] = steps
        # fraction of fleet ticks spent in degraded colocated mode
        # (0.0 when disagg off or no pool ever died)
        out["degraded_frac"] = round(
            router.stats["degraded_steps"] / max(1, steps), 3)
        out["n_deadline_expired"] = n_deadline
        out["deadline_miss_rate"] = round(
            (n_deadline + router.stats["n_deadline_dropped"])
            / max(1, len(requests)), 3)
        return out
