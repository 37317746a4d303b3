"""The serving fleet's observability plane: span tracing, metrics and
the flight recorder (the port's copy of paddle_tpu/obs), plus the one
duration clock (``clock``) and the kernel timing scripts.

Armed or not follows the ``testing.chaos`` pattern: one module global,
one load on the disarmed path, and no effect on any computed stream
either way: tracing observes host control flow only, never a device
program, a random key or a scheduling decision.

Hot paths guard on ``active()`` as chaos probes do::

    if _obs.active():
        with _obs.span("engine.step", engine=self.engine_id):
            ...

Cold paths call the helpers unconditionally (each is a no-op when
disarmed): ``lifecycle(rid, "first-token", engine=...)``,
``flight_dump("engine-death", detail=...)``.

Arming: ``arm()``, or ``FLAGS_obs_trace=1`` picked up by
``arm_from_flags()`` in the engine's and the router's constructors.
While armed, chaos faults that fire are annotated into the trace.
``export(path)`` writes Chrome trace-event JSON (Perfetto,
``chrome://tracing``).
"""

from __future__ import annotations

from typing import Optional

from ..core.flags import GLOBAL_FLAGS
from ..testing import chaos as _chaos

from . import clock, flight as _flight
from .metrics import (FLEET_STATS_SCHEMA, MetricsRegistry,
                      SERVING_STATS_SCHEMA)
from .trace import Tracer

__all__ = ["active", "arm", "arm_from_flags", "disarm", "span",
           "instant", "lifecycle", "flight_dump", "export", "tracer",
           "registry", "clock", "Tracer", "MetricsRegistry",
           "SERVING_STATS_SCHEMA", "FLEET_STATS_SCHEMA"]


class _NoopSpan:
    """Shared reusable ``with`` guard for the disarmed path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


class _ObsState:
    """Everything one armed session owns."""

    def __init__(self, capacity: int, dump_dir: str):
        self.tracer = Tracer(capacity)
        self.registry = MetricsRegistry()
        self.faults: list = []          # chaos specs that actually fired
        self.dump_dir = dump_dir
        self.dumps: list = []           # flightrec paths written


_armed: Optional[_ObsState] = None


def _tid(engine) -> int:
    """Trace track for an engine id: track 0 is the host/fleet track,
    engine N lives on track N+1."""
    return 0 if engine is None else int(engine) + 1


def _on_chaos_fire(point: str, spec, ctx, invocation: int) -> None:
    """Chaos observer: a fault actually fired — annotate the trace and
    remember it for the flight recorder."""
    st = _armed
    if st is None:
        return
    rec = {"point": point, "kind": spec.kind,
           "args": {k: v for k, v in spec.args.items()},
           "ctx": dict(ctx or {}), "invocation": invocation}
    st.faults.append(rec)
    st.tracer.instant("chaos." + point,
                      tid=_tid((ctx or {}).get("engine")),
                      attrs={"kind": spec.kind, "invocation": invocation,
                             **{f"ctx.{k}": str(v)
                                for k, v in (ctx or {}).items()}})


# -- arming ------------------------------------------------------------------

def active() -> bool:
    return _armed is not None


def arm(capacity: Optional[int] = None,
        dump_dir: Optional[str] = None) -> _ObsState:
    """Activate tracing process-wide (replaces any armed session)."""
    global _armed
    if capacity is None:
        capacity = int(GLOBAL_FLAGS.get("obs_buffer_events"))
    if dump_dir is None:
        dump_dir = str(GLOBAL_FLAGS.get("obs_dir"))
    _armed = _ObsState(capacity, dump_dir)
    _chaos.add_observer(_on_chaos_fire)
    return _armed


def disarm() -> None:
    global _armed
    _armed = None
    _chaos.remove_observer(_on_chaos_fire)


def arm_from_flags() -> bool:
    """Arm iff the ``obs_trace`` flag is set (the constructors of
    ServingEngine and FleetRouter call this, so ``FLAGS_obs_trace=1``
    traces any entry point). Idempotent; returns whether tracing is
    armed afterwards."""
    if _armed is not None:
        return True
    if not GLOBAL_FLAGS.get("obs_trace"):
        return False
    arm(capacity=int(GLOBAL_FLAGS.get("obs_buffer_events")),
        dump_dir=str(GLOBAL_FLAGS.get("obs_dir")))
    return True


# -- recording ---------------------------------------------------------------

def span(name: str, engine=None, **attrs):
    """``with obs.span("engine.step", engine=0):`` — a no-op shared
    guard when disarmed (one global load), a B/E pair on the engine's
    track when armed."""
    st = _armed
    if st is None:
        return _NOOP
    if engine is not None:
        attrs["engine"] = engine
    return st.tracer.span(name, tid=_tid(engine), attrs=attrs or None)


def instant(name: str, engine=None, **attrs) -> None:
    st = _armed
    if st is None:
        return
    if engine is not None:
        attrs["engine"] = engine
    st.tracer.instant(name, tid=_tid(engine), attrs=attrs or None)


_LIFECYCLE_PH = {"arrival": "b", "done": "e"}


def lifecycle(rid: int, event: str, engine=None, **attrs) -> None:
    """One request-lifecycle event: ``arrival`` opens the async flow
    (ph ``b``), ``done`` closes it (ph ``e``), everything between
    (admit, first-token, preempt, migrate, ship, adopt, ...) is an
    async instant (ph ``n``) — all sharing ``id=rid`` so Perfetto
    stitches the flow across engine tracks."""
    st = _armed
    if st is None:
        return
    attrs["event"] = event
    if engine is not None:
        attrs["engine"] = engine
    st.tracer.async_event("req", rid, _LIFECYCLE_PH.get(event, "n"),
                          tid=_tid(engine), attrs=attrs)


# -- artifacts ---------------------------------------------------------------

def flight_dump(reason: str, detail: Optional[str] = None) -> Optional[str]:
    """Dump the ring on a death path; returns the flightrec path, or
    None when disarmed."""
    st = _armed
    if st is None:
        return None
    st.tracer.instant("flightrec.dump", attrs={"reason": reason})
    path = _flight.dump(st.tracer, reason, detail=detail,
                        faults=st.faults, registry=st.registry,
                        dump_dir=st.dump_dir)
    st.dumps.append(path)
    return path


def export(path: Optional[str] = None) -> Optional[dict]:
    """Chrome trace-event JSON of the armed tracer (None when
    disarmed)."""
    st = _armed
    if st is None:
        return None
    return st.tracer.export(path)


def tracer() -> Optional[Tracer]:
    return _armed.tracer if _armed is not None else None


def registry() -> Optional[MetricsRegistry]:
    return _armed.registry if _armed is not None else None
