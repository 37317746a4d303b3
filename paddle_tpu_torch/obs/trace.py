"""Host-side span tracer with Chrome trace-event export.

A :class:`Tracer` records begin/end span pairs, instant events and
request-lifecycle async events into one bounded per-process ring
(``collections.deque(maxlen=capacity)`` — the flight recorder IS this
ring: the last N events survive, older ones fall off). Export produces
the Chrome trace-event JSON object format (``{"traceEvents": [...]}``),
loadable in Perfetto / ``chrome://tracing``:

- duration spans: ``ph "B"`` / ``ph "E"`` pairs per track;
- instants: ``ph "i"`` (thread-scoped);
- request lifecycle: async ``ph "b"`` (arrival) / ``"n"`` (admit,
  first-token, preempt, migrate, ship, adopt) / ``"e"`` (done) events
  sharing ``cat="req"`` and ``id=<rid>``, stitched fleet-wide across
  engine tracks;
- ``ph "M"`` metadata naming the process and one thread track per
  engine (track 0 is the host/fleet track).

Timestamps are microseconds on :mod:`paddle_tpu_torch.obs.clock` relative to
the tracer's construction. Export never mutates the ring: truncated
spans (a ``B`` whose ``E`` fell outside the ring or has not happened
yet) are closed with synthetic ``E``/``e`` events carrying
``args.truncated`` so the JSON always balances.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Optional

from . import clock

__all__ = ["Tracer"]


class _Span:
    """Reusable ``with`` guard emitting one B/E pair on a tracer."""

    __slots__ = ("_tr", "_name", "_tid", "_attrs")

    def __init__(self, tr: "Tracer", name: str, tid: int,
                 attrs: Optional[dict]):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._tr.begin(self._name, tid=self._tid, attrs=self._attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tr.end(self._name, tid=self._tid,
                     error=None if exc_type is None else exc_type.__name__)
        return False


class Tracer:
    """Bounded in-memory event ring + Chrome trace-event exporter."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.t0 = clock.now()
        self.n_emitted = 0
        self._lock = threading.Lock()

    # -- emission ---------------------------------------------------------

    def _ts(self) -> float:
        return (clock.now() - self.t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)
            self.n_emitted += 1

    def begin(self, name: str, tid: int = 0,
              attrs: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "B", "ts": self._ts(), "pid": 0,
              "tid": tid}
        if attrs:
            ev["args"] = dict(attrs)
        self._emit(ev)

    def end(self, name: str, tid: int = 0,
            error: Optional[str] = None) -> None:
        ev = {"name": name, "ph": "E", "ts": self._ts(), "pid": 0,
              "tid": tid}
        if error is not None:
            ev["args"] = {"error": error}
        self._emit(ev)

    def span(self, name: str, tid: int = 0,
             attrs: Optional[dict] = None) -> _Span:
        return _Span(self, name, tid, attrs)

    def instant(self, name: str, tid: int = 0,
                attrs: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": self._ts(), "pid": 0,
              "tid": tid, "s": "t"}
        if attrs:
            ev["args"] = dict(attrs)
        self._emit(ev)

    def async_event(self, name: str, id_: int, ph: str, tid: int = 0,
                    attrs: Optional[dict] = None) -> None:
        """One lifecycle event: ``ph`` is ``"b"`` (start), ``"n"``
        (instant) or ``"e"`` (end); events sharing (cat, id) stitch into
        one flow across tracks."""
        if ph not in ("b", "n", "e"):
            raise ValueError(f"async ph must be b/n/e, got {ph!r}")
        ev = {"name": name, "ph": ph, "ts": self._ts(), "pid": 0,
              "tid": tid, "cat": "req", "id": int(id_)}
        if attrs:
            ev["args"] = dict(attrs)
        self._emit(ev)

    # -- export -----------------------------------------------------------

    def _metadata(self, tids) -> list:
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "paddle_tpu_torch"}}]
        for t in sorted(tids):
            label = "host" if t == 0 else f"engine {t - 1}"
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": t, "args": {"name": label}})
        return meta

    def _balanced(self, evs: list) -> list:
        """Close truncated spans so B/E pairs and async b/e ids always
        balance: an E with no open B on its track is dropped (its B
        fell off the ring), an open B/b at the end gets a synthetic
        closer tagged ``truncated``."""
        out: list = []
        open_b: dict = {}          # tid -> [name, ...] stack
        open_async: dict = {}      # (name, id) -> count
        last_ts = 0.0
        for ev in evs:
            last_ts = max(last_ts, ev["ts"])
            ph = ev["ph"]
            if ph == "B":
                open_b.setdefault(ev["tid"], []).append(ev["name"])
            elif ph == "E":
                stack = open_b.get(ev["tid"])
                if not stack:
                    continue       # orphan E: its B left the ring
                stack.pop()
            elif ph == "b":
                key = (ev["name"], ev["id"])
                open_async[key] = open_async.get(key, 0) + 1
            elif ph == "e":
                key = (ev["name"], ev["id"])
                if not open_async.get(key):
                    continue       # orphan e: its b left the ring
                open_async[key] -= 1
            out.append(ev)
        for tid, stack in sorted(open_b.items()):
            for name in reversed(stack):
                out.append({"name": name, "ph": "E", "ts": last_ts,
                            "pid": 0, "tid": tid,
                            "args": {"truncated": True}})
        for (name, id_), n in sorted(open_async.items(),
                                     key=lambda kv: kv[0][1]):
            for _ in range(n):
                out.append({"name": name, "ph": "e", "ts": last_ts,
                            "pid": 0, "tid": 0, "cat": "req", "id": id_,
                            "args": {"truncated": True}})
        return out

    def export(self, path: Optional[str] = None) -> dict:
        """The Chrome trace-event object; written to ``path`` as JSON
        when given. Does not consume or mutate the ring."""
        with self._lock:
            evs = [dict(e) for e in self.events]
        evs = self._balanced(evs)
        tids = {e.get("tid", 0) for e in evs}
        doc = {"traceEvents": self._metadata(tids) + evs,
               "displayTimeUnit": "ms",
               "otherData": {"n_emitted": self.n_emitted,
                             "capacity": self.capacity}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
