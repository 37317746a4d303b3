"""Flight recorder: dump the tracer ring + fault log + metrics snapshot
on a death path.

Every terminal event the fleet survives — engine failure or hang, pool
death — calls :func:`paddle_tpu_torch.obs.flight_dump`, which lands
here: one ``<obs_dir>/flightrec-<seq>-<reason>.json`` per death holding
the last N trace events (the tracer ring IS the flight ring), every
chaos fault that actually fired (so a chaos-CI failure ships its own
postmortem naming the injected fault), and a metrics snapshot. The dump
is append-only evidence: it never consumes the ring, so several deaths
in one run produce several overlapping dumps.
"""

from __future__ import annotations

import itertools
import json
import os
import re
from typing import Optional

__all__ = ["dump"]

_seq = itertools.count()


def _slug(reason: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", reason.lower()).strip("-") or "x"


def dump(tracer, reason: str, detail: Optional[str] = None,
         faults: Optional[list] = None, registry=None,
         dump_dir: str = "artifacts") -> str:
    """Write one flight-recorder JSON; returns its path."""
    os.makedirs(dump_dir, exist_ok=True)
    doc = {
        "schema": "paddle_tpu_torch.flightrec.v1",
        "reason": reason,
        "detail": detail,
        "faults": [dict(f) for f in (faults or [])],
        "metrics": registry.snapshot() if registry is not None else {},
        "trace": (tracer.export() if tracer is not None
                  else {"traceEvents": []}),
    }
    path = os.path.join(
        dump_dir, f"flightrec-{next(_seq):04d}-{_slug(reason)}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
