"""Deterministic fault injection for the serving fleet (the port's copy
of paddle_tpu/testing/chaos.py).

A *fault plan* is a seeded list of :class:`FaultSpec`s, each naming an
injection point (``"engine.step"``), when it fires (at the Nth
invocation, with a probability per invocation, or every time) and a
kind the site interprets. Host code carries ``fire(point)`` probes; the
serving hot paths guard each behind ``active()``, so with no plan armed
a probe costs one global load. Nothing here touches a device.

Injection points of the port and the kinds they honor:

====================  ======================================================
point                 kinds
====================  ======================================================
``engine.step``       ``raise`` (ChaosInjected out of ServingEngine.step:
                      the router sees a dead replica), ``hang`` (sleep
                      ``seconds``; the router's step budget catches it).
                      ``pool="prefill"`` with ``once=False`` kills every
                      engine of a disaggregated pool role
``pool.alloc``        ``fail`` (page allocation reports an empty pool)
``migration.ship``    ``drop`` (shipment lost on the wire), ``corrupt``
                      (one payload byte flipped; the adopter's crc rejects
                      it), ``stall`` (sleep ``seconds`` before delivery)
``migration.adopt``   ``fail`` (the adopter refuses before staging)
``migration.stage``   ``drop`` (an overlapped-wire donor's staging buffer
                      is lost at finalize), ``corrupt`` (a payload byte
                      flipped after the crcs are computed). Pool-scoped
``migration.commit``  ``raise`` (ChaosInjected out of commit_adopt before
                      any state moves). Pool-scoped
====================  ======================================================

Targeting: a probe passes a ``ctx`` dict (``{"engine": 0, "pool":
"decode"}``); every key present in both ``spec.args`` and ``ctx`` must
match (compared as strings) or the spec is skipped, and a spec carrying
``pool`` never matches a probe that reports no pool. ``at=N`` counts
invocations per (point, ctx) pair, so "the 7th step of engine 0" is
engine 0's own 7th step. ``rank=<r>`` restricts a spec to the process
whose ``PADDLE_TRAINER_ID`` / ``RANK`` is r.

Determinism: probabilistic specs draw from a ``random.Random`` seeded
from (plan seed, point, kind, index), so a plan gives the same schedule
every run. ``plan.to_env()`` returns ``{"PT_CHAOS_PLAN": <json>}``, and
a process importing this module with that variable set arms the plan.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import zlib
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["FaultSpec", "FaultPlan", "ChaosInjected", "arm", "disarm",
           "active", "fire", "raise_fault", "arm_from_env", "PLAN_ENV",
           "add_observer", "remove_observer"]

logger = logging.getLogger("paddle_tpu_torch.testing.chaos")

PLAN_ENV = "PT_CHAOS_PLAN"


class ChaosInjected(Exception):
    """An injected fault with no more specific exception type."""


def _env_rank() -> int:
    """This process's rank (``PADDLE_TRAINER_ID`` / ``RANK``), for
    rank-targeted faults; read at every check."""
    return int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("RANK", "0")) or 0)


@dataclass
class FaultSpec:
    """One scheduled fault.

    ``at``: fire at the Nth invocation of the point (0-based), once.
    ``prob``: else fire per-invocation with this probability.
    ``once``: at most one firing total (default True; ``False`` with
    neither ``at`` nor ``prob`` means *every* invocation fires).
    ``args``: site parameters (e.g. ``seconds`` for hangs, ``code`` for
    exits); ``rank`` restricts the spec to one trainer rank of a fleet.
    """

    point: str
    kind: str
    at: Optional[int] = None
    prob: float = 0.0
    once: bool = True
    args: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"point": self.point, "kind": self.kind, "at": self.at,
                "prob": self.prob, "once": self.once, "args": self.args}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(point=d["point"], kind=d["kind"], at=d.get("at"),
                   prob=d.get("prob", 0.0), once=d.get("once", True),
                   args=d.get("args") or {})


class FaultPlan:
    """A named, seeded set of faults, serializable through one env var."""

    def __init__(self, seed: int = 0, name: str = "chaos"):
        self.seed = int(seed)
        self.name = name
        self.faults: list[FaultSpec] = []

    def add(self, point: str, kind: str, at: Optional[int] = None,
            prob: float = 0.0, once: bool = True, **args) -> "FaultPlan":
        self.faults.append(FaultSpec(point, kind, at=at, prob=prob,
                                     once=once, args=args))
        return self

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "name": self.name,
                           "faults": [f.to_dict() for f in self.faults]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        plan = cls(seed=d.get("seed", 0), name=d.get("name", "chaos"))
        plan.faults = [FaultSpec.from_dict(f) for f in d.get("faults", [])]
        return plan

    def to_env(self) -> dict:
        """Environment mapping that arms this plan in a child process."""
        return {PLAN_ENV: self.to_json()}


class _ArmedPlan:
    """Runtime state of an armed plan: invocation counters per point,
    fired-flags per spec, and a deterministic RNG per probabilistic
    spec."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._fired: set[int] = set()
        self._rngs: dict[int, random.Random] = {}
        self._by_point: dict[str, list[tuple[int, FaultSpec]]] = {}
        for i, spec in enumerate(plan.faults):
            self._by_point.setdefault(spec.point, []).append((i, spec))

    def _rng(self, i: int, spec: FaultSpec) -> random.Random:
        rng = self._rngs.get(i)
        if rng is None:
            salt = zlib.crc32(f"{spec.point}|{spec.kind}|{i}".encode())
            rng = self._rngs[i] = random.Random(self.plan.seed ^ salt)
        return rng

    def check(self, point: str,
              ctx: Optional[dict] = None) -> Optional[FaultSpec]:
        specs = self._by_point.get(point)
        if specs is None:
            return None
        key = point if not ctx else (
            point + "|" + repr(sorted((k, str(v)) for k, v in ctx.items())))
        with self._lock:
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            for i, spec in specs:
                if spec.once and i in self._fired:
                    continue
                want_rank = spec.args.get("rank")
                if want_rank is not None and int(want_rank) != _env_rank():
                    continue
                # pool-scoped specs only match probes that report a pool
                # role: a pool=<role> kill can never hit a colocated
                # (pool-less) engine by accident
                if "pool" in spec.args and (not ctx or "pool" not in ctx):
                    continue
                if ctx and any(str(spec.args[k]) != str(v)
                               for k, v in ctx.items() if k in spec.args):
                    continue
                if spec.at is not None:
                    hit = n == spec.at
                elif spec.prob > 0.0:
                    hit = self._rng(i, spec).random() < spec.prob
                else:
                    hit = True
                if hit:
                    self._fired.add(i)
                    logger.warning("chaos[%s]: firing %s(%s) at "
                                   "invocation %d of %s", self.plan.name,
                                   spec.kind, spec.args, n, point)
                    for cb in list(_observers):
                        try:
                            cb(point, spec, ctx, n)
                        except Exception:
                            logger.exception("chaos observer %r failed",
                                             cb)
                    return spec
        return None


_armed: Optional[_ArmedPlan] = None

# fault observers: called as cb(point, spec, ctx, invocation) ONLY when a
# spec actually fires (the cold path — the disarmed probe cost is
# untouched). The observability plane registers one to annotate injected
# faults into the trace / flight recorder.
_observers: list = []


def add_observer(cb) -> None:
    if cb not in _observers:
        _observers.append(cb)


def remove_observer(cb) -> None:
    try:
        _observers.remove(cb)
    except ValueError:
        pass


def arm(plan: FaultPlan) -> None:
    """Activate ``plan`` process-wide (replaces any armed plan)."""
    global _armed
    _armed = _ArmedPlan(plan)


def disarm() -> None:
    global _armed
    _armed = None


def active() -> bool:
    return _armed is not None


def fire(point: str, ctx: Optional[dict] = None) -> Optional[FaultSpec]:
    """The probe production code calls: returns the fault that fires at
    this invocation of ``point``, or None. Zero-cost when disarmed.
    ``ctx`` narrows matching to specs whose args agree on every shared
    key (see "In-process targeting" above); serving hot paths guard the
    call itself behind ``chaos.active()`` so the disarmed cost stays a
    single global load."""
    if _armed is None:
        return None
    return _armed.check(point, ctx)


_EXC_FOR_KIND = {
    "timeout": TimeoutError,
    "refuse": ConnectionRefusedError,
    "flaky": ConnectionError,
}


def raise_fault(point: str) -> None:
    """Fire ``point`` and raise the exception matching the fault kind
    (TimeoutError / ConnectionRefusedError / ConnectionError /
    ChaosInjected); no-op when nothing fires."""
    spec = fire(point)
    if spec is None:
        return
    exc = _EXC_FOR_KIND.get(spec.kind, ChaosInjected)
    raise exc(f"chaos: injected {spec.kind} at {point}")


def arm_from_env() -> bool:
    """Arm from ``PT_CHAOS_PLAN`` if set (child-worker path). Returns
    whether a plan was armed."""
    text = os.environ.get("PT_CHAOS_PLAN")
    if not text:
        return False
    arm(FaultPlan.from_json(text))
    return True


# a process started with plan.to_env() arms on import
arm_from_env()
