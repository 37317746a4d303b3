"""KV page migration transport: donor export -> wire -> adopter (the
port's copy of paddle_tpu/inference/fleet/migration.py).

The engine does the work (``export_request_pages`` / ``adopt_pages``;
the wire format is described in ``inference/serving.py``): a KV page is
a function of (params, token prefix, page size, quant mode, adapter
digest), so replicas of one model can exchange page bytes. This module
moves a shipment between two engines of one process, carries the
``migration.ship`` chaos point (``drop``: lost; ``corrupt``: one payload
byte flipped, so the adopter's crc rejects it; ``stall``) and reports
pages, bytes and the adopter's wall milliseconds (``adopt_ms``).
Migration is never needed for correctness: every fallback re-prefills
the prompt and emitted history and lands on the same keyed
(seed, position) sampling stream.
"""

from __future__ import annotations

import time

import numpy as np

from ...obs import clock as _clock
from ...testing import chaos as _chaos

__all__ = ["ship_pages", "ship_shipment"]


def _adopt(target, shipment: dict, nbytes: int) -> dict:
    """Deliver ``shipment`` into ``target``'s pool and time the adopter's
    cost (on the overlapped wire the page writes wait for its next
    dispatch, so they are not in it)."""
    t0 = _clock.now()
    try:
        n = target.adopt_pages(shipment)
    except ValueError:
        # unconvertible mode/geometry mismatch: a wire-level rejection,
        # not a transport error — the router falls back to re-prefill
        n = 0
    ms = (_clock.now() - t0) * 1e3
    if n == 0:
        return {"status": "rejected", "pages": 0, "bytes": 0,
                "adopt_ms": ms}
    return {"status": "ok", "pages": n, "bytes": nbytes, "adopt_ms": ms}


def ship_pages(donor, target, rid: int) -> dict:
    """Ship request ``rid``'s full KV pages from ``donor`` to
    ``target``. Returns ``{"status", "pages", "bytes", "adopt_ms"}``
    where status is one of ``ok`` / ``nothing`` (no exportable full
    page) / ``dropped`` (chaos: lost on the wire) / ``rejected`` (crc
    or adopter refusal — includes chaos ``corrupt``/``migration.adopt``)
    / ``failed`` (donor-side export error: treat the donor HBM as
    unreadable)."""
    try:
        shipment = donor.export_request_pages(rid)
    except Exception:
        return {"status": "failed", "pages": 0, "bytes": 0,
                "adopt_ms": 0.0}
    if shipment is None:
        return {"status": "nothing", "pages": 0, "bytes": 0,
                "adopt_ms": 0.0}
    nbytes = donor.shipment_bytes(shipment)
    if _chaos.active():
        spec = _chaos.fire("migration.ship",
                           ctx={"engine": donor.engine_id})
        if spec is not None:
            if spec.kind == "drop":
                return {"status": "dropped", "pages": 0, "bytes": 0,
                        "adopt_ms": 0.0}
            if spec.kind == "corrupt":
                # a copy, kept in the job: retries reject too
                k = np.array(shipment["k"], copy=True)
                k.view(np.uint8).reshape(-1)[0] ^= 0xFF
                shipment["k"] = k
    return _adopt(target, shipment, nbytes)


def ship_shipment(shipment: dict, donor_id: int, target,
                  donor_pool: str = None) -> dict:
    """Ship an *already exported* shipment to ``target`` — the
    disaggregated prefill->decode handoff, where the donor exported at
    prefill completion and released the slot, so it may hold nothing
    for this rid by delivery time (or be dead). Same wire semantics and
    ``migration.ship`` chaos point as :func:`ship_pages`, plus the
    ``stall`` kind (sleep ``seconds`` on the wire before delivering —
    the router's per-shipment deadline decides whether the late pages
    still count) and a ``pool`` ctx tag when the donor had a pool role.

    Redelivery-safe: a shipment whose every page hash is already
    resident in the target's prefix cache is a zero-byte success
    (status ``ok``, 0 pages) — a retried delivery after a late-but-
    landed first attempt must not read as an adopter refusal. The check
    uses the TARGET's cache keyspace (``shipment_cache_hashes``), so a
    cross-quant-mode redelivery is skip-safe too."""
    if shipment is None:
        # zero-full-page export: the donor had nothing shippable (short
        # prompt under one page) — a well-formed no-op, not an error
        return {"status": "nothing", "pages": 0, "bytes": 0,
                "adopt_ms": 0.0}
    nbytes = target.shipment_bytes(shipment)
    if _chaos.active():
        ctx = {"engine": donor_id}
        if donor_pool is not None:
            ctx["pool"] = donor_pool
        spec = _chaos.fire("migration.ship", ctx=ctx)
        if spec is not None:
            if spec.kind == "drop":
                return {"status": "dropped", "pages": 0, "bytes": 0,
                        "adopt_ms": 0.0}
            if spec.kind == "stall":
                time.sleep(float(spec.args.get("seconds", 0.05)))
            if spec.kind == "corrupt":
                # a copy, kept in the job: retries reject too
                k = np.array(shipment["k"], copy=True)
                k.view(np.uint8).reshape(-1)[0] ^= 0xFF
                shipment["k"] = k
    hashes = (target.shipment_cache_hashes(shipment)
              if hasattr(target, "shipment_cache_hashes")
              else shipment["hashes"])
    if hashes is not None and all(h in target.pool.cache for h in hashes):
        return {"status": "ok", "pages": 0, "bytes": 0, "adopt_ms": 0.0}
    return _adopt(target, shipment, nbytes)
