"""Fleet serving: a :class:`FleetRouter` drives N ``ServingEngine``
replicas of one model (the port's copy of the reference's data plane):
placement by prefix-cache gravity, adapter residency and session
affinity, deadline-aware routing, health (step exceptions and a wall
step budget), retries with backoff, KV page migration from a dead
replica into a survivor's prefix cache, pressure shedding of
never-accepted work, and disaggregated prefill / decode pools joined by
the crc'd page wire, static or measured-load, with degraded colocated
fallback and automatic re-split; and the zero-downtime operations
(``rollout.py``): content-hashed weight versions, a rolling upgrade one
engine at a time (drain, swap, canary, rejoin) with automatic rollback,
demand-driven autoscale and SLO-aware admission shed.

A lone ``ServingEngine`` never touches this package, so with the
``serving_fleet_*`` / ``serving_disagg_*`` flags off a single engine is
unchanged by construction.
"""

from .migration import ship_pages, ship_shipment
from .rollout import WeightCatalog, run_canary
from .router import FleetRouter

__all__ = ["FleetRouter", "WeightCatalog", "run_canary",
           "ship_pages", "ship_shipment"]
