"""Open-loop load generation for the serving engine and the fleet (the
port's copy of paddle_tpu/inference/loadgen).

Seeded open-loop arrival processes (arrivals.py), request mixes with
shared prefixes, long-tail lengths, bursts and the fleet's and the
disaggregated pools' decorations (workload.py), drivers that keep the
queue deep whatever the service rate and inject aborts, deadlines and
replica kills (driver.py), and latency, goodput and occupancy reports
that reuse the engine's slot-token ledger (metrics.py).
"""

from .arrivals import burst_arrivals, gamma_arrivals, poisson_arrivals
from .driver import FleetDriver, OpenLoopDriver
from .metrics import percentile, summarize, summarize_fleet
from .workload import WorkloadSpec, synthesize

__all__ = [
    "OpenLoopDriver", "FleetDriver", "WorkloadSpec", "synthesize",
    "summarize", "summarize_fleet", "percentile", "poisson_arrivals",
    "gamma_arrivals", "burst_arrivals",
]
