"""Seeded open-loop arrival processes.

All generators return CUMULATIVE arrival times (seconds, float64,
non-decreasing, length n) and are fully determined by (params, seed) —
two runs of the same spec see byte-identical traffic, so benchmark
deltas are scheduler deltas.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poisson_arrivals", "gamma_arrivals", "burst_arrivals"]


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Poisson process at ``rate`` req/s: i.i.d. exponential gaps."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def gamma_arrivals(rate: float, cv: float, n: int,
                   seed: int = 0) -> np.ndarray:
    """Gamma renewal process at mean ``rate`` req/s with gap coefficient
    of variation ``cv``: cv == 1 reduces to Poisson, cv > 1 is burstier
    (heavier idle gaps AND tighter clumps), cv < 1 approaches a paced
    clock. The standard knob for stressing schedulers beyond memoryless
    traffic (e.g. vLLM's burstiness parameter)."""
    if rate <= 0 or cv <= 0:
        raise ValueError("rate and cv must be > 0")
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rate * shape)
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.gamma(shape, scale, size=n))


def burst_arrivals(rate: float, n: int, seed: int = 0,
                   burst_size: int = 8,
                   intra_gap: float = 1e-3) -> np.ndarray:
    """Bursty arrivals: groups of ``burst_size`` land ``intra_gap``
    apart, group STARTS form a Poisson process whose rate keeps the
    long-run average at ``rate`` req/s — the worst case for admission
    (the pool sees burst_size simultaneous demands, then silence)."""
    if burst_size < 1:
        raise ValueError("burst_size must be >= 1")
    n_groups = -(-n // burst_size)
    starts = poisson_arrivals(rate / burst_size, n_groups, seed)
    out = (starts[:, None] + intra_gap * np.arange(burst_size)[None, :])
    # adjacent groups can overlap when two starts land close — arrival
    # times must be sorted so rid == arrival order holds downstream
    return np.sort(out.reshape(-1))[:n]
