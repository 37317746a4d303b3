"""Model-parallel RNG state tracking (the port's copy of
paddle_tpu/distributed/fleet/random.py; reference
python/paddle/distributed/fleet/layers/mpu/random.py:34).

Random bits on a sharded activation must differ between the mp ranks,
and on a replicated one they must agree. The reference's single XLA
program gets that for free: it draws per logical position. Here every
rank draws for itself, so the tracker does it by hand, as Paddle's
does: it keeps named streams, each a ``torch.Generator`` state for an
explicit device, and ``rng_state(name)`` runs its block on the named
stream (swapped into the port's default generator for the current
device, then swapped out with its advanced state).
``model_parallel_random_seed`` seeds ``global_seed`` and the default
generator alike on every rank and ``local_seed`` apart on each mp rank
(alike across dp).
"""

from __future__ import annotations

import contextlib
import zlib

import torch

from ...core import random as _random

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


def _device_key(dev: torch.device) -> str:
    return f"cuda:{dev.index or 0}" if dev.type == "cuda" else dev.type


class RNGStatesTracker:
    """Named random streams: ``states_`` maps a name to its seed and the
    generator state of each device it has drawn on."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = {"seed": int(seed), "devices": {}}

    def get_states_tracker(self):
        return {n: {"seed": s["seed"],
                    "devices": {d: t.clone() for d, t in s["devices"].items()}}
                for n, s in self.states_.items()}

    def set_states_tracker(self, states):
        self.states_ = {n: {"seed": s["seed"], "devices": dict(s["devices"])}
                        for n, s in states.items()}

    def _state(self, name: str, dev: torch.device) -> torch.Tensor:
        entry = self.states_[name]
        key = _device_key(dev)
        if key not in entry["devices"]:
            g = torch.Generator(device=dev)
            g.manual_seed(entry["seed"])
            entry["devices"][key] = g.get_state()
        return entry["devices"][key]

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        """Run the block on stream ``name`` for the current device (a name
        not added yet gets the seed crc32(name), the same on every rank,
        as the reference derives it)."""
        from ...core import device as _device

        if name not in self.states_:
            self.add(name, zlib.crc32(name.encode()) % (2 ** 31))
        dev = _device.current_device()
        gen = _random.default_generator().torch_generator(dev)
        orig = gen.get_state()
        gen.set_state(self._state(name, dev))
        try:
            yield
        finally:
            self.states_[name]["devices"][_device_key(dev)] = gen.get_state()
            gen.set_state(orig)


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 2024):
    """Seed the default generator and ``global_seed`` with ``seed`` on
    every rank, and ``local_seed`` with seed + 1024 + 100 x the mp rank
    (the reference's seed + 1024 on mp rank 0)."""
    from ..topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _TRACKER.reset()
    _random.seed(seed)
    _TRACKER.add("global_seed", seed)
    _TRACKER.add("local_seed", seed + 1024 + 100 * mp_rank)
