"""The process-global generator ops draw from (port of
paddle_tpu/core/random.py).

A ``Generator`` holds a ``torch.Generator`` on the current device, made
on first use so that importing the package touches no device; ``seed``
reseeds it. The draws are torch's, not JAX's: the two packages' random
ops agree in distribution, not in bits.
"""

from __future__ import annotations

import torch

from . import device as _device

__all__ = ["Generator", "seed", "default_generator", "get_state",
           "set_state"]


class Generator:
    def __init__(self, seed_: int = 0):
        self._seed = int(seed_)
        self._gen: dict = {}

    def manual_seed(self, seed_: int) -> "Generator":
        self._seed = int(seed_)
        self._gen.clear()
        return self

    seed = manual_seed

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device=None) -> torch.Generator:
        """The torch generator draws on ``device`` (default: the current
        device) take, seeded with this generator's seed on first use."""
        dev = torch.device(device) if device is not None else \
            _device.current_device()
        key = (dev.type, dev.index if dev.type == "cuda" else None)
        g = self._gen.get(key)
        if g is None:
            g = self._gen[key] = torch.Generator(device=dev)
            g.manual_seed(self._seed)
        return g

    def get_state(self, device=None) -> torch.Tensor:
        return self.torch_generator(device).get_state()

    def set_state(self, state, device=None) -> None:
        self.torch_generator(device).set_state(state)


_default = Generator(0)


def default_generator() -> Generator:
    return _default


def seed(s: int) -> Generator:
    return _default.manual_seed(s)


def get_state():
    return _default.get_state()


def set_state(state):
    _default.set_state(state)
