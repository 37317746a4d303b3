"""Device choice for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; ``"cpu"`` (or any explicit device) passes
    through. With no device asked for and no GPU present this raises:
    the port never drops to the CPU on its own."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
