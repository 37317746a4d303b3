"""Device choice for the port's entry points, and the Paddle device API
(port of paddle_tpu/core/device.py) over ``torch.cuda``.

The current device starts as ``gpu:0``. With no card, making a tensor
without ``set_device("cpu")`` (or ``device="cpu"``) raises: the port
never drops to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_device", "get_device", "current_device",
           "device_count", "synchronize", "memory_allocated",
           "max_memory_allocated", "reset_max_memory_allocated",
           "memory_reserved", "max_memory_reserved",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu"]

_NO_CARD = ("paddle_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device=\"cpu\" to run on the CPU")


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
        raise RuntimeError(_NO_CARD)
    return torch.device("cuda")


_current = "gpu:0"


def _parse(device) -> str:
    if isinstance(device, torch.device):
        device = f"{device.type}:{device.index or 0}" \
            if device.type == "cuda" else device.type
    if isinstance(device, int):
        return f"gpu:{device}"
    text = str(device).lower()
    platform, _, idx = text.partition(":")
    platform = {"cuda": "gpu"}.get(platform, platform)
    if platform == "cpu":
        return "cpu"
    if platform != "gpu":
        raise ValueError(f"set_device: unknown device {device!r} (cpu, gpu "
                         "or gpu:N)")
    return f"gpu:{int(idx or 0)}"


def set_device(device) -> torch.device:
    """'cpu', 'gpu', 'gpu:N' (or 'cuda:N'): where later tensors are made.
    A GPU needs a card."""
    global _current
    name = _parse(device)
    if name != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(f"set_device({device!r}): CUDA is not "
                               "available")
        if int(name.split(":")[1]) >= torch.cuda.device_count():
            raise ValueError(f"set_device({device!r}): "
                             f"{torch.cuda.device_count()} GPU(s)")
    _current = name
    return current_device()


def get_device() -> str:
    return _current


def current_device() -> torch.device:
    """The torch device of the current Paddle device; raises for a GPU
    when there is no card."""
    if _current == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD + " (or set_device(\"cpu\"))")
    return torch.device("cuda", int(_current.split(":")[1]))


def device_count() -> int:
    return torch.cuda.device_count()


def _cuda(device=None) -> torch.device:
    if device is None:
        return current_device()
    if isinstance(device, int):
        return torch.device("cuda", device)
    name = _parse(device)
    return torch.device("cpu") if name == "cpu" else \
        torch.device("cuda", int(name.split(":")[1]))


def synchronize(device=None) -> None:
    dev = _cuda(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_allocated(device=None) -> int:
    dev = _cuda(device)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def max_memory_allocated(device=None) -> int:
    dev = _cuda(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_max_memory_allocated(device=None) -> None:
    dev = _cuda(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def memory_reserved(device=None) -> int:
    dev = _cuda(device)
    return torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0


def max_memory_reserved(device=None) -> int:
    dev = _cuda(device)
    return torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
