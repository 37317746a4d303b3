"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes
the same functions in PyTorch, with hand-written CUDA kernels where the
reference had Pallas TPU kernels. It imports neither ``jax`` nor
anything of ``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.
"""

from .core.device import resolve_device

__all__ = ["resolve_device"]
