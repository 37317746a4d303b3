"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes
the same functions in PyTorch, with hand-written CUDA kernels where the
reference had Pallas TPU kernels. It imports neither ``jax`` nor
anything of ``paddle_tpu``.

The eager Paddle API sits at the top level, as the reference's does:
``Tensor``, ``Parameter``, ``to_tensor``, the dtypes, grad mode,
``grad``/``backward``, flags, ``seed``, the device calls and the ops;
``nn``, ``optimizer``, ``amp``, ``autograd``, ``vision`` and the other
subpackages, and ``save`` / ``load`` / ``in_dynamic_mode``
(``framework``), load on first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` or calls ``set_device("cpu")``; without a GPU and
without that request they raise.
"""

from __future__ import annotations

from .core import (OP_REGISTRY, Parameter, Tensor, backward,  # noqa: F401
                   enable_grad, get_flags, grad, is_grad_enabled, no_grad,
                   set_flags, set_grad_enabled)
from .core.device import (device_count, get_device,  # noqa: F401
                          is_compiled_with_cuda, is_compiled_with_tpu,
                          is_compiled_with_xpu, resolve_device, set_device,
                          synchronize)
from .core.dtype import (bfloat16, bool_, complex64,  # noqa: F401
                         complex128, float16, float32, float64, int8, int16,
                         int32, int64, uint8)
from .core.random import seed  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops import abs, all, any, max, min, pow, slice, sum  # noqa: F401,A004
from .ops import make_inplace_wrapper  # noqa: F401

_LAZY_SUBMODULES = ("nn", "optimizer", "amp", "models", "compiler",
                    "distributed", "incubate", "inference", "parallel",
                    "testing", "utils", "obs", "autograd", "framework",
                    "version", "vision", "hapi")
_FRAMEWORK_NAMES = ("save", "load", "in_dynamic_mode")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name == "ParamAttr":
        from .nn.layer.layers import ParamAttr

        return ParamAttr
    if name in _FRAMEWORK_NAMES:
        from . import framework

        globals()[name] = getattr(framework, name)
        return globals()[name]
    if name == "__version__":
        from .version import __version__

        return __version__
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")
