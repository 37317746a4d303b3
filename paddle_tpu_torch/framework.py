"""Framework-level helpers: dygraph/static mode switch, save/load (port of
paddle_tpu/framework.py).

A file is the reference's: a pickle (protocol 4 by default) of the
object with every Tensor replaced by ``{"__tensor__": True, "data":
<numpy array>, "stop_gradient": ..., "is_parameter": ...}``. It holds no
class of either package, so each package reads the other's files; an
fp32 state is written byte for byte as the reference writes it. A bare
torch tensor (an optimizer's moment) is written as a numpy array.

bf16: the reference's bf16 leaf is an ``ml_dtypes.bfloat16`` array,
which the card's host cannot import. The port writes the same bytes
without it (the leaf pickles as numpy pickles that array, the global
``ml_dtypes.bfloat16`` included) and reads such a leaf by its bytes
when ``ml_dtypes`` is missing: numpy then holds it as ``V2`` (two raw
bytes an element), which becomes a bf16 tensor. With ``return_numpy``
the leaf comes back as read: an ``ml_dtypes`` array where that package
is installed, else the ``V2`` array.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from .core.tensor import Parameter, Tensor, as_torch

_dygraph_mode = True


def in_dynamic_mode() -> bool:
    return _dygraph_mode


def in_dygraph_mode() -> bool:
    return _dygraph_mode


def enable_static():
    global _dygraph_mode
    _dygraph_mode = False


def disable_static():
    global _dygraph_mode
    _dygraph_mode = True


class _Bfloat16:
    """Stands for ``ml_dtypes.bfloat16`` in a file: pickled as that
    global, and what that global reads as when ``ml_dtypes`` is
    missing."""


class _Bf16Dtype:
    """Pickles as numpy pickles ``np.dtype(ml_dtypes.bfloat16)``."""

    def __reduce__(self):
        return (np.dtype, (_Bfloat16, False, True),
                (3, "<", None, None, None, 2, 2, 64))


_BF16_DTYPE = _Bf16Dtype()


class _Bf16Array:
    """A bf16 array's bytes, pickled as numpy pickles the same values in
    an ``ml_dtypes.bfloat16`` array."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)
        self.raw = t.contiguous().view(torch.int16).numpy().tobytes()

    def __reduce__(self):
        fn, args, _ = np.empty(0, np.float32).__reduce__()
        return fn, args, (1, self.shape, _BF16_DTYPE, False, self.raw)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (its output is the C pickler's), writing
    ``_Bfloat16`` as the global ``ml_dtypes.bfloat16``."""

    def save_global(self, obj, name=None):
        if obj is not _Bfloat16:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
        self.memoize(obj)


def _numpy_dtype(obj, align=False, copy=False):
    if obj is _Bfloat16:
        return np.dtype("V2")
    return np.dtype(obj, align, copy)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            try:
                import ml_dtypes
            except ImportError:
                return _Bfloat16
            return ml_dtypes.bfloat16
        if (module, name) == ("numpy", "dtype"):
            return _numpy_dtype
        return super().find_class(module, name)


def _host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _Bf16Array(t)
    return t.numpy()


def _to_serializable(obj: Any):
    if isinstance(obj, Tensor):
        return {"__tensor__": True, "data": _host(obj._data),
                "stop_gradient": obj.stop_gradient,
                "is_parameter": isinstance(obj, Parameter)}
    if isinstance(obj, torch.Tensor):
        return _host(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _bf16_bytes(arr) -> bool:
    return isinstance(arr, np.ndarray) and arr.dtype.kind == "V" and \
        arr.dtype.itemsize == 2


def _to_torch(arr) -> torch.Tensor:
    if _bf16_bytes(arr) or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return as_torch(bits).view(torch.bfloat16)
    return as_torch(arr)


def _from_serializable(obj: Any, return_numpy: bool = False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            cls = Parameter if obj.get("is_parameter") else Tensor
            t = cls(_to_torch(np.asarray(obj["data"])))
            if not obj.get("is_parameter"):
                t.stop_gradient = obj.get("stop_gradient", True)
            return t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy) for v in obj)
    if not isinstance(obj, (np.ndarray, np.generic)) and \
            hasattr(obj, "__array__") and hasattr(obj, "dtype"):
        # another framework's array (the reference's optimizer moments
        # are jax arrays): as numpy
        obj = np.asarray(obj)
    if _bf16_bytes(obj) and not return_numpy:
        return _to_torch(obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_serializable(obj))


def load(path: str, return_numpy: bool = False) -> Any:
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_serializable(obj, return_numpy)
