"""Dtype names mapped onto torch dtypes (port of paddle_tpu/core/dtype.py).

The names the package exports (``float32``, ``bfloat16``, ...) are torch
dtypes. ``uint16``, ``uint32`` and ``uint64`` are defined as names, but
torch does no arithmetic on them, so ``convert_dtype`` refuses them.
"""

from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = "uint16"
uint32 = "uint32"
uint64 = "uint64"
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_TO_DTYPE = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int": int32,
    "int64": int64, "long": int64, "uint8": uint8,
    "bool": bool_, "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_REFUSED = ("uint16", "uint32", "uint64")

_NP_TO_TORCH = {
    np.dtype(np.float16): float16, np.dtype(np.float32): float32,
    np.dtype(np.float64): float64, np.dtype(np.int8): int8,
    np.dtype(np.int16): int16, np.dtype(np.int32): int32,
    np.dtype(np.int64): int64, np.dtype(np.uint8): uint8,
    np.dtype(np.bool_): bool_, np.dtype(np.complex64): complex64,
    np.dtype(np.complex128): complex128,
}


def convert_dtype(dtype) -> torch.dtype | None:
    """A string, numpy, Python or torch dtype spec -> a torch dtype (None
    stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    if isinstance(dtype, str) or name in _REFUSED:
        if name in _REFUSED:
            raise TypeError(f"dtype {name}: torch has no arithmetic on it")
        if name not in _STR_TO_DTYPE:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _STR_TO_DTYPE[name]
    if getattr(dtype, "__name__", None) == "bfloat16" or name == "bfloat16":
        return bfloat16
    try:
        npdt = np.dtype(dtype)
    except TypeError as e:
        raise ValueError(f"unknown dtype: {dtype!r}") from e
    if npdt.name in _REFUSED:
        raise TypeError(f"dtype {npdt.name}: torch has no arithmetic on it")
    if npdt.name == "bfloat16":
        return bfloat16
    return _NP_TO_TORCH[npdt]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not dt.is_floating_point and not dt.is_complex and dt != bool_
