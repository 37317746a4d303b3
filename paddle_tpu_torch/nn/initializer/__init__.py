"""Weight initializers (port of paddle_tpu/nn/initializer/__init__.py).

An initializer is a callable ``(shape, dtype) -> torch.Tensor`` on the
current device, drawing from the package generator (core/random.py);
``Layer.create_parameter`` applies it. Draws are torch's: the
distributions are the reference's, the bits are not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import device as _device
from ...core import random as prandom
from ...core.dtype import convert_dtype
from ...core.tensor import Tensor, as_torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Dirac", "Orthogonal", "calculate_gain",
    "set_global_initializer",
]


def _fans(shape, fan_in=None, fan_out=None):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # linear weight [in, out] (reference layout)
        f_in, f_out = shape[0], shape[1]
    else:
        # conv weight [out_c, in_c/groups, *k]
        receptive = int(np.prod(shape[2:]))
        f_in = shape[1] * receptive
        f_out = shape[0] * receptive
    return fan_in or f_in, fan_out or f_out


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0,
        "conv2d": 1.0,
        "conv3d": 1.0,
        "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def _dt(dtype):
    return convert_dtype(dtype) or torch.float32


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError

    @staticmethod
    def _gen():
        return prandom.default_generator().torch_generator()

    @staticmethod
    def _empty(shape):
        return torch.empty(tuple(shape), dtype=torch.float32,
                           device=_device.current_device())


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=_device.current_device())


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        out = self._empty(shape).normal_(generator=self._gen())
        return (out * self.std + self.mean).to(_dt(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32"):
        # inverse-CDF sampling of the standard normal truncated to [a, b]
        # (jax.random.truncated_normal's method)
        lo = math.erf(self.a / math.sqrt(2.0))
        hi = math.erf(self.b / math.sqrt(2.0))
        u = self._empty(shape).uniform_(lo, hi, generator=self._gen())
        out = (math.sqrt(2.0) * torch.erfinv(u)).clamp(self.a, self.b)
        return (out * self.std + self.mean).to(_dt(dtype))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        out = self._empty(shape).uniform_(self.low, self.high,
                                          generator=self._gen())
        return out.to(_dt(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        f_in, f_out = _fans(shape, self.fan_in, self.fan_out)
        std = self.gain * math.sqrt(2.0 / (f_in + f_out))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        f_in, f_out = _fans(shape, self.fan_in, self.fan_out)
        limit = self.gain * math.sqrt(6.0 / (f_in + f_out))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        f_in, _ = _fans(shape, self.fan_in)
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(f_in))(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        f_in, _ = _fans(shape, self.fan_in)
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / f_in)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        if isinstance(value, Tensor):
            value = value._data
        self.value = value

    def __call__(self, shape, dtype="float32"):
        out = as_torch(self.value).to(_dt(dtype))
        if tuple(out.shape) != tuple(shape):
            out = torch.reshape(out, tuple(shape))
        return out.clone()


class Dirac(Initializer):
    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        out = np.zeros(shape, dtype="float32")
        out_c, in_c = shape[0], shape[1]
        min_c = min(out_c // self.groups, in_c)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for ch in range(min_c):
                idx = (g * (out_c // self.groups) + ch, ch) + tuple(centers)
                out[idx] = 1.0
        return as_torch(out).to(_dt(dtype))


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = self._empty((max(rows, cols), min(rows, cols))).normal_(
            generator=self._gen())
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))).to(
            _dt(dtype))


_global_param_init: Initializer | None = None
_global_bias_init: Initializer | None = None


def set_global_initializer(weight_init=None, bias_init=None):
    global _global_param_init, _global_bias_init
    _global_param_init = weight_init
    _global_bias_init = bias_init


def global_initializer(is_bias: bool):
    return _global_bias_init if is_bias else _global_param_init
