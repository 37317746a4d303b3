"""Activation functionals (port of paddle_tpu/nn/functional/activation.py).

Each op is a torch expression registered through the funnel
(core/dispatch.py) under the reference's name and AMP policy. The
random ones (``rrelu`` in training, ``gumbel_softmax``) draw from the
port's generator (core/random.py): the same distribution as the
reference's, other bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import random as prandom
from ...core.dispatch import op

__all__ = [
    "celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu6", "relu_",
    "rrelu", "selu", "sigmoid", "silu", "softmax", "softmax_",
    "softplus", "softshrink", "softsign", "swish", "swiglu",
    "tanhshrink", "thresholded_relu", "tanh",
]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, _zero(x))


@op("relu", amp="cast")
def relu(x):
    return torch.relu(x)


def relu_(x):
    return x.set_value(relu(x)._data)


@op("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@op("gelu", amp="cast")
def gelu(x, approximate: bool = False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@op("silu", amp="cast")
def silu(x):
    return TF.silu(x)


@op("swish")
def swish(x):
    return TF.silu(x)


@op("swiglu", amp="cast")
def swiglu(x, y=None):
    # y None: the last dim of x is split in half
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return TF.silu(x) * y


@op("leaky_relu")
def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@op("elu")
def elu(x, alpha: float = 1.0):
    # jax.nn.elu: the inner where keeps a large x's expm1 out of the
    # gradient
    safe = torch.where(x > 0, _zero(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


@op("celu")
def celu(x, alpha: float = 1.0):
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


@op("selu")
def selu(
    x,
    scale: float = 1.0507009873554804934193349852946,
    alpha: float = 1.6732632423543772848170429916717,
):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op("nn_sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@op("nn_tanh")
def tanh(x):
    return torch.tanh(x)


@op("hardshrink")
def hardshrink(x, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@op("hardsigmoid")
def hardsigmoid(x, slope: float = 1.0 / 6.0, offset: float = 0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@op("hardswish")
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@op("hardtanh")
def hardtanh(x, min: float = -1.0, max: float = 1.0):  # noqa: A002
    return torch.clamp(x, min, max)


@op("log_sigmoid")
def log_sigmoid(x):
    return TF.logsigmoid(x)


@op("log_softmax", amp="keep_fp32")
def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


@op("softmax", amp="keep_fp32")
def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def softmax_(x, axis: int = -1):
    return x.set_value(softmax(x, axis)._data)


@op("softplus")
def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    return torch.where(x * beta > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


@op("softshrink")
def softshrink(x, threshold: float = 0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


@op("softsign")
def softsign(x):
    return x / (torch.abs(x) + 1)


@op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@op("thresholded_relu")
def thresholded_relu(x, threshold: float = 1.0, value: float = 0.0):
    return torch.where(x > threshold, x,
                       torch.as_tensor(value, dtype=x.dtype,
                                       device=x.device))


@op("mish")
def mish(x):
    return x * torch.tanh(_softplus(x))


@op("prelu")
def prelu(x, weight, data_format: str = "NCHW"):
    w = weight
    if w.dim() == 1 and w.shape[0] != 1 and x.dim() > 1:
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@op("glu")
def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op("maxout")
def maxout(x, groups: int, axis: int = 1):
    # channels split into (C // groups, groups), max over the groups
    # (amax: ties share the gradient, as JAX's max does)
    shape = list(x.shape)
    if axis < 0:
        axis += x.dim()
    c = shape[axis]
    new_shape = shape[:axis] + [c // groups, groups] + shape[axis + 1:]
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


def _uniform(shape, dtype, device, lo=0.0, hi=1.0):
    gen = prandom.default_generator().torch_generator(device)
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return u * (hi - lo) + lo


def rrelu(x, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0,
          training: bool = True):
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)

    @op("rrelu_train")
    def _rrelu(xx):
        slope = _uniform(xx.shape, torch.float32, xx.device, lower, upper)
        return torch.where(xx >= 0, xx, slope * xx)

    return _rrelu(x)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1):
    @op("gumbel_softmax")
    def _gumbel(xx):
        u = _uniform(xx.shape, torch.float32, xx.device)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        y = torch.softmax((xx + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            # straight-through estimator
            y = (y_hard - y).detach() + y
        return y

    return _gumbel(x)
