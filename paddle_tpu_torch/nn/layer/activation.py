"""Activation layers (port of paddle_tpu/nn/layer/activation.py)."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU",
]


def _simple(name, fn, **fixed):
    class _Act(Layer):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self._kwargs = {**fixed, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups = groups
        self._axis = axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower = lower
        self._upper = upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


ELU = _simple("ELU", lambda x, alpha=1.0: F.elu(x, alpha))
CELU = _simple("CELU", lambda x, alpha=1.0: F.celu(x, alpha))
SELU = _simple("SELU", F.selu)
ReLU6 = _simple("ReLU6", F.relu6)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.swish)
Tanh = _simple("Tanh", F.tanh)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Softshrink = _simple("Softshrink", lambda x, threshold=0.5: F.softshrink(x, threshold))
Softsign = _simple("Softsign", F.softsign)
Hardshrink = _simple("Hardshrink", lambda x, threshold=0.5: F.hardshrink(x, threshold))
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardswish = _simple("Hardswish", F.hardswish)
Hardtanh = _simple("Hardtanh", lambda x, min=-1.0, max=1.0: F.hardtanh(x, min, max))
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Mish = _simple("Mish", F.mish)
GLU = _simple("GLU", lambda x, axis=-1: F.glu(x, axis))
ThresholdedReLU = _simple(
    "ThresholdedReLU", lambda x, threshold=1.0, value=0.0: F.thresholded_relu(x, threshold, value)
)
