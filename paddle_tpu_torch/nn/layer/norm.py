"""Normalization layers (port of paddle_tpu/nn/layer/norm.py).

``SyncBatchNorm`` in training, with an initialised ``torch.distributed``
group of more than one rank, all-reduces the batch statistics over the
group (differentiably); otherwise it is ``BatchNorm``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer
from ...core import device as _device
from ...core.dispatch import op
from ...core.tensor import Tensor

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm", "SyncBatchNorm",
    "RMSNorm",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = self.create_parameter(
                [num_features], default_initializer=I.Constant(1.0))
            self.weight.stop_gradient = True
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = self.create_parameter(
                [num_features], is_bias=True,
                default_initializer=I.Constant(0.0))
            self.bias.stop_gradient = True
        else:
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))
        dev = _device.current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            [num_features], device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            [num_features], device=dev)))

    def forward(self, input):
        return F.batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats,
        )

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCL", use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCDHW", use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (reference:
    python/paddle/nn/layer/norm.py:1200): in training, with a
    ``torch.distributed`` group of more than one rank, the batch mean
    and mean square are averaged over the group's ranks (an autograd
    all-reduce, so the gradients are the whole batch's), and the
    running statistics take the group's values."""

    def forward(self, input):
        if self.training and _world_size() > 1:
            return self._sync_forward(input)
        return super().forward(input)

    def _sync_forward(self, input):
        from torch.distributed.nn.functional import all_reduce

        world = _world_size()
        channel_axis = (1 if self._data_format.startswith("NC")
                        else input.ndim - 1)
        reduce_axes = [i for i in range(input.ndim) if i != channel_axis]
        eps = self._epsilon

        @op("sync_batch_norm", amp="keep_fp32")
        def _impl(x, w, b):
            xf = x.float()
            stats = torch.stack([xf.mean(dim=reduce_axes),
                                 (xf * xf).mean(dim=reduce_axes)])
            stats = all_reduce(stats) / world
            mean, var = stats[0], stats[1] - stats[0] * stats[0]
            shape = [1] * x.dim()
            shape[channel_axis] = x.shape[channel_axis]
            out = (xf - mean.reshape(shape)) / torch.sqrt(
                var.reshape(shape) + eps)
            out = out * w.float().reshape(shape) + b.float().reshape(shape)
            return out.to(x.dtype), mean, var

        out, mean, var = _impl(input, self.weight, self.bias)
        m = self._momentum
        with torch.no_grad():
            self._mean.set_value(m * self._mean._data
                                 + (1 - m) * mean._data.detach())
            self._variance.set_value(m * self._variance._data
                                     + (1 - m) * var._data.detach())
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        converted = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            converted = cls(layer._num_features, layer._momentum,
                            layer._epsilon, data_format=layer._data_format)
            converted.weight = layer.weight
            converted.bias = layer.bias
            converted._mean = layer._mean
            converted._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            converted._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return converted


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    """RMS norm with a learned scale (reference:
    python/paddle/incubate/nn/functional/fused_rms_norm.py)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, input):
        return F.rms_norm(input, self.weight, epsilon=self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_channels], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [num_channels], attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_features = num_features
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.instance_norm(input, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self._data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self._data_format)


class SpectralNorm(Layer):
    """Power-iteration spectral normalization of a weight tensor.

    reference: python/paddle/nn/layer/norm.py SpectralNorm.
    """

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        dim, power_iters, eps = self._dim, self._power_iters, self._eps

        @op("spectral_norm")
        def _impl(w, u, v):
            w_mat = torch.movedim(w, dim, 0)
            shape = w_mat.shape
            w_mat = w_mat.reshape(shape[0], -1)
            for _ in range(power_iters):
                v = w_mat.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = w_mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = u @ w_mat @ v
            return torch.movedim((w_mat / sigma).reshape(shape), 0, dim)

        return _impl(weight, self.weight_u, self.weight_v)


def _world_size() -> int:
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()):
        return 1
    return tdist.get_world_size()
