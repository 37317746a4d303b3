"""Normalization functionals (port of paddle_tpu/nn/functional/norm.py).

Each is one torch expression; the statistics are taken in fp32 whatever
the input's dtype, and the output takes the input's dtype, as the
reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import op

__all__ = [
    "batch_norm", "layer_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize", "rms_norm",
]


def _mean(x, dims, keepdim=False):
    # torch reads dim=() as every dim; JAX as none
    return torch.mean(x, dim=dims, keepdim=keepdim) if dims else x


def _affine(out, weight, bias, shape=None):
    if weight is not None:
        w = weight.float()
        out = out * (w if shape is None else w.reshape(shape))
    if bias is not None:
        b = bias.float()
        out = out + (b if shape is None else b.reshape(shape))
    return out


@op("layer_norm", amp="keep_fp32")
def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape) if normalized_shape is not None else 1
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    return _affine(out, weight, bias).to(x.dtype)


@op("rms_norm", amp="keep_fp32")
def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    axes = (tuple(range(begin_norm_axis, x.dim()))
            if begin_norm_axis >= 0 else (x.dim() - 1,))
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=axes, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    return _affine(out, weight, bias).to(x.dtype)


def batch_norm(
    x,
    running_mean,
    running_var,
    weight=None,
    bias=None,
    training: bool = False,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    data_format: str = "NCHW",
    use_global_stats=None,
):
    """Batch norm. In training the running statistics are updated in
    place: ``momentum * running + (1 - momentum) * batch``."""
    channel_axis = (1 if data_format.startswith("NC") and x.ndim > 1
                    else x.ndim - 1)
    reduce_axes = tuple(i for i in range(x.ndim) if i != channel_axis)
    use_batch_stats = training and not (use_global_stats is True)

    if use_batch_stats:
        out, batch_mean, batch_var = _batch_norm_train(
            x, weight, bias, channel_axis, reduce_axes, epsilon)
        if running_mean is not None:
            m = momentum
            running_mean.set_value(
                m * running_mean._data + (1 - m) * batch_mean._data)
            running_var.set_value(
                m * running_var._data + (1 - m) * batch_var._data)
        return out
    return _batch_norm_infer(x, running_mean, running_var, weight, bias,
                             channel_axis, epsilon)


def _channel_shape(x, channel_axis):
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return shape


@op("batch_norm_train", amp="keep_fp32")
def _batch_norm_train(x, weight, bias, channel_axis, reduce_axes, epsilon):
    xf = x.float()
    mean = _mean(xf, reduce_axes)
    var = _mean(torch.square(xf), reduce_axes) - torch.square(mean)
    shape = _channel_shape(x, channel_axis)
    out = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)
    return _affine(out, weight, bias, shape).to(x.dtype), mean, var


@op("batch_norm_infer", amp="keep_fp32")
def _batch_norm_infer(x, mean, var, weight, bias, channel_axis, epsilon):
    shape = _channel_shape(x, channel_axis)
    xf = x.float()
    out = (xf - mean.float().reshape(shape)) * torch.rsqrt(
        var.float().reshape(shape) + epsilon)
    return _affine(out, weight, bias, shape).to(x.dtype)


@op("instance_norm", amp="keep_fp32")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    channel_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    reduce_axes = tuple(i for i in range(x.dim())
                        if i not in (0, channel_axis))
    xf = x.float()
    mean = _mean(xf, reduce_axes, True)
    var = _mean(torch.square(xf - mean), reduce_axes, True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        shape = _channel_shape(x, channel_axis)
        out = out * weight.float().reshape(shape)
        if bias is not None:
            out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


@op("group_norm", amp="keep_fp32")
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    channel_last = not data_format.startswith("NC")
    x_cf = torch.movedim(x, -1, 1) if channel_last else x
    n, c = x_cf.shape[:2]
    spatial = tuple(x_cf.shape[2:])
    xf = x_cf.float().reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, xf.dim()))
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x_cf.shape)
    out = _affine(out, weight, bias, (1, c) + (1,) * len(spatial))
    if channel_last:
        out = torch.movedim(out, 1, -1)
    return out.to(x.dtype)


@op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    channel_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = torch.square(x)
    half = size // 2
    flat = [0, 0] * x.dim()
    # TF.pad lists (left, right) pairs from the last dim backwards
    j = 2 * (x.dim() - 1 - channel_axis)
    flat[j], flat[j + 1] = half, size - half - 1
    sq = TF.pad(sq, flat)
    ssum = sq.unfold(channel_axis, size, 1).sum(-1)
    div = torch.pow(k + alpha * ssum / size, beta)
    return x / div


@op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12):
    if p == 2:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    else:
        n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                                keepdim=True), 1.0 / p)
    return x / torch.clamp_min(n, epsilon)
