"""nn.utils (port of paddle_tpu/nn/utils/): gradient clipping in place,
parameters to and from one vector, and the weight-norm and
spectral-norm reparameterisations."""

from __future__ import annotations

import torch

from ...core.dispatch import op
from ...core.tensor import Parameter, Tensor, as_torch

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm",
           "spectral_norm"]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place so that their ``norm_type``-norm,
    taken together, is at most ``max_norm``; returns that norm."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros([]))
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g._data))
                                       for g in grads]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(torch.abs(g._data.float()), norm_type))
                for g in grads), 1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite grad norm")
    scale = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad.set_value((p.grad._data * scale).to(p.grad.dtype))
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad.set_value(torch.clamp(p.grad._data, -clip_value,
                                         clip_value))


def parameters_to_vector(parameters, name=None):
    return Tensor(torch.cat([p._data.detach().reshape(-1)
                             for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    data = vec._data if isinstance(vec, Tensor) else as_torch(vec)
    offset = 0
    for p in parameters:
        n = p._data.numel()
        p.set_value(data[offset:offset + n].reshape(p._data.shape))
        offset += n


def _norm_except(v, dim, keepdim):
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(v)))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(v), dim=axes, keepdim=keepdim))


def _weight_from(v, g, dim):
    if dim is None:
        return v * (g / _norm_except(v, None, False))
    shape = [1] * v.dim()
    shape[dim] = -1
    return v * (g.reshape(shape) / _norm_except(v, dim, True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as g * v / ||v|| (reference:
    nn/utils/weight_norm_hook.py): parameters ``<name>_g`` and
    ``<name>_v`` replace it, and a forward pre-hook recomputes it."""
    w = getattr(layer, name)._data.detach()
    g = Parameter(_norm_except(w, dim, False))
    v = Parameter(w.clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)
    layer._weight_norm_name = name
    layer._weight_norm_dim = dim

    def hook(lyr, inputs):
        @op("weight_norm_recompute")
        def _compute(v_arr, g_arr):
            return _weight_from(v_arr, g_arr, dim)

        w_t = _compute(lyr._parameters[name + "_v"],
                       lyr._parameters[name + "_g"])
        object.__setattr__(lyr, name, w_t)

    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    layer._weight_norm_hook.remove()
    if name in layer.__dict__:
        object.__delattr__(layer, name)
    with torch.no_grad():
        w = _weight_from(v._data, g._data, layer._weight_norm_dim)
    layer.add_parameter(name, Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Attach spectral normalization to a layer's weight."""
    from ..layer.norm import SpectralNorm

    weight = getattr(layer, name)
    if dim is None:
        dim = 0
    sn = SpectralNorm(list(weight._data.shape), dim=dim,
                      power_iters=n_power_iterations, eps=eps)
    layer.add_sublayer(name + "_sn", sn)
    orig = layer._parameters.pop(name)
    layer.add_parameter(name + "_orig", orig)

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, sn(lyr._parameters[name + "_orig"]))

    layer._spectral_norm_hook = layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer
