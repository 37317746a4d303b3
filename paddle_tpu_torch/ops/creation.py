"""Tensor creation (port of paddle_tpu/ops/creation.py).

Tensors are made on the current device (core/device.py). Random
creators draw from the package's generator (core/random.py): torch's
draws, the reference's distributions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import device as _device
from ..core import random as prandom
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_torch

__all__ = [
    "to_tensor", "tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace",
    "logspace", "eye", "diag", "diagflat", "tril", "triu", "meshgrid",
    "rand", "randn", "randint", "uniform", "normal", "standard_normal",
    "randperm", "bernoulli", "multinomial", "assign", "clone", "one_hot",
    "tril_indices", "triu_indices",
    "binomial", "poisson", "standard_gamma", "dirichlet", "exponential_",
    "complex", "as_complex", "as_real",
]


def _dev():
    return _device.current_device()


def _gen(device=None) -> torch.Generator:
    return prandom.default_generator().torch_generator(device)


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, Tensor) else s)
                 for s in shape)


def _data(x):
    return x._data if isinstance(x, Tensor) else as_torch(x)


def _dt(dtype, default=torch.float32):
    d = convert_dtype(dtype)
    return default if d is None else d


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    dev = _device._cuda(place) if place is not None else _dev()
    dtype = convert_dtype(dtype)
    if isinstance(data, Tensor):
        arr = data._data.detach().clone().to(dev)
    elif isinstance(data, torch.Tensor):
        arr = data.detach().to(dev)
    else:
        probe = np.asarray(data)
        if dtype is None:
            # framework defaults: Python floats -> float32, complex ->
            # complex64
            if probe.dtype == np.float64:
                dtype = torch.float32
            elif probe.dtype == np.complex128:
                dtype = torch.complex64
        arr = as_torch(probe, device=dev)
    if dtype is not None:
        arr = arr.to(dtype)
    return Tensor(arr, stop_gradient=stop_gradient)


tensor = to_tensor


def zeros(shape, dtype="float32") -> Tensor:
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype="float32") -> Tensor:
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype="float32") -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=_dev()))


def empty(shape, dtype="float32") -> Tensor:
    return zeros(shape, dtype)


def _like(x, dtype):
    d = _data(x)
    return d, (convert_dtype(dtype) or d.dtype)


def zeros_like(x, dtype=None) -> Tensor:
    d, dt = _like(x, dtype)
    return Tensor(torch.zeros(d.shape, dtype=dt, device=d.device))


def ones_like(x, dtype=None) -> Tensor:
    d, dt = _like(x, dtype)
    return Tensor(torch.ones(d.shape, dtype=dt, device=d.device))


def full_like(x, fill_value, dtype=None) -> Tensor:
    d, dt = _like(x, dtype)
    return Tensor(torch.full(d.shape, fill_value, dtype=dt, device=d.device))


def empty_like(x, dtype=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None) -> Tensor:
    def val(v):
        return v.item() if isinstance(v, Tensor) else v

    start, end, step = val(start), val(end), val(step)
    if end is None:
        start, end = 0, start
    dtype = convert_dtype(dtype)
    if dtype is None:
        dtype = (torch.int64 if all(
            isinstance(v, (int, np.integer)) for v in (start, end, step))
            else torch.float32)
    return Tensor(torch.arange(start, end, step, dtype=dtype, device=_dev()))


def linspace(start, stop, num, dtype="float32") -> Tensor:
    return Tensor(torch.linspace(float(start), float(stop), int(num),
                                 dtype=torch.float64, device=_dev())
                  .to(_dt(dtype)))


def logspace(start, stop, num, base=10.0, dtype="float32") -> Tensor:
    t = torch.linspace(float(start), float(stop), int(num),
                       dtype=torch.float64, device=_dev())
    return Tensor(torch.pow(float(base), t).to(_dt(dtype)))


def eye(num_rows, num_columns=None, dtype="float32") -> Tensor:
    m = num_columns if num_columns is not None else num_rows
    return Tensor(torch.eye(int(num_rows), int(m), dtype=_dt(dtype),
                            device=_dev()))


def diag(x, offset=0, padding_value=0) -> Tensor:
    arr = _data(x)
    out = torch.diag(arr, offset)
    if padding_value != 0 and arr.dim() == 1:
        n = out.shape[0]
        mask = torch.ones(n, n, dtype=torch.bool,
                          device=out.device).diagonal(offset)
        keep = torch.zeros(n, n, dtype=torch.bool, device=out.device)
        keep.diagonal(offset).copy_(mask)
        out = torch.where(keep, out, torch.full_like(out, padding_value))
    return Tensor(out)


def diagflat(x, offset=0) -> Tensor:
    return Tensor(torch.diagflat(_data(x), offset))


def tril(x, diagonal=0) -> Tensor:
    from . import manipulation as _m

    return _m._tril(x, diagonal)


def triu(x, diagonal=0) -> Tensor:
    from . import manipulation as _m

    return _m._triu(x, diagonal)


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return [Tensor(o) for o in torch.meshgrid(*[_data(a) for a in args],
                                              indexing="ij")]


def rand(shape, dtype="float32") -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype="float32") -> Tensor:
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=_dev(),
                              generator=_gen()))


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64") -> Tensor:
    if high is None:
        low, high = 0, low
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                dtype=_dt(dtype, torch.int64), device=_dev(),
                                generator=_gen()))


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0) -> Tensor:
    dev = _dev()
    g = _gen() if seed == 0 else \
        torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
    out.uniform_(float(min), float(max), generator=g)
    return Tensor(out.to(_dt(dtype)))


def normal(mean=0.0, std=1.0, shape=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        ref = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape)
        z = torch.randn(shp, dtype=torch.float32, device=ref.device,
                        generator=_gen(ref.device))
        return Tensor(z * s + m)
    z = torch.randn(_shape(shape), dtype=torch.float32, device=_dev(),
                    generator=_gen())
    return Tensor(z * std + mean)


def randperm(n, dtype="int64") -> Tensor:
    return Tensor(torch.randperm(int(n), device=_dev(), generator=_gen())
                  .to(_dt(dtype, torch.int64)))


def bernoulli(x) -> Tensor:
    arr = _data(x)
    return Tensor(torch.bernoulli(arr.detach(), generator=_gen(arr.device)))


def multinomial(x, num_samples=1, replacement=False) -> Tensor:
    arr = _data(x).detach()
    return Tensor(torch.multinomial(arr.float(), int(num_samples),
                                    replacement=replacement,
                                    generator=_gen(arr.device)))


def assign(x, output=None) -> Tensor:
    arr = _data(x).detach()
    if output is not None:
        output.set_value(Tensor(arr))
        return output
    return Tensor(arr.clone())


def clone(x) -> Tensor:
    from . import manipulation as _m

    return _m._clone(x)


def one_hot(x, num_classes) -> Tensor:
    arr = _data(x)
    return Tensor(F.one_hot(arr.long(), int(num_classes)).float())


def tril_indices(row, col, offset=0) -> Tensor:
    r, c = np.tril_indices(row, offset, col)
    return Tensor(torch.as_tensor(np.stack([r, c]), dtype=torch.int64,
                                  device=_dev()))


def triu_indices(row, col=None, offset=0) -> Tensor:
    r, c = np.triu_indices(row, offset, col if col is not None else row)
    return Tensor(torch.as_tensor(np.stack([r, c]), dtype=torch.int64,
                                  device=_dev()))


def binomial(count, prob, name=None) -> Tensor:
    c, p = _data(count).detach(), _data(prob).detach()
    c, p = torch.broadcast_tensors(c.float(), p.float())
    out = torch.binomial(c, p, generator=_gen(c.device))
    return Tensor(out.to(torch.int64))


def poisson(x, name=None) -> Tensor:
    lam = _data(x).detach()
    out = torch.poisson(lam.float(), generator=_gen(lam.device))
    return Tensor(out.to(lam.dtype))


def standard_gamma(x, name=None) -> Tensor:
    a = _data(x).detach()
    return Tensor(torch._standard_gamma(a, generator=_gen(a.device)))


def dirichlet(alpha, name=None) -> Tensor:
    a = _data(alpha).detach()
    g = torch._standard_gamma(a, generator=_gen(a.device))
    return Tensor(g / g.sum(-1, keepdim=True))


def exponential_(x, lam: float = 1.0, name=None) -> Tensor:
    """In-place exponential fill (reference Tensor.exponential_)."""
    with torch.no_grad():
        x._data.exponential_(float(lam), generator=_gen(x._data.device))
    return x


def complex(real, imag, name=None) -> Tensor:
    r, i = _data(real).detach(), _data(imag).detach()
    dt = torch.promote_types(r.dtype, i.dtype)
    if not dt.is_floating_point or dt in (torch.float16, torch.bfloat16):
        dt = torch.float32
    r, i = torch.broadcast_tensors(r.to(dt), i.to(dt))
    return Tensor(torch.complex(r, i))


def as_complex(x, name=None) -> Tensor:
    a = _data(x).detach()
    return Tensor(torch.view_as_complex(a.contiguous()).clone())


def as_real(x, name=None) -> Tensor:
    a = _data(x).detach()
    if not a.is_complex():
        return Tensor(torch.stack([a, torch.zeros_like(a)], -1))
    return Tensor(torch.view_as_real(a).clone())
