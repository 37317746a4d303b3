"""Eager Tensor: a handle over a ``torch.Tensor`` (port of
paddle_tpu/core/tensor.py).

The handle keeps its buffer in ``_data`` and its autograd state on that
buffer: ``stop_gradient`` is ``not _data.requires_grad``, the producing
node is ``_data.grad_fn`` and a leaf's accumulated gradient is
``_data.grad`` (the tape is torch autograd, core/autograd.py). In-place
ops rebind ``_data``; the optimizers write a leaf's buffer in place, so a
parameter keeps its identity across steps.

Most operator methods are installed by ``paddle_tpu_torch.ops`` at import
time, as the reference's are.
"""

from __future__ import annotations

import copy
import weakref
from typing import Optional

import numpy as np
import torch

from . import device as _device

__all__ = ["Tensor", "Parameter", "live_parameters", "unique_name"]

_name_counters: dict[str, int] = {}


def unique_name(prefix: str) -> str:
    """``prefix_N``, N counting up per prefix: the names of Layers,
    parameters and variables."""
    n = _name_counters.get(prefix, 0)
    _name_counters[prefix] = n + 1
    return f"{prefix}_{n}"


def _grad_dtype(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def as_torch(data, dtype=None, device=None) -> torch.Tensor:
    """A numpy array, Python scalar or nested list (or a torch tensor)
    as a torch tensor on ``device`` (default: the current device)."""
    dev = device if device is not None else _device.current_device()
    if isinstance(data, torch.Tensor):
        return data.to(device=dev, dtype=dtype)
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":     # ml_dtypes arrays
        out = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    elif arr.dtype.kind in "USO":
        raise TypeError(f"cannot make a tensor of {arr.dtype} data")
    else:
        # np.array keeps a 0-d array 0-d (np.ascontiguousarray makes [1])
        out = torch.from_numpy(np.array(arr, order="C"))
    return out.to(device=dev, dtype=dtype)


class _Remover:
    def __init__(self, hooks, h):
        self._hooks, self._h = hooks, h

    def remove(self):
        if self._h in self._hooks:
            self._hooks.remove(self._h)


class Tensor:
    __slots__ = ("_data", "_hooks", "_hooked", "name", "persistable",
                 "__weakref__", "__dict__")

    def __init__(self, data, stop_gradient: bool = True, name: str = ""):
        if isinstance(data, Tensor):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = as_torch(data)
        if stop_gradient:
            if data.requires_grad:
                data = data.detach()
        elif not data.requires_grad and _grad_dtype(data.dtype):
            data = data.detach().requires_grad_(True)
        self._data = data
        self._hooks: list = []
        self._hooked = None
        self.name = name
        self.persistable = False

    # ---- metadata ----------------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def place(self):
        return str(self._data.device)

    @property
    def is_leaf(self) -> bool:
        return self._data.grad_fn is None

    @property
    def _grad_node(self):
        return self._data.grad_fn

    # ---- grad plumbing -----------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        d = self._data
        if value:
            if d.requires_grad:
                if d.grad_fn is None:
                    d.requires_grad_(False)
                else:          # a non-leaf: cut it off the tape
                    self._data = d.detach()
        elif not d.requires_grad and _grad_dtype(d.dtype):
            d.requires_grad_(True)
            self._attach_hooks()

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self._data
        if d.grad_fn is not None and not d.retains_grad:
            return None
        g = d.grad
        return None if g is None else Tensor(g, stop_gradient=True)

    @grad.setter
    def grad(self, value):
        if value is None:
            self._data.grad = None
            return
        g = value._data if isinstance(value, Tensor) else as_torch(value)
        self._data.grad = g.detach().to(device=self._data.device,
                                        dtype=self._data.dtype)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd

        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_gradient(self, set_to_zero: bool = False):
        g = self._data.grad
        if set_to_zero and g is not None:
            g.detach_().zero_()
        else:
            self._data.grad = None

    clear_grad = clear_gradient

    def retain_grads(self):
        if self._data.grad_fn is not None:
            self._data.retain_grad()

    def register_hook(self, hook):
        """Register a grad hook (Tensor -> Tensor | None), run once on the
        gradient accumulated for this tensor. Returns a remover."""
        self._hooks.append(hook)
        self._attach_hooks()
        return _Remover(self._hooks, hook)

    def _attach_hooks(self):
        d = self._data
        if not d.requires_grad or self._hooked is d:
            return
        hooks = self._hooks

        def run(g):
            if g is None:           # a deferred (zero-bubble) slot
                return None
            for h in list(hooks):
                res = h(Tensor(g, stop_gradient=not g.requires_grad))
                if res is not None:
                    g = res._data if isinstance(res, Tensor) else \
                        torch.as_tensor(res, device=g.device)
            return g

        d.register_hook(run)
        self._hooked = d

    def detach(self) -> "Tensor":
        return Tensor(self._data.detach(), stop_gradient=True, name=self.name)

    def _mat(self):
        return self._data

    # ---- conversion --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy: later in-place writes (an optimizer step) do not
        reach it, as none reaches the reference's immutable arrays."""
        d = self._data.detach()
        d = d.clone() if d.device.type == "cpu" else d.cpu()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.numpy()

    def item(self):
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __index__(self):
        dt = self._data.dtype
        if dt.is_floating_point or dt.is_complex:
            raise TypeError(f"only integer tensors can be interpreted as an "
                            f"index, got dtype {dt}")
        return int(self._data.item())

    def __bool__(self):
        return bool(self._data.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        return (_unpickle_tensor, (self.numpy(), self.stop_gradient,
                                   self.name))

    def __deepcopy__(self, memo):
        """A copy with storage of its own on the same device, in the same
        dtype and autograd state (pickling goes through the host)."""
        new = Tensor(self._data.detach().clone(),
                     stop_gradient=self.stop_gradient, name=self.name)
        memo[id(self)] = new
        new.persistable = self.persistable
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    # ---- mutation ----------------------------------------------------------
    def set_value(self, value):
        """Assign new values. Same shape, dtype and device: written into
        the buffer in place (a leaf keeps its identity and its grad);
        otherwise the handle is rebound. A non-Tensor value takes this
        tensor's dtype."""
        d = self._data
        if isinstance(value, Tensor):
            v = value._data.detach()
        else:
            v = as_torch(value, dtype=d.dtype, device=d.device)
        if v.shape == d.shape and v.dtype == d.dtype and \
                v.device == d.device and d.grad_fn is None:
            with torch.no_grad():
                d.copy_(v)
            return self
        if isinstance(value, Tensor):      # no storage shared with value
            v = v.clone()
        self._data = v.to(device=d.device)
        if d.requires_grad and d.grad_fn is None and \
                _grad_dtype(self._data.dtype):
            self._data.requires_grad_(True)
        self._hooked = None
        self._attach_hooks()
        return self

    def copy_(self, other, blocking: bool = True):
        return self.set_value(other)

    def _bump(self, new_data):
        """Rebind the buffer; a leaf that required grad keeps doing so."""
        was_leaf = self._data.requires_grad and self._data.grad_fn is None
        new = new_data.detach() if was_leaf else new_data
        if was_leaf and _grad_dtype(new.dtype):
            new.requires_grad_(True)
        self._data = new
        self._hooked = None
        self._attach_hooks()
        return self

    # ---- misc --------------------------------------------------------------
    def block_until_ready(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}{grad_info},\n"
                f"       {self.numpy()!r})")


def _unpickle_tensor(arr, stop_gradient, name):
    return Tensor(arr, stop_gradient=stop_gradient, name=name)


class Parameter(Tensor):
    """Trainable tensor (reference: EagerParamBase). Registered in a
    process-global weak set, as the reference's, so an optimizer made
    without ``parameters`` finds the live ones."""

    __slots__ = ("trainable", "optimize_attr", "regularizer",
                 "is_distributed", "need_clip")

    def __init__(self, data, trainable: bool = True, name: str = ""):
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False
        self.need_clip = True
        self.persistable = True
        _LIVE_PARAMETERS.add(self)

    def __deepcopy__(self, memo):
        """A Parameter with storage of its own on the same device, its
        data, ``stop_gradient`` and attributes, and a fresh name, as
        Paddle names a copied parameter. (The reference's deep copy is a
        plain Tensor keeping the original's name, so its optimizer's
        state dict keys the copies' moments as one.)"""
        new = Parameter(self._data.detach().clone(),
                        trainable=self.trainable, name=unique_name("param"))
        memo[id(self)] = new
        new.stop_gradient = self.stop_gradient
        new.optimize_attr = copy.deepcopy(self.optimize_attr, memo)
        new.regularizer = copy.deepcopy(self.regularizer, memo)
        new.is_distributed = self.is_distributed
        new.need_clip = self.need_clip
        new.persistable = self.persistable
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


_LIVE_PARAMETERS: "weakref.WeakSet[Parameter]" = weakref.WeakSet()


def live_parameters():
    return list(_LIVE_PARAMETERS)
