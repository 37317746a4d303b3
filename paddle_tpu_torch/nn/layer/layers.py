"""Layer: the module base class (port of paddle_tpu/nn/layer/layers.py).

Parameter, sublayer and buffer registration through ``__setattr__``,
forward pre/post hooks, ``state_dict`` / ``set_state_dict`` with
structured names, train/eval, and ``to(device, dtype)``. Parameters are
handles over torch tensors on the current device (core/device.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional

import torch

from ...core import device as _device
from ...core.dtype import convert_dtype
from ...core.tensor import Parameter, Tensor, as_torch, unique_name
from .. import initializer as I

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """Parameter attribute bundle (reference: python/paddle/base/param_attr.py).

    Carries name, initializer, learning-rate multiplier, regularizer and
    trainability through layer constructors.
    """

    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        need_clip: bool = True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, bool):
            # False means "no parameter" — caller handles it
            return ParamAttr() if attr else None
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


class HookRemoveHelper:
    _next_id = 0

    def __init__(self, hooks: OrderedDict):
        self._hooks = hooks
        self._hook_id = HookRemoveHelper._next_id
        HookRemoveHelper._next_id += 1

    def remove(self):
        self._hooks.pop(self._hook_id, None)


_unique_name = unique_name


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype: str = "float32"):
        self.training = True
        self._full_name = _unique_name(
            name_scope or self.__class__.__name__.lower()
        )
        self._dtype = dtype
        self._parameters: OrderedDict[str, Parameter] = OrderedDict()
        self._sub_layers: OrderedDict[str, Layer] = OrderedDict()
        self._buffers: OrderedDict[str, Optional[Tensor]] = OrderedDict()
        self._non_persistable_buffer_names: set[str] = set()
        self._forward_pre_hooks: OrderedDict[int, Callable] = OrderedDict()
        self._forward_post_hooks: OrderedDict[int, Callable] = OrderedDict()
        self._casted_by_pure_fp16 = False
        self._state_dict_hooks: OrderedDict[int, Callable] = OrderedDict()

    # -- construction helpers ----------------------------------------------
    def create_parameter(
        self,
        shape,
        attr=None,
        dtype: Optional[str] = None,
        is_bias: bool = False,
        default_initializer=None,
    ) -> Optional[Parameter]:
        """reference: layers.py Layer.create_parameter."""
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        dtype = dtype or self._dtype
        init = (
            attr.initializer
            or I.global_initializer(is_bias)
            or default_initializer
            or (I.Constant(0.0) if is_bias else I.XavierNormal())
        )
        data = init(list(shape), dtype)
        p = Parameter(data, trainable=attr.trainable,
                      name=attr.name or _unique_name("param"))
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_variable(self, name=None, persistable=False, dtype=None):
        t = Tensor(torch.zeros([], dtype=convert_dtype(dtype or self._dtype),
                               device=_device.current_device()))
        t.name = name or _unique_name("var")
        t.persistable = persistable
        return t

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True):
        if "_buffers" not in self.__dict__:
            raise RuntimeError("call Layer.__init__ first")
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        # a registered name must live in exactly one of the three tables
        self.__dict__.pop(name, None)
        self._parameters.pop(name, None)
        self._sub_layers.pop(name, None)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        else:
            self._non_persistable_buffer_names.discard(name)

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError(f"{name} is not a Parameter")
        self.__dict__.pop(name, None)
        self._buffers.pop(name, None)
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: Optional["Layer"]):
        if sublayer is not None and not isinstance(sublayer, Layer):
            raise TypeError(f"{name} is not a Layer")
        self.__dict__.pop(name, None)
        self._sub_layers[name] = sublayer
        return sublayer

    # -- attribute magic ----------------------------------------------------
    def __setattr__(self, name: str, value: Any):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning params")
            if buffers is not None:
                buffers.pop(name, None)
            if layers is not None:
                layers.pop(name, None)
            self.__dict__.pop(name, None)
            params[name] = value
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning layers")
            if params is not None:
                params.pop(name, None)
            if buffers is not None:
                buffers.pop(name, None)
            self.__dict__.pop(name, None)
            layers[name] = value
        elif params is not None and name in params:
            if value is None:
                params[name] = None
            else:
                raise TypeError(
                    f"cannot assign non-Parameter to parameter slot {name!r}"
                )
        elif layers is not None and name in layers:
            if value is None:
                layers[name] = None
            else:
                raise TypeError(f"cannot assign non-Layer to layer slot {name!r}")
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                buffers[name] = Tensor(value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        if "_parameters" in self.__dict__ and name in self.__dict__["_parameters"]:
            return self.__dict__["_parameters"][name]
        if "_sub_layers" in self.__dict__ and name in self.__dict__["_sub_layers"]:
            return self.__dict__["_sub_layers"][name]
        if "_buffers" in self.__dict__ and name in self.__dict__["_buffers"]:
            return self.__dict__["_buffers"][name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}"
        )

    def __delattr__(self, name: str):
        if name in self._parameters:
            del self._parameters[name]
        elif name in self._sub_layers:
            del self._sub_layers[name]
        elif name in self._buffers:
            del self._buffers[name]
            self._non_persistable_buffer_names.discard(name)
        else:
            object.__delattr__(self, name)

    def __dir__(self):
        return list(
            set(
                list(super().__dir__())
                + list(self._parameters)
                + list(self._sub_layers)
                + list(self._buffers)
            )
        )

    # -- call / hooks -------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        helper = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[helper._hook_id] = hook
        return helper

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        helper = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[helper._hook_id] = hook
        return helper

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> list[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(
        self, prefix: str = "", include_sublayers: bool = True
    ) -> Iterator[tuple[str, Parameter]]:
        memo = set()
        layers = (
            self.named_sublayers(prefix=prefix, include_self=True)
            if include_sublayers
            else [(prefix, self)]
        )
        for layer_prefix, layer in layers:
            for name, p in layer._parameters.items():
                if p is None or id(p) in memo:
                    continue
                memo.add(id(p))
                yield (layer_prefix + ("." if layer_prefix else "") + name, p)

    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self) -> Iterator[tuple[str, "Layer"]]:
        memo = set()
        for name, l in self._sub_layers.items():
            if l is not None and id(l) not in memo:
                memo.add(id(l))
                yield name, l

    def sublayers(self, include_self: bool = False) -> list["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(
        self, prefix: str = "", include_self: bool = False, layers_set=None
    ) -> Iterator[tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, l in self._sub_layers.items():
            if l is None:
                continue
            sub_prefix = prefix + ("." if prefix else "") + name
            yield from l.named_sublayers(
                prefix=sub_prefix, include_self=True, layers_set=layers_set
            )

    def buffers(self, include_sublayers: bool = True) -> list[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(
        self, prefix: str = "", include_sublayers: bool = True
    ) -> Iterator[tuple[str, Tensor]]:
        memo = set()
        layers = (
            self.named_sublayers(prefix=prefix, include_self=True)
            if include_sublayers
            else [(prefix, self)]
        )
        for layer_prefix, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in memo:
                    continue
                memo.add(id(b))
                yield (layer_prefix + ("." if layer_prefix else "") + name, b)

    def apply(self, fn: Callable[["Layer"], None]) -> "Layer":
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # -- modes --------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- state dict ---------------------------------------------------------
    def state_dict(
        self,
        destination=None,
        include_sublayers: bool = True,
        structured_name_prefix: str = "",
        use_hook: bool = True,
    ) -> dict:
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(
            prefix=structured_name_prefix.rstrip("."),
            include_sublayers=include_sublayers,
        ):
            dest[name] = p
        for name, b in self.named_buffers(
            prefix=structured_name_prefix.rstrip("."),
            include_sublayers=include_sublayers,
        ):
            # skip non-persistable buffers (match reference state_dict)
            owner, _, leaf = name.rpartition(".")
            skip = False
            for lp, layer in self.named_sublayers(include_self=True):
                if lp == owner and leaf in layer._non_persistable_buffer_names:
                    skip = True
                    break
            if not skip:
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict: dict, use_structured_name: bool = True):
        missing, unexpected = [], []
        own = self.state_dict()
        matched = {}
        for k, v in state_dict.items():
            if k in own:
                matched[k] = v
            else:
                unexpected.append(k)
        for k in own:
            if k not in matched:
                missing.append(k)
        for k, v in matched.items():
            target = own[k]
            d = target._data
            v = v._data if isinstance(v, Tensor) else as_torch(
                v, device=d.device)
            if tuple(v.shape) != tuple(d.shape):
                raise ValueError(
                    f"shape mismatch for {k}: got {tuple(v.shape)}, "
                    f"expected {tuple(d.shape)}"
                )
            target.set_value(Tensor(v.to(device=d.device, dtype=d.dtype)))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype/device movement ---------------------------------------------
    def _transform(self, fn):
        for t in list(self.parameters()) + list(self.buffers()):
            new = fn(t._data.detach())
            if new is not t._data and new.data_ptr() != t._data.data_ptr():
                t._bump(new)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Move the parameters and buffers to ``device`` ('cpu', 'gpu:N')
        and cast the floating ones to ``dtype``."""
        if device is not None:
            dev = _device._cuda(device)
            self._transform(lambda a: a.to(dev))
        if dtype is not None:
            dt = convert_dtype(dtype)
            self._dtype = str(dt).replace("torch.", "")
            self._transform(
                lambda a: a.to(dt) if a.dtype.is_floating_point else a)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def float16(self):
        return self.to(dtype="float16")

    # -- misc ---------------------------------------------------------------
    def full_name(self) -> str:
        return self._full_name

    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, l in self._sub_layers.items():
            mod_str = repr(l)
            mod_str = "\n".join(
                "  " + line for line in mod_str.split("\n")
            )
            lines.append(f"  ({name}): {mod_str.strip()}")
        main = self.__class__.__name__ + "("
        if extra and not lines:
            return main + extra + ")"
        if lines:
            return main + (extra + "\n" if extra else "\n") + "\n".join(lines) + "\n)"
        return main + ")"

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()
