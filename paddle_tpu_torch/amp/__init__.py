"""paddle_tpu_torch.amp: automatic mixed precision (port of
paddle_tpu/amp/__init__.py).

``auto_cast`` sets the funnel's ``AMP_STATE`` (core/dispatch.py): under
O1 the white-list ops (and ops registered ``amp="cast"``) run on bf16 or
fp16 inputs and the black-list ops on fp32; under O2 every op but the
black list runs in low precision. ``decorate`` at O2 casts a model's
fp32 parameters; ``GradScaler`` scales the loss, unscales the gradients,
skips the step on an inf or NaN and adapts the scale.
"""

from __future__ import annotations

import contextlib

import torch

from ..core import dispatch as _dispatch
from ..core.tensor import Tensor

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "white_list", "black_list", "is_float16_supported",
           "is_bfloat16_supported", "debugging"]

WHITE_LIST = {"matmul", "mm", "bmm", "linear", "conv2d", "conv1d", "conv3d",
              "conv2d_transpose", "einsum", "pallas_flash_attention"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "log", "exp",
              "mean", "sum", "layer_norm", "batch_norm", "group_norm",
              "rms_norm", "softmax_with_cross_entropy", "norm", "cumsum"}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


def _capability(device=None):
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_capability(device)


def is_float16_supported(device=None) -> bool:
    """fp16 arithmetic: any card of compute capability 5.3 or later."""
    cap = _capability(device)
    return cap is not None and cap >= (5, 3)


def is_bfloat16_supported(device=None) -> bool:
    """bf16 arithmetic: compute capability 8.0 or later (an sm_90 card
    says yes)."""
    cap = _capability(device)
    return cap is not None and cap >= (8, 0)


_DTYPE_MAP = {"float16": torch.float16, "bfloat16": torch.bfloat16,
              "fp16": torch.float16, "bf16": torch.bfloat16}


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """Autocast scope (reference auto_cast.py:1029)."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
    prev = _dispatch.AMP_STATE
    if enable and level != "O0":
        _dispatch.AMP_STATE = {
            "enable": True,
            "dtype": _DTYPE_MAP.get(dtype, torch.bfloat16),
            "level": level,
            "white": WHITE_LIST | set(custom_white_list or ()),
            "black": BLACK_LIST | set(custom_black_list or ()),
        }
    else:
        _dispatch.AMP_STATE = None
    try:
        yield
    finally:
        _dispatch.AMP_STATE = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """O2 decoration: cast the models' fp32 parameters to the low
    precision dtype. The optimizers compute every update in fp32 and
    cast back, so master weights are kept by construction."""
    target = _DTYPE_MAP.get(dtype, torch.bfloat16)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p._bump(p._data.detach().to(target))
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaler (reference grad_scaler.py:645)."""

    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.**15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts: set = set()

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        return var.scale(self._scale)

    def unscale_(self, optimizer):
        """Divide the gradients by the scale (in fp32, written back in
        the gradient's dtype) and note whether any is inf or NaN; one
        host sync for all of them."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        inv = 1.0 / self._scale
        finite = None
        with torch.no_grad():
            for p in optimizer._parameter_list:
                g = p._data.grad
                if g is None:
                    continue
                g32 = g.float() * inv
                f = torch.isfinite(g32).all()
                finite = f if finite is None else finite & f
                g.copy_(g32)
        self._found_inf = finite is not None and not bool(finite)
        self._unscaled_opts.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled_opts.discard(id(optimizer))

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def set_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)


class debugging:
    """paddle.amp.debugging: operator statistics through the funnel's
    dispatch hooks."""

    @staticmethod
    def enable_operator_stats_collection():
        stats: dict = {}

        def hook(name):
            stats[name] = stats.get(name, 0) + 1

        _dispatch.DISPATCH_HOOKS.append(hook)
        debugging._stats = stats
        debugging._hook = hook

    @staticmethod
    def disable_operator_stats_collection():
        if getattr(debugging, "_hook", None) in _dispatch.DISPATCH_HOOKS:
            _dispatch.DISPATCH_HOOKS.remove(debugging._hook)
        for k, v in sorted(getattr(debugging, "_stats", {}).items()):
            print(f"  {k}: {v}")
