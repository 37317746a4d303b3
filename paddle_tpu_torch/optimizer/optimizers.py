"""The optimizers (port of paddle_tpu/optimizer/optimizers.py): SGD,
Momentum, Adagrad, Adam, AdamW, Adamax, AdaDelta, RMSProp, Lamb, LBFGS,
Rprop, ASGD, NAdam, RAdam, Ftrl, DecayedAdagrad, DpSGD.

Each ``_update`` is the reference's, op for op, in fp32 torch. DpSGD's
noise is drawn from a torch generator: the reference's distribution,
not its bits.
"""

from __future__ import annotations

import torch

from ..core import random as prandom
from .optimizer import Optimizer, _f32, _sqrt

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax", "Ftrl",
           "DecayedAdagrad", "DpSGD", "AdaDelta", "Adadelta", "RMSProp",
           "Lamb", "LBFGS", "Rprop", "ASGD", "NAdam", "RAdam"]


def _zeros(p):
    return torch.zeros_like(p._data, dtype=torch.float32)


def _where(c, a, b):
    """``torch.where`` with a Python scalar on either side, made a tensor
    like the other side (at least one side is a tensor)."""
    like = a if isinstance(a, torch.Tensor) else b
    a = a if isinstance(a, torch.Tensor) else torch.full_like(like, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(like, b)
    return torch.where(c, a, b)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        return (p - (lr * g).to(p.dtype)), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        v = self._momentum * state["velocity"] + g
        step = g + self._momentum * v if self._nesterov else v
        return (p - (lr * step).to(p.dtype)), {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_slot(self, p):
        return {"moment": torch.full_like(p._data, self._init_val,
                                          dtype=torch.float32)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        m = state["moment"] + torch.square(g)
        step = g / (_sqrt(m) + self._epsilon)
        return (p - (lr * step).to(p.dtype)), {"moment": m}


class Adam(Optimizer):
    """reference: python/paddle/optimizer/adam.py; kernel math
    phi/kernels/funcs/adam_functors.h."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _init_slot(self, p):
        slot = {"moment1": _zeros(p), "moment2": _zeros(p)}
        if self._amsgrad:
            slot["moment2_max"] = _zeros(p)
        return slot

    def _ctx(self):
        t = self._step_value
        return {"bias1": 1.0 - self._beta1 ** t,
                "bias2": 1.0 - self._beta2 ** t}

    def _decoupled_wd(self) -> bool:
        return False

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        pf = _f32(p)
        wd = ctx["wd"]
        if not self._decoupled_wd():
            g = g + wd * pf  # L2-regularization form (Adam)
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        m2 = self._beta2 * state["moment2"] + \
            (1 - self._beta2) * torch.square(g)
        m1_hat = m1 / ctx["bias1"]
        if self._amsgrad:
            m2_max = torch.maximum(state.get("moment2_max", m2), m2)
            m2_hat = m2_max / ctx["bias2"]
        else:
            m2_hat = m2 / ctx["bias2"]
        new_p = pf - lr * m1_hat / (_sqrt(m2_hat) + self._epsilon)
        if self._decoupled_wd():
            new_p = new_p - lr * wd * pf  # decoupled decay (AdamW)
        new_state = {"moment1": m1, "moment2": m2}
        if self._amsgrad:
            new_state["moment2_max"] = m2_max
        return new_p.to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         False, amsgrad, name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self):
        return True

    def _effective_wd(self, p):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            return 0.0
        return super()._effective_wd(p)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slot(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _ctx(self):
        return {"bias1": 1.0 - self._beta1 ** self._step_value}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        step = m / (ctx["bias1"] * (u + self._epsilon))
        return (p - (lr * step).to(p.dtype)), {"moment": m, "inf_norm": u}


class AdaDelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_slot(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        asg = self._rho * state["avg_squared_grad"] + \
            (1 - self._rho) * torch.square(g)
        update = (_sqrt(state["avg_squared_update"] + self._epsilon)
                  / _sqrt(asg + self._epsilon)) * g
        asu = self._rho * state["avg_squared_update"] + \
            (1 - self._rho) * torch.square(update)
        return (p - (lr * update).to(p.dtype)), {
            "avg_squared_grad": asg, "avg_squared_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slot(self, p):
        slot = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            slot["mean_grad"] = _zeros(p)
        return slot

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        g = g + ctx["wd"] * _f32(p)
        ms = self._rho * state["mean_square"] + \
            (1 - self._rho) * torch.square(g)
        new_state = {"mean_square": ms}
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g
            denom = _sqrt(ms - torch.square(mg) + self._epsilon)
            new_state["mean_grad"] = mg
        else:
            denom = _sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + lr * g / denom
        new_state["momentum"] = mom
        return (p - mom.to(p.dtype)), new_state


class Lamb(Optimizer):
    """reference: python/paddle/optimizer/lamb.py."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, always_adapt=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _ctx(self):
        t = self._step_value
        return {"bias1": 1.0 - self._beta1 ** t,
                "bias2": 1.0 - self._beta2 ** t}

    def _effective_wd(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return super()._effective_wd(p)

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        pf = _f32(p)
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        m2 = self._beta2 * state["moment2"] + \
            (1 - self._beta2) * torch.square(g)
        m1_hat = m1 / ctx["bias1"]
        m2_hat = m2 / ctx["bias2"]
        r = m1_hat / (_sqrt(m2_hat) + self._epsilon) + ctx["wd"] * pf
        w_norm = _sqrt(torch.sum(pf * pf))
        r_norm = _sqrt(torch.sum(r * r))
        trust = _where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        return (pf - lr * trust * r).to(p.dtype), {
            "moment1": m1, "moment2": m2}


class LBFGS(Optimizer):
    """Limited-memory BFGS, a host loop over a closure that re-evaluates
    loss and gradients (reference: python/paddle/optimizer/lbfgs.py)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []

    def _flat_params(self):
        return torch.cat([_f32(p._data.detach()).reshape(-1)
                          for p in self._parameter_list])

    def _flat_grads(self):
        return torch.cat([
            _f32(p.grad._data).reshape(-1) if p.grad is not None
            else torch.zeros(p._data.numel(), dtype=torch.float32,
                             device=p._data.device)
            for p in self._parameter_list])

    def _assign_flat(self, flat):
        offset = 0
        with torch.no_grad():
            for p in self._parameter_list:
                n = p._data.numel()
                p._data.copy_(flat[offset:offset + n].reshape(p._data.shape))
                offset += n

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        loss = closure()
        flat_grad = self._flat_grads()
        if float(torch.max(torch.abs(flat_grad))) <= self._tol_grad:
            return loss
        lr = self.get_lr()
        for _ in range(self._max_iter):
            q = flat_grad
            alphas = []
            for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((a, rho, s, y))
            if self._y_hist:
                y_last, s_last = self._y_hist[-1], self._s_hist[-1]
                gamma = torch.dot(s_last, y_last) / (
                    torch.dot(y_last, y_last) + 1e-10)
                q = gamma * q
            for a, rho, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            direction = -q
            x0 = self._flat_params()
            self._assign_flat(x0 + lr * direction)
            new_loss = closure()
            new_grad = self._flat_grads()
            s = lr * direction
            y = new_grad - flat_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self._history:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
            if float(torch.abs(new_loss._data - loss._data)) < \
                    self._tol_change:
                return new_loss
            loss, flat_grad = new_loss, new_grad
        return loss


Adadelta = AdaDelta  # reference spells it Adadelta (optimizer/adadelta.py)


class Rprop(Optimizer):
    """Resilient backprop (reference optimizer/rprop.py)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_slot(self, p):
        return {"prev_grad": _zeros(p),
                "step_size": torch.full_like(p._data, float(self.get_lr()),
                                             dtype=torch.float32)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g)
        sign = torch.sign(g * state["prev_grad"])
        factor = _where(sign > 0, self._eta_pos,
                        _where(sign < 0, self._eta_neg,
                               torch.ones_like(g)))
        step = torch.clamp(state["step_size"] * factor, self._lr_min,
                           self._lr_max)
        g_eff = _where(sign < 0, 0.0, g)
        new_p = p - (step * torch.sign(g_eff)).to(p.dtype)
        return new_p, {"prev_grad": g_eff, "step_size": step}


class ASGD(Optimizer):
    """Averaged SGD (reference optimizer/asgd.py): a plain SGD step plus
    a running (Polyak) average of the iterates."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._batch_num = batch_num

    def _init_slot(self, p):
        return {"avg": _f32(p._data.detach()).clone(),
                "n": torch.zeros((), dtype=torch.float32,
                                 device=p._data.device)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        new_p32 = _f32(p) - lr * g
        n = state["n"] + 1.0
        avg = state["avg"] + (new_p32 - state["avg"]) / n
        return new_p32.to(p.dtype), {"avg": avg, "n": n}

    def averaged_params(self):
        from ..core.tensor import Tensor

        return [Tensor(self._get_state(p)["avg"].to(p._data.dtype),
                       stop_gradient=True) for p in self._parameter_list]

    def finalize(self):
        """Copy the running averages into the live parameters."""
        with torch.no_grad():
            for p in self._parameter_list:
                p._data.copy_(self._get_state(p)["avg"])


class NAdam(Optimizer):
    """Nesterov Adam (reference optimizer/nadam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._psi = momentum_decay

    def _init_slot(self, p):
        return {"m": _zeros(p), "v": _zeros(p),
                "mu_prod": torch.ones((), dtype=torch.float32,
                                      device=p._data.device)}

    def _ctx(self):
        t = self._step_value
        mu_t = self._beta1 * (1.0 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        return {"mu_t": mu_t, "mu_t1": mu_t1,
                "bias2": 1.0 - self._beta2 ** self._step_value}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        mu_prod = state["mu_prod"] * ctx["mu_t"]
        m = self._beta1 * state["m"] + (1 - self._beta1) * g
        v = self._beta2 * state["v"] + (1 - self._beta2) * g * g
        m_hat = (ctx["mu_t1"] * m / (1 - mu_prod * ctx["mu_t1"])
                 + (1 - ctx["mu_t"]) * g / (1 - mu_prod))
        v_hat = v / ctx["bias2"]
        step = m_hat / (_sqrt(v_hat) + self._epsilon)
        return (p - (lr * step).to(p.dtype)), {
            "m": m, "v": v, "mu_prod": mu_prod}


class RAdam(Optimizer):
    """Rectified Adam (reference optimizer/radam.py): the rectification
    term gates between SGD with momentum and Adam. The per-step scalars
    are fp32 computations, as the reference's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slot(self, p):
        return {"m": _zeros(p), "v": _zeros(p)}

    def _ctx(self):
        t = torch.tensor(self._step_value, dtype=torch.float32)
        rho_inf = 2.0 / (1.0 - self._beta2) - 1.0
        b2t = self._beta2 ** t
        rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
        r = (((rho_t - 4.0) * (rho_t - 2.0) * rho_inf)
             / ((rho_inf - 4.0) * (rho_inf - 2.0)
                * torch.clamp(rho_t, min=1e-6)))
        rect = _sqrt(torch.clamp(r, min=0.0))
        return {"bias1": 1.0 - self._beta1 ** t, "bias2": 1.0 - b2t,
                "rho_t": rho_t, "rect": rect}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        m = self._beta1 * state["m"] + (1 - self._beta1) * g
        v = self._beta2 * state["v"] + (1 - self._beta2) * g * g
        m_hat = m / ctx["bias1"]
        v_hat = _sqrt(v / ctx["bias2"])
        adam_step = ctx["rect"] * m_hat / (v_hat + self._epsilon)
        step = torch.where(ctx["rho_t"] > 5.0, adam_step, m_hat)
        return (p - (lr * step).to(p.dtype)), {"m": m, "v": v}


class Ftrl(Optimizer):
    """FTRL-proximal (reference ftrl op): z/n accumulators with L1/L2
    shrinkage."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, False)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_slot(self, p):
        return {"squared": _zeros(p), "linear": _zeros(p)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        n, z = state["squared"], state["linear"]
        n_new = n + torch.square(g)
        sigma = (n_new ** -self._lr_power - n ** -self._lr_power) / lr
        z_new = z + g - sigma * _f32(p)
        quad = n_new ** -self._lr_power / lr + 2 * self._l2
        pruned = torch.abs(z_new) > self._l1
        p_new = _where(pruned, (torch.sign(z_new) * self._l1 - z_new) / quad,
                       0.0)
        return p_new.to(p.dtype), {"squared": n_new, "linear": z_new}


class DecayedAdagrad(Optimizer):
    """decayed_adagrad: Adagrad with accumulator decay."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, False)
        self._decay, self._epsilon = decay, epsilon

    def _init_slot(self, p):
        return {"moment": _zeros(p)}

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        m = self._decay * state["moment"] + \
            (1 - self._decay) * torch.square(g)
        step = g / (_sqrt(m) + self._epsilon)
        return (p - (lr * step).to(p.dtype)), {"moment": m}


class DpSGD(Optimizer):
    """dpsgd: clipped SGD plus one Gaussian noise scalar a step, std
    sigma / batch_size, shared across the elements (reference
    phi/kernels/dpsgd_kernel)."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, False)
        self._clip, self._batch, self._sigma = clip, batch_size, sigma
        # the noise stream's seed, drawn from the package generator
        self._noise_seed = int(torch.randint(
            2 ** 31 - 1, (1,),
            generator=prandom.default_generator().torch_generator("cpu")))
        self._noise_gen: dict = {}

    def _init_slot(self, p):
        return {"t": torch.zeros((), dtype=torch.int32,
                                 device=p._data.device)}

    def _noise(self, device):
        g = self._noise_gen.get(device)
        if g is None:
            g = self._noise_gen[device] = torch.Generator(
                device=device).manual_seed(self._noise_seed)
        return torch.randn((), generator=g, device=device)

    def _update(self, g, p, state, lr, ctx):
        g = _f32(g) + ctx["wd"] * _f32(p)
        norm = _sqrt(torch.sum(torch.square(g)))
        scale = torch.clamp(self._clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        noise = self._noise(g.device) * self._sigma / self._batch
        step = g * scale + noise
        return (p - (lr * step).to(p.dtype)), {"t": state["t"] + 1}
