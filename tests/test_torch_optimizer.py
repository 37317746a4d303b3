"""The port's optimizers, schedulers and gradient clips against the
reference's.

Every optimizer class takes five steps on the same parameters and the
same gradients in both packages; its parameters and every state slot
stay within rtol 1e-6 of the reference's (and 1e-6 of the tensor's
largest magnitude, for entries that cancel to ~0): both sides do the
same fp32 element operations in the same order, the reductions (Lamb's
norms) excepted. Every scheduler of lr.py gives the reference's values
over its first steps; the clips scale as the reference's; a state dict
round-trips, and a reference optimizer's state carried into the port
continues the reference's trajectory.
"""


import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import optimizer_state_from_jax

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401

port.set_device("cpu")
RTOL = 1e-6
SHAPES = [(3, 4), (5,)]
STEPS = 5




def _close(a, b, what, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _inits():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _params(pkg, inits):
    P = pkg.core.tensor.Parameter
    return [P(a.copy()) for a in inits]


def _step(pkg, opt, params, step):
    for p, g in zip(params, _grads(step)):
        p.grad = pkg.to_tensor(g)
    opt.step()
    opt.clear_grad()


CASES = {
    "SGD": lambda m, ps: m.optimizer.SGD(0.1, parameters=ps,
                                         weight_decay=0.01),
    "Momentum": lambda m, ps: m.optimizer.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True, weight_decay=0.02),
    "Adagrad": lambda m, ps: m.optimizer.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adam": lambda m, ps: m.optimizer.Adam(0.01, parameters=ps,
                                           weight_decay=0.01),
    "Adam_amsgrad": lambda m, ps: m.optimizer.Adam(0.01, parameters=ps,
                                                   amsgrad=True),
    "AdamW": lambda m, ps: m.optimizer.AdamW(0.01, parameters=ps,
                                             weight_decay=0.1),
    "Adamax": lambda m, ps: m.optimizer.Adamax(0.01, parameters=ps),
    "AdaDelta": lambda m, ps: m.optimizer.AdaDelta(1.0, parameters=ps),
    "Adadelta": lambda m, ps: m.optimizer.Adadelta(0.5, rho=0.9,
                                                   parameters=ps),
    "RMSProp": lambda m, ps: m.optimizer.RMSProp(0.01, momentum=0.5,
                                                 parameters=ps),
    "RMSProp_centered": lambda m, ps: m.optimizer.RMSProp(
        0.01, centered=True, parameters=ps),
    "Lamb": lambda m, ps: m.optimizer.Lamb(0.01, parameters=ps),
    "Rprop": lambda m, ps: m.optimizer.Rprop(0.01, parameters=ps),
    "ASGD": lambda m, ps: m.optimizer.ASGD(0.05, parameters=ps,
                                           weight_decay=0.01),
    "NAdam": lambda m, ps: m.optimizer.NAdam(0.01, parameters=ps),
    "RAdam": lambda m, ps: m.optimizer.RAdam(0.01, parameters=ps),
    "Ftrl": lambda m, ps: m.optimizer.Ftrl(0.1, l1=0.01, l2=0.01,
                                           parameters=ps),
    "DecayedAdagrad": lambda m, ps: m.optimizer.DecayedAdagrad(
        0.1, parameters=ps),
    "DpSGD": lambda m, ps: m.optimizer.DpSGD(0.1, clip=1.0, sigma=0.0,
                                             parameters=ps),
    "AdamW_clip_sched": lambda m, ps: m.optimizer.AdamW(
        m.optimizer.lr.CosineAnnealingDecay(0.01, T_max=4), parameters=ps,
        grad_clip=m.nn.ClipGradByGlobalNorm(1.0)),
}


def _state_of(opt, p):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in opt._accumulators[id(p)].items()}


def test_every_optimizer_class_is_covered():
    names = {n for n in ref.optimizer.__all__} if hasattr(
        ref.optimizer, "__all__") else set()
    classes = {k.split("_")[0] for k in CASES} | {"LBFGS"}
    exported = {n for n in dir(ref.optimizer)
                if isinstance(getattr(ref.optimizer, n), type)
                and issubclass(getattr(ref.optimizer, n),
                               ref.optimizer.Optimizer)
                and n != "Optimizer"}
    assert exported <= classes, exported - classes
    assert not names or names <= classes | {"Optimizer", "lr"}
    for n in exported:
        assert hasattr(port.optimizer, n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_against_reference(name):
    inits = _inits()
    rp, pp = _params(ref, inits), _params(port, inits)
    ro, po = CASES[name](ref, rp), CASES[name](port, pp)
    for step in range(STEPS):
        _step(ref, ro, rp, step)
        _step(port, po, pp, step)
        if hasattr(ro._learning_rate, "step"):
            ro._learning_rate.step()
            po._learning_rate.step()
        for i, (a, b) in enumerate(zip(pp, rp)):
            _close(a.numpy(), b.numpy(), f"{name} step {step} param {i}")
    for i, (a, b) in enumerate(zip(pp, rp)):
        rs, ps = _state_of(ro, b), _state_of(po, a)
        assert set(ps) == set(rs)
        for k in rs:
            _close(ps[k], rs[k], f"{name} param {i} slot {k}")


def test_lbfgs_against_reference():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x0 = np.zeros(4, np.float32)
    out = {}
    for pkg in (ref, port):
        x = pkg.core.tensor.Parameter(x0.copy())
        opt = pkg.optimizer.LBFGS(learning_rate=0.1, max_iter=6,
                                  parameters=[x])
        At, bt = pkg.to_tensor(A), pkg.to_tensor(b)

        def closure():
            opt.clear_grad()
            loss = ((pkg.matmul(At, x) - bt) ** 2).sum()
            loss.backward()
            return loss

        loss = opt.step(closure)
        out[pkg.__name__] = (x.numpy(), float(loss.numpy()))
    _close(out["paddle_tpu_torch"][0], out["paddle_tpu"][0], "lbfgs x",
           rtol=1e-5)
    _close(out["paddle_tpu_torch"][1], out["paddle_tpu"][1], "lbfgs loss",
           rtol=1e-5)


def test_dpsgd_noise_is_one_scalar_a_step():
    inits = _inits()
    pp = _params(port, inits)
    opt = port.optimizer.DpSGD(1.0, clip=1e9, batch_size=4.0, sigma=2.0,
                               parameters=pp)
    zero = [np.zeros(s, np.float32) for s in SHAPES]
    for p, g in zip(pp, zero):
        p.grad = port.to_tensor(g)
    opt.step()
    moves = [p.numpy() - a for p, a in zip(pp, inits)]
    for m in moves:
        assert np.ptp(m) < 1e-6 and abs(m.flat[0]) > 0


SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(64, 4, learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([2, 5], [1.0, 0.5, 0.1]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, 0.3),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, 0.3),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.5, 4, cycle=True),
    "LinearWarmup": lambda lr: lr.LinearWarmup(
        lr.ExponentialDecay(0.5, 0.9), 3, 0.0, 0.5),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.5, [2, 4]),
    "StepDecay": lambda lr: lr.StepDecay(0.5, 3),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(0.5, 5),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.5, lambda e: 0.95),
    "OneCycleLR": lambda lr: lr.OneCycleLR(1.0, 10),
    "CyclicLR": lambda lr: lr.CyclicLR(0.1, 1.0, 3, mode="triangular2"),
    "LinearLR": lambda lr: lr.LinearLR(0.5, 6),
    "CosineAnnealingWarmRestarts": lambda lr:
        lr.CosineAnnealingWarmRestarts(0.5, 3, T_mult=2),
    "ReduceOnPlateau": lambda lr: lr.ReduceOnPlateau(0.5, patience=1),
}


def test_every_scheduler_is_covered():
    assert set(SCHEDULERS) | {"LRScheduler"} == set(ref.optimizer.lr.__all__)
    assert set(port.optimizer.lr.__all__) == set(ref.optimizer.lr.__all__)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_against_reference(name):
    rs = SCHEDULERS[name](ref.optimizer.lr)
    ps = SCHEDULERS[name](port.optimizer.lr)
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.9, 0.9, 0.9]
    for e in range(10):
        assert ps() == rs(), (name, e)
        if name == "ReduceOnPlateau":
            rs.step(metrics[e])
            ps.step(metrics[e])
        else:
            rs.step()
            ps.step()
    assert ps.state_dict().keys() == rs.state_dict().keys()


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_grad_clip_against_reference(clip):
    inits = _inits()
    grads = [3 * g for g in _grads(0)]
    outs = []
    for pkg in (ref, port):
        c = {"value": lambda: pkg.nn.ClipGradByValue(0.5),
             "norm": lambda: pkg.nn.ClipGradByNorm(1.0),
             "global": lambda: pkg.nn.ClipGradByGlobalNorm(1.5)}[clip]()
        ps = _params(pkg, inits)
        ps[1].need_clip = False
        outs.append(c([(p, pkg.to_tensor(g)) for p, g in zip(ps, grads)]))
    for (_, pg), (_, rg) in zip(*outs):
        _close(pg.numpy(), rg.numpy(), clip)


def test_state_dict_round_trip():
    inits = _inits()
    pp = _params(port, inits)
    opt = port.optimizer.Adam(0.01, parameters=pp)
    for s in range(2):
        _step(port, opt, pp, s)
    sd = opt.state_dict()
    pq = _params(port, [p.numpy() for p in pp])
    opt2 = port.optimizer.Adam(0.01, parameters=pq)
    opt2.set_state_dict(sd)
    for s in range(2, STEPS):
        _step(port, opt, pp, s)
        _step(port, opt2, pq, s)
    for a, b in zip(pq, pp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_reference_state_carried_into_the_port():
    inits = _inits()
    rp = _params(ref, inits)
    ro = ref.optimizer.AdamW(0.01, parameters=rp,
                             weight_decay=0.05)
    for s in range(2):
        _step(ref, ro, rp, s)
    pp = _params(port, [p.numpy() for p in rp])
    po = port.optimizer.AdamW(0.01, parameters=pp, weight_decay=0.05)
    po.set_state_dict(optimizer_state_from_jax(ro.state_dict(), po))
    assert po._step_count == 2
    for s in range(2, STEPS):
        _step(ref, ro, rp, s)
        _step(port, po, pp, s)
    for i, (a, b) in enumerate(zip(pp, rp)):
        _close(a.numpy(), b.numpy(), f"carried param {i}")
