"""The port's incubate optimizers (incubate/optimizer: LookAhead,
ModelAverage, DistributedFusedLamb, GradientMergeOptimizer) and ASP
(incubate/asp) against the reference's, on the CPU.

A small MLP is built in the reference and its state carried into the
port (``layer_state_from_jax``); both packages then take the same steps
on the same numpy batch and their parameters (and LookAhead's slow
weights, ModelAverage's averages) are held after every step at fp32 rtol
1e-5 (1e-5 of the tensor's largest magnitude). The inner optimizers are
SGD, or AdamW at lr 1e-4 (AdamW moves an element whose gradient is ~0 by
up to lr whatever the gradient's rounding, tests/test_torch_optimizer.py).
ASP's masks are held exactly; its decorated training at the same bar,
with every pruned weight n:m sparse after each step. The reference's own
tests' cases (tests/test_asp.py, test_llama_incubate.py:120-139) run on
both packages, and the converters carry the incubate state across by
parameter name or refuse.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.incubate.asp as ref_asp
import paddle_tpu.incubate.optimizer  # noqa: F401
import paddle_tpu_torch as port
import paddle_tpu_torch.incubate.asp as port_asp
import paddle_tpu_torch.incubate.optimizer  # noqa: F401
from paddle_tpu_torch.utils.convert import (asp_masks_from_jax,
                                            incubate_optimizer_state_from_jax,
                                            layer_state_from_jax,
                                            optimizer_state_from_jax)

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_nn_layer_common import _f, close

port.set_device("cpu")

X, Y = _f(16, 8), _f(16, 4, seed=1)


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _models():
    ref.seed(5)
    rm = _mlp(ref)
    pm = _mlp(port)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    return rm, pm


def _backward(pkg, model):
    out = model(pkg.to_tensor(X))
    loss = ((out - pkg.to_tensor(Y)) ** 2).mean()
    loss.backward()
    return float(loss.numpy())


def _hold_params(rm, pm, what):
    rs = rm.state_dict()
    for k, v in pm.state_dict().items():
        close(v.numpy(), rs[k].numpy(), f"{what} {k}")


def _inner(pkg, model, kind):
    if kind == "sgd":
        return pkg.optimizer.SGD(learning_rate=0.1,
                                 parameters=model.parameters())
    return pkg.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                               parameters=model.parameters())


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_lookahead_trajectory(kind):
    """k 2, alpha 0.5 over 5 steps: parameters and slow weights after
    every step; the slow weights are copies (a pull leaves them
    untouched by the inner step that follows)."""
    rm, pm = _models()
    opts = {}
    for pkg, m in ((ref, rm), (port, pm)):
        opts[pkg] = pkg.incubate.optimizer.LookAhead(_inner(pkg, m, kind),
                                                     alpha=0.5, k=2)
    for step in range(5):
        for pkg, m in ((ref, rm), (port, pm)):
            _backward(pkg, m)
            opts[pkg].step()
            opts[pkg].clear_grad()
        _hold_params(rm, pm, f"{kind} step {step}")
        for rp, pp in zip(rm.parameters(), pm.parameters()):
            close(opts[port]._slow[id(pp)].numpy(),
                  np.asarray(opts[ref]._slow[id(rp)]), f"slow {step}")
            assert opts[port]._slow[id(pp)].data_ptr() != \
                pp._data.data_ptr()


def test_model_average_apply_restore():
    """ModelAverage over 4 SGD steps: the averages equal the reference's
    inside ``apply()``, and the parameters come back bit for bit after
    it (the context manager and ``restore()`` alike)."""
    rm, pm = _models()
    state = {}
    for pkg, m in ((ref, rm), (port, pm)):
        sgd = _inner(pkg, m, "sgd")
        ma = pkg.incubate.optimizer.ModelAverage(parameters=m.parameters())
        for _ in range(4):
            _backward(pkg, m)
            sgd.step()
            sgd.clear_grad()
            ma.step()
        state[pkg] = (ma, {k: v.numpy().copy()
                           for k, v in m.state_dict().items()})
    _hold_params(rm, pm, "before apply")
    (rma, _), (pma, before) = state[ref], state[port]
    with rma.apply(), pma.apply():
        _hold_params(rm, pm, "averaged")
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k])
    pma.apply(need_restore=False)
    pma.restore()
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k])


def test_distributed_fused_lamb_trajectory():
    rm, pm = _models()
    opts = {pkg: pkg.incubate.optimizer.DistributedFusedLamb(
        learning_rate=1e-3, lamb_weight_decay=0.01,
        parameters=m.parameters()) for pkg, m in ((ref, rm), (port, pm))}
    for step in range(3):
        for pkg, m in ((ref, rm), (port, pm)):
            _backward(pkg, m)
            opts[pkg].step()
            opts[pkg].clear_grad()
        _hold_params(rm, pm, f"lamb step {step}")


def test_gradient_merge_trajectory():
    """k_steps 2 with avg: the inner step runs every second step on the
    mean of the two gradients."""
    rm, pm = _models()
    opts = {pkg: pkg.incubate.optimizer.GradientMergeOptimizer(
        _inner(pkg, m, "sgd"), k_steps=2)
        for pkg, m in ((ref, rm), (port, pm))}
    start = {k: v.numpy().copy() for k, v in pm.state_dict().items()}
    for step in range(4):
        for pkg, m in ((ref, rm), (port, pm)):
            _backward(pkg, m)
            opts[pkg].step()
            opts[pkg].clear_grad()
        _hold_params(rm, pm, f"merge step {step}")
        if step == 0:
            for k, v in pm.state_dict().items():
                np.testing.assert_array_equal(v.numpy(), start[k])


@pytest.mark.parametrize("pkg", [ref, port], ids=["reference", "port"])
def test_reference_case_lookahead_and_model_average(pkg):
    """tests/test_llama_incubate.py:120-139 on either package."""
    m = pkg.nn.Linear(4, 4)
    inner = pkg.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    opt = pkg.incubate.optimizer.LookAhead(inner, alpha=0.5, k=2)
    x = pkg.to_tensor(_f(4, 4))
    for _ in range(4):
        m(x).mean().backward()
        opt.step()
        opt.clear_grad()
    ma = pkg.incubate.optimizer.ModelAverage(parameters=m.parameters())
    w_before = m.weight.numpy().copy()
    ma.step()
    with ma.apply():
        pass
    np.testing.assert_allclose(m.weight.numpy(), w_before)


# -- ASP ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,algo", [((8, 16), "get_mask_1d"),
                                        ((3, 4, 8), "get_mask_1d"),
                                        ((8, 8), "get_mask_2d_greedy"),
                                        ((16, 12), "get_mask_2d_greedy"),
                                        ((6, 8), "get_mask_2d_greedy")])
def test_asp_masks_equal_the_references(shape, algo):
    w = _f(*shape, seed=3)
    want = getattr(ref_asp, algo)(w, 2, 4)
    got = getattr(port_asp, algo)(w, 2, 4)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert port_asp.check_sparsity(got) == ref_asp.check_sparsity(want)
    assert port_asp.calculate_density(got) == ref_asp.calculate_density(want)
    t = port_asp.get_mask_1d(port.to_tensor(w.reshape(-1, 4)))
    np.testing.assert_array_equal(t.numpy(), ref_asp.get_mask_1d(
        w.reshape(-1, 4)))
    assert not port_asp.check_sparsity(np.ones(8)) and \
        not ref_asp.check_sparsity(np.ones(8))


@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_greedy"])
def test_asp_decorated_training_against_reference(algo):
    """prune_model's masks and pruned weights equal the reference's; five
    decorated SGD steps keep every pruned weight 2:4 and equal the
    reference's trajectory; the masks live on the weights' device."""
    rm, pm = _models()
    rmask = ref_asp.prune_model(rm, 2, 4, mask_algo=algo)
    pmask = port_asp.prune_model(pm, 2, 4, mask_algo=algo)
    assert list(pmask) == list(rmask)
    for k in rmask:
        np.testing.assert_array_equal(pmask[k].numpy(), rmask[k].numpy())
        assert pmask[k]._data.device == pm[int(k)].weight._data.device
    _hold_params(rm, pm, "pruned")
    opts = {pkg: pkg.incubate.asp.decorate(_inner(pkg, m, "sgd"))
            for pkg, m in ((ref, rm), (port, pm))}
    for step in range(5):
        for pkg, m in ((ref, rm), (port, pm)):
            _backward(pkg, m)
            opts[pkg].step()
            opts[pkg].clear_grad()
        _hold_params(rm, pm, f"asp step {step}")
        for k in pmask:
            assert port_asp.check_sparsity(pm[int(k)].weight)


@pytest.mark.parametrize("pkg", [ref, port], ids=["reference", "port"])
def test_reference_cases_asp(pkg):
    """tests/test_asp.py's cases on either package."""
    asp = pkg.incubate.asp
    nn = pkg.nn
    rng = np.random.RandomState(0)
    w = rng.randn(8, 16).astype(np.float32)
    mask = asp.get_mask_1d(w, 2, 4)
    assert asp.check_sparsity(mask, 2, 4)
    assert asp.calculate_density(mask) == 0.5
    grp = (np.abs(w) * mask).reshape(-1, 4).sum(1)
    best2 = np.sort(np.abs(w).reshape(-1, 4), axis=1)[:, -2:].sum(1)
    np.testing.assert_allclose(grp, best2, rtol=1e-6)
    w = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    mask = asp.get_mask_2d_greedy(w, 2, 4)
    for i in range(2):
        for j in range(2):
            tile = mask[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4]
            assert (np.count_nonzero(tile, axis=0) == 2).all()
            assert (np.count_nonzero(tile, axis=1) == 2).all()
    pkg.seed(5)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    asp.prune_model(net, n=2, m=4)
    opt = asp.decorate(pkg.optimizer.SGD(learning_rate=0.1,
                                         parameters=net.parameters()))
    X_ = pkg.to_tensor(rng.randn(16, 8).astype(np.float32))
    Y_ = pkg.to_tensor(rng.randint(0, 4, size=(16,)))
    losses = []
    for _ in range(5):
        loss = nn.functional.cross_entropy(net(X_), Y_)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0]
    for _, layer in net.named_sublayers():
        w = getattr(layer, "weight", None)
        if w is not None:
            assert asp.check_sparsity(w, 2, 4)
    asp.reset_excluded_layers()
    pkg.seed(6)
    net = nn.Sequential(nn.Linear(8, 8), nn.Linear(8, 8))
    names = [n for n, _ in net.named_sublayers()]
    asp.set_excluded_layers(net, [names[0]])
    asp.prune_model(net, 2, 4)
    assert not asp.check_sparsity(net[0].weight, 2, 4) or \
        asp.calculate_density(net[0].weight) > 0.5
    assert asp.check_sparsity(net[1].weight, 2, 4)
    asp.reset_excluded_layers(net)


# -- carrying the incubate state across ---------------------------------

def test_lookahead_and_model_average_state_carry_by_name():
    """Three reference LookAhead steps (k 2: one pull, one step into the
    next window), carried into a fresh port LookAhead by parameter name
    (inner AdamW moments by optimizer_state_from_jax, the slow weights
    and window count by incubate_optimizer_state_from_jax): the fourth
    step, which ends the window, matches the reference's. A ModelAverage
    carried the same way averages to the reference's."""
    rm, _ = _models()
    r_in = _inner(ref, rm, "adamw")
    r_la = ref.incubate.optimizer.LookAhead(r_in, alpha=0.5, k=2)
    r_ma = ref.incubate.optimizer.ModelAverage(parameters=rm.parameters())
    for _ in range(3):
        _backward(ref, rm)
        r_la.step()
        r_la.clear_grad()
        r_ma.step()
    pm = _mlp(port)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    p_in = _inner(port, pm, "adamw")
    p_in.set_state_dict(optimizer_state_from_jax(
        r_in.state_dict(), p_in, names=r_in._parameter_names))
    p_la = port.incubate.optimizer.LookAhead(p_in, alpha=0.5, k=2)
    incubate_optimizer_state_from_jax(r_la, p_la,
                                      names=r_la._parameter_names)
    p_ma = port.incubate.optimizer.ModelAverage(parameters=pm.parameters())
    incubate_optimizer_state_from_jax(r_ma, p_ma)
    with r_ma.apply(), p_ma.apply():
        _hold_params(rm, pm, "carried average")
    for pkg, m, opt in ((ref, rm, r_la), (port, pm, p_la)):
        _backward(pkg, m)
        opt.step()
    _hold_params(rm, pm, "after the carried window")
    with pytest.raises(ValueError, match="more than once"):
        incubate_optimizer_state_from_jax(
            r_la, p_la, names=[r_la._parameter_names[0]] * 4)
    with pytest.raises(ValueError, match="by position"):
        incubate_optimizer_state_from_jax(
            r_la, port.incubate.optimizer.LookAhead(
                _inner(port, pm[0], "sgd")))


def test_asp_masks_carry_by_sublayer_name():
    """The reference's prune_model masks registered on the port's model
    by sublayer name: a decorated port optimizer re-applies them."""
    rm, pm = _models()
    rmask = ref_asp.prune_model(rm, 2, 4)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    got = asp_masks_from_jax(rmask, pm)
    assert list(got) == list(rmask)
    opt = port_asp.decorate(_inner(port, pm, "sgd"))
    _backward(port, pm)
    opt.step()
    for k, m in rmask.items():
        w = pm[int(k)].weight.numpy()
        assert np.all(w[m.numpy() == 0] == 0)
    with pytest.raises(KeyError):
        asp_masks_from_jax({"9": rmask["0"]}, pm)
