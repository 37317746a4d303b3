"""The port's recurrent layers (``nn.SimpleRNN``, ``nn.LSTM``,
``nn.GRU``, their cells, ``nn.RNN``, ``nn.BiRNN``) against the
reference's, on the CPU.

Each layer is built in both packages with the reference's weights
carried across (``weight_ih_l{k}[_reverse]``, ..., the reference's names
and order); outputs, final states and the gradients of a seeded
cotangent with respect to the input, the initial states and every
weight are held at fp32 rtol 1e-5 (and 1e-5 of the largest magnitude):
forward and bidirectional, 2 layers, batch- and time-major, with and
without initial states, the relu SimpleRNN; the cells alone and inside
``RNN`` (reversed) and ``BiRNN``. The inter-layer dropout
draws from the port's generator: held by its kept share and by the
eval output equal to the reference's.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, close, pair

B, T, I, H = 3, 5, 4, 6


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _tensors(pkg, state):
    if isinstance(state, tuple):
        return tuple(pkg.to_tensor(a, stop_gradient=False) for a in state)
    return pkg.to_tensor(state, stop_gradient=False)


def _run(pkg, layer, x, state):
    xt = pkg.to_tensor(x, stop_gradient=False)
    st = None if state is None else _tensors(pkg, state)
    out = layer(xt, st) if st is not None else layer(xt)
    leaves = [xt] + _flat(st if st is not None else [])
    names = ["input"] + [f"state {i}" for i in range(len(leaves) - 1)]
    for n, p in layer.named_parameters():
        leaves.append(p)
        names.append(n)
    return _flat(out), leaves, names


def hold_rnn(rl, pl, x, state=None, what=""):
    """Every output and state, then the gradients of a seeded cotangent
    over all of them with respect to the input, the initial states and
    every weight."""
    for layer in (rl, pl):
        layer.eval()
    r_outs, r_in, _ = _run(ref, rl, x, state)
    p_outs, p_in, names = _run(port, pl, x, state)
    assert len(p_outs) == len(r_outs), what
    for j, (po, ro) in enumerate(zip(p_outs, r_outs)):
        close(po.numpy(), ro.numpy(), f"{what} output {j}")
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(tuple(ro.shape)).astype(np.float32)
            for ro in r_outs]
    r_g = ref.grad(r_outs, r_in, [ref.to_tensor(c) for c in cots],
                   allow_unused=True)
    p_g = port.grad(p_outs, p_in, [port.to_tensor(c) for c in cots],
                    allow_unused=True)
    for pg, rg, x_, name in zip(p_g, r_g, p_in, names):
        zero = np.zeros(tuple(x_.shape), np.float32)
        close(zero if pg is None else pg.numpy(),
              zero if rg is None else rg.numpy(), f"{what} grad of {name}")


@pytest.mark.parametrize("case", [
    ("forward", False, False), ("bidirect", True, True)],
    ids=["fwd-batch", "bi-time-h0"])
@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_layers(name, case):
    direction, time_major, init = case
    rl, pl = pair(name, I, H, num_layers=2, direction=direction,
                  time_major=time_major)
    x = _f(T, B, I, seed=1) if time_major else _f(B, T, I, seed=1)
    state = None
    if init:
        n = 2 * (2 if direction == "bidirect" else 1)
        h0 = _f(n, B, H, seed=2)
        state = (h0, _f(n, B, H, seed=3)) if name == "LSTM" else h0
    hold_rnn(rl, pl, x, state, what=f"{name} {case}")


def test_simple_rnn_relu():
    rl, pl = pair("SimpleRNN", I, H, activation="relu")
    hold_rnn(rl, pl, _f(B, T, I, seed=4), what="SimpleRNN relu")


@pytest.mark.parametrize("name", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells(name):
    rl, pl = pair(name, I, H)
    hold_rnn(rl, pl, _f(B, I, seed=5), what=name)
    h = _f(B, H, seed=6)
    state = (h, _f(B, H, seed=7)) if name == "LSTMCell" else h
    hold_rnn(rl, pl, _f(B, I, seed=5), state, what=f"{name} h0")


@pytest.mark.parametrize("cell", ["GRUCell", "LSTMCell"])
def test_rnn_and_birnn_wrappers(cell):
    rl, pl = pair("RNN", lambda pkg: getattr(pkg.nn, cell)(I, H),
                  is_reverse=True)
    hold_rnn(rl, pl, _f(B, T, I, seed=8), what=f"RNN({cell})")
    rl, pl = pair("BiRNN", lambda pkg: getattr(pkg.nn, cell)(I, H),
                  lambda pkg: getattr(pkg.nn, cell)(I, H))
    hold_rnn(rl, pl, _f(B, T, I, seed=9), what=f"BiRNN({cell})")


def test_state_dict_names():
    rl, pl = pair("LSTM", I, H, num_layers=2, direction="bidirect")
    names = list(pl.state_dict())
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert names[4] == "weight_ih_l0_reverse" and len(names) == 16


def test_inter_layer_dropout():
    """Training draws a mask between layers from the port's generator
    (the same seed, the same mask); eval equals the reference's output.
    The kept share and scale: a 2-layer relu SimpleRNN whose recurrent
    weights and biases are 0 and whose second layer's input weights are
    the identity passes the dropped first-layer output straight through:
    ~(1 - p) of it kept, each kept value the first layer's / (1 - p)."""
    rl, pl = pair("GRU", I, H, num_layers=2, dropout=0.25)
    x = _f(B, T, I, seed=10)
    pl.train()
    outs = []
    for seed in (0, 0, 1):
        port.seed(seed)
        outs.append(pl(port.to_tensor(x))[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    hold_rnn(rl, pl, x, what="GRU eval")

    n, p = 64, 0.25
    two = port.nn.SimpleRNN(n, n, num_layers=2, dropout=p,
                            activation="relu")
    one = port.nn.SimpleRNN(n, n, activation="relu")
    rng = np.random.default_rng(11)
    w0 = np.abs(rng.standard_normal((n, n))).astype(np.float32) / n
    weights = {"weight_ih_l0": w0, "weight_ih_l1": np.eye(n, dtype="f4")}
    for layer in (two, one):
        for name, t in layer.state_dict().items():
            t.set_value(weights.get(name, np.zeros(t.shape, np.float32)))
    xs = np.abs(_f(16, 8, n, seed=12))
    port.seed(5)
    got = two(port.to_tensor(xs))[0].numpy()
    first = one(port.to_tensor(xs))[0].numpy()
    kept = got != 0
    assert abs(kept.mean() - (1 - p)) < 0.02, kept.mean()
    np.testing.assert_allclose(got[kept], first[kept] / (1 - p), rtol=1e-6)
