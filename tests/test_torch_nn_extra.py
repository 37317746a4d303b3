"""Every class of the port's ``nn/layer/extra.py`` against the
reference's, on the CPU.

The deterministic layers (Softmax2D, Unflatten, ZeroPad1D / 3D,
PairwiseDistance, MultiMarginLoss, HSigmoidLoss, LPPool1D / 2D,
MaxUnPool1D-3D, FractionalMaxPool2D / 3D with a given ``random_u``,
AdaptiveLogSoftmaxWithLoss, RNNTLoss) are built in both packages with
the reference's state carried across; outputs and the gradients of a
seeded cotangent with respect to every float input and parameter are
held at fp32 rtol 1e-5 (and 1e-5 of the largest magnitude). The random
ones draw from the port's generator and are held by property:
FeatureAlphaDropout drops whole channels at ~p and equals the
reference's output given the port's mask; FractionalMaxPool's drawn
``u`` gives the reference's output at that ``u``. ``RNNCellBase`` is
the cells' base. ``BeamSearchDecoder`` + ``dynamic_decode`` over a GRU
cell with an embedding and an output layer: the ids equal the
reference's and the scores within rtol 1e-5.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, close, hold, pair

X4 = _f(2, 3, 5, 6, seed=1)


def _i(*shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.int64)


def _unpool_inputs(n):
    """The reference's max pool of a seeded input and its mask."""
    x = {1: _f(2, 3, 8, seed=2), 2: _f(2, 3, 6, 8, seed=2),
         3: _f(1, 2, 4, 4, 6, seed=2)}[n]
    out, mask = getattr(ref.nn.functional, f"max_pool{n}d")(
        ref.to_tensor(x), 2, 2, return_mask=True)
    return [out.numpy(), mask.numpy()]


LAYERS = {
    "Softmax2D": ((), {}, lambda: [X4]),
    "Unflatten": ((1, [2, 3]), {}, lambda: [_f(2, 6, 4, seed=3)]),
    "ZeroPad1D": (([1, 2],), {}, lambda: [_f(2, 3, 5, seed=4)]),
    "ZeroPad3D": ((1,), {}, lambda: [_f(1, 2, 3, 3, 3, seed=5)]),
    "PairwiseDistance": ((), dict(p=3.0, keepdim=True),
                         lambda: [_f(4, 6, seed=6), _f(4, 6, seed=7)]),
    "MultiMarginLoss": ((), dict(p=2, margin=0.5),
                        lambda: [_f(4, 5, seed=8), _i(4, hi=5, seed=9)]),
    "MultiMarginLoss-weight": (
        (), dict(weight=lambda pkg: pkg.to_tensor(_f(5, lo=0.5, hi=2.0)),
                 reduction="sum"),
        lambda: [_f(4, 5, seed=8), _i(4, hi=5, seed=9)]),
    "HSigmoidLoss": ((6, 5), {}, lambda: [_f(4, 6, seed=10),
                                          _i(4, hi=5, seed=11)]),
    "LPPool1D": ((2, 3, 2, 1), {}, lambda: [np.abs(_f(2, 3, 9, seed=12))
                                            + 0.1]),
    "LPPool2D": ((3, 2), dict(ceil_mode=True),
                 lambda: [np.abs(_f(2, 3, 5, 7, seed=13)) + 0.1]),
    "MaxUnPool1D": ((2, 2), {}, lambda: _unpool_inputs(1)),
    "MaxUnPool2D": ((2, 2), {}, lambda: _unpool_inputs(2)),
    "MaxUnPool3D": ((2,), {}, lambda: _unpool_inputs(3)),
    "FractionalMaxPool2D": (([4, 5],), dict(random_u=0.3), lambda: [X4]),
    "FractionalMaxPool3D": (([2, 3, 4],), dict(random_u=0.7),
                            lambda: [_f(1, 2, 5, 6, 7, seed=14)]),
    "AdaptiveLogSoftmaxWithLoss": (
        (8, 12, [4, 8]), dict(div_value=2.0, head_bias=True),
        lambda: [_f(6, 8, seed=15), np.array([0, 3, 4, 7, 8, 11])]),
    "RNNTLoss": ((), dict(fastemit_lambda=0.0),
                 lambda: [_f(2, 4, 3, 5, seed=16),
                          np.array([[1, 2], [3, 0]], np.int32),
                          np.array([4, 3], np.int32),
                          np.array([2, 1], np.int32)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_extra_layers(name):
    args, kw, inputs = LAYERS[name]
    rl, pl = pair(name.split("-")[0], *args, **kw)
    hold(rl, pl, inputs(), what=name)


def test_adaptive_log_softmax_log_prob_and_predict():
    rl, pl = pair("AdaptiveLogSoftmaxWithLoss", 8, 12, [4, 8],
                  div_value=2.0)
    x = _f(6, 8, seed=17)
    close(pl.log_prob(port.to_tensor(x)).numpy(),
          rl.log_prob(ref.to_tensor(x)).numpy(), "log_prob")
    np.testing.assert_array_equal(pl.predict(port.to_tensor(x)).numpy(),
                                  rl.predict(ref.to_tensor(x)).numpy())


def test_feature_alpha_dropout(monkeypatch):
    """Whole channels dropped at ~p; the reference given the port's mask
    computes the port's output; eval is the identity."""
    x = _f(64, 32, 3, 3, seed=18)
    pl = port.nn.FeatureAlphaDropout(p=0.3)
    port.seed(0)
    got = pl(port.to_tensor(x)).numpy()
    flat = got.reshape(64, 32, -1)
    dropped = np.all(flat == flat[..., :1], axis=-1)
    assert abs(dropped.mean() - 0.3) < 0.03, dropped.mean()
    mask = ~dropped[:, :, None, None]
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    want = ref.nn.FeatureAlphaDropout(p=0.3)(ref.to_tensor(x)).numpy()
    close(got, want, "feature alpha dropout")
    pl.eval()
    np.testing.assert_array_equal(pl(port.to_tensor(x)).numpy(), x)


def test_fractional_max_pool_drawn_u():
    x = _f(2, 3, 9, 11, seed=19)
    port.seed(7)
    got = port.nn.FractionalMaxPool2D([4, 5])(port.to_tensor(x)).numpy()
    gen = torch.Generator().manual_seed(7)
    u = float(torch.rand((), generator=gen))
    want = ref.nn.FractionalMaxPool2D([4, 5], random_u=u)(
        ref.to_tensor(x)).numpy()
    assert got.shape == (2, 3, 4, 5)
    np.testing.assert_array_equal(got, want)


def test_rnn_cell_base():
    assert issubclass(port.nn.GRUCell, port.nn.RNNCellBase)
    assert issubclass(port.nn.LSTMCell, port.nn.RNNCellBase)


def _decoder(pkg, V, H, ref_layers=None):
    emb = pkg.nn.Embedding(V, H)
    cell = pkg.nn.GRUCell(H, H)
    out = pkg.nn.Linear(H, V)
    layers = (emb, cell, out)
    if ref_layers is not None:
        for pl, rl in zip(layers, ref_layers):
            pl.set_state_dict(layer_state_from_jax(rl.state_dict(), "cpu"))
    dec = pkg.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                   beam_size=3, embedding_fn=emb,
                                   output_fn=out)
    return dec, layers


def test_beam_search_dynamic_decode():
    V, H, B = 11, 8, 2
    rdec, rlayers = _decoder(ref, V, H)
    pdec, _ = _decoder(port, V, H, rlayers)
    h0 = _f(B, H, seed=20)
    r_ids, r_scores = ref.nn.dynamic_decode(rdec, ref.to_tensor(h0),
                                            max_step_num=6, batch_size=B)
    p_ids, p_scores = port.nn.dynamic_decode(pdec, port.to_tensor(h0),
                                             max_step_num=6, batch_size=B)
    np.testing.assert_array_equal(p_ids.numpy(), r_ids.numpy())
    close(p_scores.numpy(), r_scores.numpy(), "beam scores")
    assert p_ids.shape[:2] == [B, 3]
