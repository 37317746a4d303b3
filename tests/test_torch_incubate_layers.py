"""The seven fused Layers of the port's incubate/nn/layer.py against the
reference's (paddle_tpu/incubate/nn/layer.py), on the CPU.

Each Layer is built in both packages with the reference's state carried
by ``utils/convert.py::layer_state_from_jax`` (the 4-D qkv weight
[3, nH, dH, H] included; state dict names equal), then its outputs and
the gradients of a seeded cotangent with respect to its inputs and
parameters are held at fp32 rtol 1e-5 (and 1e-5 of the tensor's largest
magnitude), as every Layer parity test of the port
(tests/torch_nn_layer_common.py). At S 128 and head dim 64 the encoder
layer's attention takes the flash route in both packages (the port's
plain versions of K1-sep and K3-sep on the CPU), held at the same bar.
The reference's own test's cases (tests/test_fused_layers.py) run on
both packages.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_nn_layer_common import _f, close, hold

port.set_device("cpu")


def pair(name, *args, **kwargs):
    """The reference's and the port's ``incubate.nn.<name>``; the port's
    takes the reference's state."""
    rl = getattr(ref.incubate.nn, name)(*args, **kwargs)
    pl = getattr(port.incubate.nn, name)(*args, **kwargs)
    rsd = rl.state_dict()
    assert list(pl.state_dict()) == list(rsd), name
    for k, v in pl.state_dict().items():
        assert list(v.shape) == list(rsd[k].shape), (name, k)
    pl.set_state_dict(layer_state_from_jax(rsd, "cpu"))
    return rl, pl


_CASES = {
    "linear": (("FusedLinear", 8, 4), {}, [_f(3, 8)]),
    "linear_transposed": (("FusedLinear", 8, 4),
                          {"transpose_weight": True}, [_f(2, 3, 8)]),
    "dropout_add": (("FusedDropoutAdd",), {"p": 0.0},
                    [_f(2, 3), _f(2, 3, seed=1)]),
    "bias_dropout_residual_ln": (("FusedBiasDropoutResidualLayerNorm", 8),
                                 {"dropout_rate": 0.0},
                                 [_f(2, 5, 8), _f(2, 5, 8, seed=1)]),
    "mha_pre_ln_mask": (("FusedMultiHeadAttention", 16, 4),
                        {"dropout_rate": 0.0, "attn_dropout_rate": 0.0,
                         "normalize_before": True},
                        [_f(2, 6, 16), None, None, _f(2, 4, 6, 6, seed=2)]),
    "ffn_relu_post_ln": (("FusedFeedForward", 16, 32),
                         {"dropout_rate": 0.0}, [_f(2, 5, 16)]),
    "ffn_gelu_pre_ln": (("FusedFeedForward", 16, 32),
                        {"dropout_rate": 0.0, "activation": "gelu",
                         "normalize_before": True}, [_f(2, 5, 16)]),
    "multi_transformer": (("FusedMultiTransformer", 16, 4, 32),
                          {"num_layers": 2}, [_f(2, 4, 16)]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_layer_against_reference(case):
    """In training mode (the rates are 0: the same function as eval;
    dropout's draws are held by property below). The post-LN encoder
    layer, and with it the post-LN attention, is held by the flash case
    below; the pre-LN stack by ``multi_transformer``."""
    (name, *args), kwargs, inputs = _CASES[case]
    ref.seed(1)
    rl, pl = pair(name, *args, **kwargs)
    hold(rl, pl, inputs, train=True, what=case)


def test_encoder_layer_flash_route_against_reference():
    """At S 128, head dim 64 with no mask and no dropout the attention is
    the op ``pallas_flash_attention`` (flash_attention_raw: K1-sep and
    K3-sep on the card), forward and gradients held to the reference."""
    from paddle_tpu_torch.core import dispatch

    ref.seed(2)
    rl, pl = pair("FusedTransformerEncoderLayer", 128, 2, 256,
                  dropout_rate=0.0, activation="gelu")
    ops = []
    dispatch.DISPATCH_HOOKS.append(ops.append)
    try:
        hold(rl, pl, [(_f(1, 128, 128) * 0.5).astype(np.float32)],
             train=True, what="encoder flash")
    finally:
        dispatch.DISPATCH_HOOKS.remove(ops.append)
    assert ops.count("pallas_flash_attention") == 1
    assert "scaled_dot_product_attention" not in ops


def test_mha_ignores_key_value_and_multi_transformer_caches():
    """The reference's Layers take ``key`` / ``value`` and ``caches`` and
    ignore them; so do the port's."""
    ref.seed(3)
    rl, pl = pair("FusedMultiHeadAttention", 16, 4, dropout_rate=0.0,
                  attn_dropout_rate=0.0)
    x, other = _f(2, 6, 16), _f(2, 6, 16, seed=9)
    for layer, pkg in ((rl, ref), (pl, port)):
        layer.eval()
        a = layer(pkg.to_tensor(x)).numpy()
        b = layer(pkg.to_tensor(x), pkg.to_tensor(other),
                  pkg.to_tensor(other)).numpy()
        np.testing.assert_array_equal(a, b)
    rm, pm = pair("FusedMultiTransformer", 16, 4, 32, num_layers=2)
    for layer, pkg in ((rm, ref), (pm, port)):
        layer.eval()
        np.testing.assert_array_equal(
            layer(pkg.to_tensor(x)).numpy(),
            layer(pkg.to_tensor(x), caches=[object()]).numpy())


def test_dropout_add_train_draws():
    """In training the port's FusedDropoutAdd zeroes a p share of x (5
    sigma at n 65536) and scales the rest by 1/(1-p), as the
    reference's."""
    x = _f(256, 256, lo=1.0, hi=2.0)
    y = _f(256, 256, seed=1)
    p = 0.4
    for pkg in (ref, port):
        layer = pkg.incubate.nn.FusedDropoutAdd(p=p)
        layer.train()
        pkg.seed(4)
        out = layer(pkg.to_tensor(x), pkg.to_tensor(y)).numpy()
        dropped = np.isclose(out, y, rtol=0, atol=1e-6)
        share = dropped.mean()
        assert abs(share - p) < 5 * np.sqrt(p * (1 - p) / x.size), share
        close(out[~dropped], (x / (1 - p) + y)[~dropped], pkg.__name__)


# -- tests/test_fused_layers.py's cases on either package ---------------------

@pytest.fixture(params=[ref, port], ids=["reference", "port"])
def pkg(request):
    return request.param


def test_reference_case_fused_linear(pkg):
    pkg.seed(1)
    fl = pkg.incubate.nn.FusedLinear(8, 4)
    x = pkg.to_tensor(np.random.RandomState(0).randn(3, 8).astype(np.float32))
    want = pkg.nn.functional.linear(x, fl.weight, fl.bias)
    np.testing.assert_allclose(fl(x).numpy(), want.numpy(), rtol=1e-6)
    ft = pkg.incubate.nn.FusedLinear(8, 4, transpose_weight=True)
    assert tuple(ft.weight.shape) == (4, 8)
    assert tuple(ft(x).shape) == (3, 4)


def test_reference_case_dropout_add_and_residual_ln(pkg):
    fd = pkg.incubate.nn.FusedDropoutAdd(p=0.5)
    fd.eval()
    x = pkg.to_tensor(np.ones((2, 3), np.float32))
    y = pkg.to_tensor(np.full((2, 3), 2.0, np.float32))
    np.testing.assert_allclose(fd(x, y).numpy(), 3.0)
    pkg.seed(2)
    m = pkg.incubate.nn.FusedBiasDropoutResidualLayerNorm(8,
                                                          dropout_rate=0.0)
    m.eval()
    rng = np.random.RandomState(0)
    x = pkg.to_tensor(rng.randn(2, 5, 8).astype(np.float32))
    res = pkg.to_tensor(rng.randn(2, 5, 8).astype(np.float32))
    want = pkg.nn.functional.layer_norm(res + x + m.linear_bias, [8],
                                        weight=m.ln_scale, bias=m.ln_bias)
    np.testing.assert_allclose(m(x, res).numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_reference_case_mha_ffn_encoder_stack(pkg):
    pkg.seed(3)
    m = pkg.incubate.nn.FusedMultiHeadAttention(16, 4, dropout_rate=0.0,
                                                attn_dropout_rate=0.0)
    m.eval()
    x = pkg.to_tensor(np.random.RandomState(1).randn(2, 6, 16)
                      .astype(np.float32), stop_gradient=False)
    out = m(x)
    assert tuple(out.shape) == (2, 6, 16)
    out.sum().backward()
    assert x.grad is not None
    assert np.isfinite(m.qkv_weight.grad.numpy()).all()
    pkg.seed(4)
    x = pkg.to_tensor(np.random.RandomState(2).randn(2, 5, 16)
                      .astype(np.float32))
    ffn = pkg.incubate.nn.FusedFeedForward(16, 32, dropout_rate=0.0)
    ffn.eval()
    assert tuple(ffn(x).shape) == (2, 5, 16)
    enc = pkg.incubate.nn.FusedTransformerEncoderLayer(16, 4, 32,
                                                       dropout_rate=0.0)
    enc.eval()
    out = enc(x)
    assert tuple(out.shape) == (2, 5, 16) and np.isfinite(out.numpy()).all()
    pkg.seed(5)
    mt = pkg.incubate.nn.FusedMultiTransformer(16, 4, 32, num_layers=3)
    mt.eval()
    x = pkg.to_tensor(np.random.RandomState(3).randn(2, 4, 16)
                      .astype(np.float32))
    assert tuple(mt(x).shape) == (2, 4, 16)
    one = pkg.incubate.nn.FusedMultiTransformer(16, 4, 32, num_layers=1)
    assert len(mt.layers) == 3 and len(one.layers) == 1
