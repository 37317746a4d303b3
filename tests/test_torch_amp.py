"""AMP on both packages: the AMP cases of the reference's test_amp_io.py
(O1 autocast of a white-list op, a black-list op kept in fp32, custom
lists, the dynamic GradScaler, the skipped step on an inf, O2
decoration), run on ``paddle_tpu`` and ``paddle_tpu_torch`` with the
same weights; the reference's softmax (not ported yet) is replaced by
``exp``, another black-list op, and its ``nn.Linear`` by a two-parameter
Layer of the same function."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401

paddle_tpu_torch.set_device("cpu")
PKGS = {"ref": paddle_tpu, "port": paddle_tpu_torch}


@pytest.fixture(params=sorted(PKGS))
def pt(request):
    return PKGS[request.param]


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_REF_LAYERS = {}


def _linear(pkg, i, o):
    """x @ W + b with the reference's initial weights on both packages."""
    class Lin(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([i, o])
            self.bias = self.create_parameter([o], is_bias=True)

        def forward(self, x):
            return pkg.matmul(x, self.weight) + self.bias

    m = Lin()
    key = (i, o)
    if key not in _REF_LAYERS:
        if pkg is paddle_tpu:
            _REF_LAYERS[key] = {k: v.numpy()
                                for k, v in m.state_dict().items()}
        else:
            r = _linear(paddle_tpu, i, o)
            _REF_LAYERS[key] = {k: v.numpy()
                                for k, v in r.state_dict().items()}
    state = _REF_LAYERS[key]
    if pkg is paddle_tpu_torch:
        m.set_state_dict(layer_state_from_jax(state, "cpu"))
    else:
        m.set_state_dict(state)
    return m


def test_autocast_o1_casts_matmul(pt):
    x, w = pt.to_tensor(_x(4, 8)), pt.to_tensor(_x(8, 8, seed=1))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = x.matmul(w)
    assert _dt(y) == "bfloat16"
    assert _dt(x.matmul(w)) == "float32"


def test_autocast_black_list_keeps_fp32(pt):
    x = pt.to_tensor(_x(4, 8)).astype("bfloat16")
    with pt.amp.auto_cast(level="O1"):
        s = pt.exp(x)
        m = x.mean()
    assert _dt(s) == "float32" and _dt(m) == "float32"
    assert _dt(pt.exp(x)) == "bfloat16"


def test_autocast_custom_lists(pt):
    x, w = pt.to_tensor(_x(4, 8)), pt.to_tensor(_x(8, 8, seed=1))
    with pt.amp.auto_cast(level="O1", custom_black_list={"matmul"}):
        y = x.matmul(w)
    assert _dt(y) == "float32"
    with pt.amp.auto_cast(level="O1", custom_white_list={"add"}):
        z = x + x
    assert _dt(z) == "bfloat16"


def test_autocast_o2_casts_all_but_the_black_list(pt):
    x = pt.to_tensor(_x(4, 8))
    with pt.amp.auto_cast(level="O2"):
        assert _dt(x * 2.0) == "bfloat16"
        assert _dt(pt.log(pt.abs(x) + 1.0)) == "float32"


def test_grad_scaler_dynamic():
    out = {}
    for name, pt in PKGS.items():
        m = _linear(pt, 8, 4)
        opt = pt.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = pt.amp.GradScaler(init_loss_scaling=1024.0,
                                   incr_every_n_steps=2)
        w0 = m.weight.numpy().copy()
        x = pt.to_tensor(_x(4, 8, seed=2))
        for _ in range(2):
            loss = m(x).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        assert not np.allclose(m.weight.numpy(), w0)
        assert scaler.get_loss_scaling() == 2048.0
        out[name] = m.weight.numpy()
    np.testing.assert_allclose(out["port"], out["ref"], rtol=1e-6,
                               atol=1e-7)


def test_grad_scaler_skips_on_inf(pt):
    m = _linear(pt, 4, 2)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0)
    w0 = m.weight.numpy().copy()
    x = pt.to_tensor(np.full((2, 4), 1e38, np.float32))
    loss = (m(x) * 1e38).mean()
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(m.weight.numpy(), w0)
    assert scaler.get_loss_scaling() < 8.0


def test_decorate_o2_casts_params(pt):
    m = _linear(pt, 8, 4)
    pt.amp.decorate(m, level="O2", dtype="bfloat16")
    assert _dt(m.weight) == "bfloat16"
    assert not m.weight.stop_gradient


def test_operator_stats_and_lists(pt, capsys):
    assert "matmul" in pt.amp.white_list()
    assert "exp" in pt.amp.black_list()
    pt.amp.debugging.enable_operator_stats_collection()
    x = pt.to_tensor(_x(2, 2))
    _ = x.matmul(x) + x
    pt.amp.debugging.disable_operator_stats_collection()
    out = capsys.readouterr().out
    assert "matmul: 1" in out and "add: 1" in out


def test_bfloat16_support_query():
    import torch

    cap = torch.cuda.get_device_capability() if torch.cuda.is_available() \
        else None
    assert paddle_tpu_torch.amp.is_bfloat16_supported() == (
        cap is not None and cap >= (8, 0))
