"""The port's convolutions (``nn.functional.conv*``, ``nn.Conv*``)
against the reference's, on the CPU.

Every padding form of the reference's ``_padding_n`` (int, per-dim,
the 2n low/high list, pairs, "SAME" and "VALID"), each at stride 1 and
2 ("SAME" at stride 2 pads ``lax``'s way, low // 2 and the rest high,
which torch's own "same" refuses), both layouts, dilation and groups;
the transposed conv's padding forms with ``output_padding`` and
``output_size`` (asymmetric pairs, "SAME" as ``eff_k // 2``); conv1d and
conv3d and their transposes. The forward and the gradients of a seeded
cotangent with respect to x, the weight and the bias are held at fp32
rtol 1e-5 (and 1e-5 of the largest magnitude). The six Conv Layers
with the reference's state carried across, and their default
initialisers' shapes and bounds.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, hold, hold_fn, pair

X2 = _f(2, 4, 9, 11, seed=1)
W2 = _f(6, 2, 3, 3, seed=2)
B6 = _f(6, seed=3)
WT2 = _f(4, 3, 3, 3, seed=4)           # [in, out / groups, k, k], groups 2

PADDINGS = [0, 2, [1, 2], [1, 0, 2, 1], [[0, 1], [2, 0]], "SAME", "VALID",
            "same"]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", PADDINGS, ids=str)
def test_conv2d_padding_forms(padding, stride):
    hold_fn("conv2d", [X2, W2, B6], dict(stride=stride, padding=padding,
                                         groups=2))


@pytest.mark.parametrize("case", [
    dict(stride=2, padding="SAME", dilation=2),
    dict(stride=(2, 3), padding=[2, 1], dilation=(1, 2)),
    dict(stride=1, padding=[0, 1, 1, 0], dilation=3),
], ids=["same-dil2", "stride23", "asym-dil3"])
def test_conv2d_dilation(case):
    hold_fn("conv2d", [X2, W2, B6], dict(groups=2, **case))


@pytest.mark.parametrize("padding", ["SAME", [1, 0, 2, 1]], ids=str)
def test_conv2d_channel_last(padding):
    x = np.ascontiguousarray(X2.transpose(0, 2, 3, 1))
    hold_fn("conv2d", [x, W2, B6], dict(stride=2, padding=padding, groups=2,
                                        data_format="NHWC"))


def test_conv2d_depthwise_no_bias():
    w = _f(4, 1, 3, 3, seed=5)
    hold_fn("conv2d", [X2, w, None], dict(stride=2, padding=1, groups=4))


@pytest.mark.parametrize("fmt", ["NCL", "NLC"])
def test_conv1d(fmt):
    x = _f(2, 4, 13, seed=6)
    if fmt == "NLC":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    hold_fn("conv1d", [x, _f(5, 4, 4, seed=7), _f(5, seed=8)],
            dict(stride=3, padding="SAME", data_format=fmt))


@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_conv3d(fmt):
    x = _f(1, 2, 5, 6, 7, seed=9)
    if fmt == "NDHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 4, 1))
    hold_fn("conv3d", [x, _f(3, 2, 2, 3, 2, seed=10), _f(3, seed=11)],
            dict(stride=2, padding="SAME", data_format=fmt))


@pytest.mark.parametrize("output_padding", [0, 1])
@pytest.mark.parametrize("padding", [0, 1, [1, 2], [1, 0, 2, 1], "SAME",
                                     "VALID"], ids=str)
def test_conv2d_transpose_padding(padding, output_padding):
    hold_fn("conv2d_transpose", [X2, WT2, B6],
            dict(stride=2, padding=padding, output_padding=output_padding,
                 groups=2))


@pytest.mark.parametrize("case", [
    dict(stride=2, padding=1, output_size=[17, 20]),
    dict(stride=3, padding=[3, 0], dilation=2, output_padding=2),
    dict(stride=2, padding=[[2, 0], [0, 3]], output_padding=(1, 0)),
], ids=["output_size", "dilation", "pairs"])
def test_conv2d_transpose_cases(case):
    hold_fn("conv2d_transpose", [X2, WT2, B6], dict(groups=2, **case))


def test_conv_transpose_1d_3d_channel_last():
    x = np.ascontiguousarray(_f(2, 4, 7, seed=12).transpose(0, 2, 1))
    hold_fn("conv1d_transpose", [x, _f(4, 3, 3, seed=13), _f(3, seed=14)],
            dict(stride=2, padding="SAME", output_padding=1,
                 data_format="NLC"))
    hold_fn("conv3d_transpose",
            [_f(1, 2, 3, 4, 3, seed=15), _f(2, 3, 2, 3, 2, seed=16), None],
            dict(stride=2, padding=[1, 0, 0, 1, 1, 1]))


LAYERS = {
    "Conv1D": ((4, 6, 3), dict(stride=2, padding="SAME"), (2, 4, 10)),
    "Conv2D": ((4, 6, 3), dict(stride=2, padding=1, groups=2), (2, 4, 9, 9)),
    "Conv2D-nobias": ((4, 6, (3, 1)), dict(bias_attr=False, dilation=2),
                      (2, 4, 9, 9)),
    "Conv3D": ((2, 4, 2), dict(padding=[1, 0, 1]), (1, 2, 4, 5, 4)),
    "Conv1DTranspose": ((4, 6, 3), dict(stride=2, output_padding=1),
                        (2, 4, 6)),
    "Conv2DTranspose": ((4, 6, 3), dict(stride=2, padding="SAME",
                                        groups=2), (2, 4, 5, 6)),
    "Conv3DTranspose": ((2, 4, 2), dict(stride=2), (1, 2, 3, 3, 2)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layers(name):
    args, kw, shape = LAYERS[name]
    rl, pl = pair(name.split("-")[0], *args, **kw)
    hold(rl, pl, [_f(*shape, seed=17)], what=name)


def test_conv_default_initialisers():
    """KaimingUniform weight over fan_in = in / groups * prod(k) and a
    Uniform(+-1/sqrt(fan_in)) bias, in the reference's layouts."""
    port.seed(0)
    conv = port.nn.Conv2D(8, 16, 3, groups=2)
    convt = port.nn.Conv2DTranspose(8, 16, 3, groups=2)
    fan_in = 4 * 9
    for layer, shape in ((conv, [16, 4, 3, 3]), (convt, [8, 8, 3, 3])):
        w, b = layer.weight.numpy(), layer.bias.numpy()
        assert list(w.shape) == shape and list(b.shape) == [16]
        assert np.abs(w).max() <= np.sqrt(6.0 / fan_in) + 1e-7
        assert np.abs(b).max() <= 1 / np.sqrt(fan_in) + 1e-7
        assert w.std() > 0.2 * np.sqrt(6.0 / fan_in)
    r = ref.nn.Conv2D(8, 16, 3, groups=2)
    assert list(r.state_dict()) == list(conv.state_dict())
