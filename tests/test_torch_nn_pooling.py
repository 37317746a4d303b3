"""The port's pooling and vision functionals and the pooling Layers
against the reference's, on the CPU.

Max and average pooling in 1-3 D: padding forms, ``ceil_mode`` (the
high pad extended by ``s - rem``; one shape where torch's own
``ceil_mode`` drops the last window and the reference's keeps it),
``exclusive`` True and False (False divides by prod(k) over the ceil
extension too), ``divisor_override``, channel-last layouts, integer max
pooling (exact), ``return_mask`` (the flat index into the unpadded
extent); adaptive average and max pooling with uniform and non-uniform
windows; ``grid_sample`` in every mode and padding mode with and
without aligned corners, and ``affine_grid``. Outputs and the gradients
of a seeded cotangent at fp32 rtol 1e-5 (and 1e-5 of the largest
magnitude); masks and integer outputs exactly.

Defect E (ROADMAP Queue 3): the reference's ``return_mask`` leaves the
ceil extension out, so where ``ceil_mode`` adds a window its mask has
fewer windows than its output; the port's mask covers every window of
the output and equals the reference's on the windows both have.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, hold, hold_fn, pair

X1 = _f(2, 3, 13, seed=1)
X2 = _f(2, 3, 9, 11, seed=2)
X3 = _f(1, 2, 5, 6, 7, seed=3)
X2C = _f(2, 3, 10, 12, seed=4)        # 10 + 2 - 3 = 9: ceil adds a window


def _cl(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_avg_pool(n, ceil_mode, exclusive):
    x = {1: X1, 2: X2C, 3: X3}[n]
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=ceil_mode,
              exclusive=exclusive)
    hold_fn(f"avg_pool{n}d", [x], kw)


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_pool(n, ceil_mode):
    x = {1: X1, 2: X2C, 3: X3}[n]
    hold_fn(f"max_pool{n}d", [x], dict(kernel_size=3, stride=2, padding=1,
                                       ceil_mode=ceil_mode))


@pytest.mark.parametrize("case", [
    dict(kernel_size=(3, 2), stride=(2, 1), padding=[1, 0, 0, 1]),
    dict(kernel_size=2, stride=None, padding=[[1, 1], [0, 1]]),
    dict(kernel_size=4, stride=3, padding=[2, 1], ceil_mode=True),
], ids=["asym", "pairs", "ceil-per-dim"])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_padding_forms(kind, case):
    hold_fn(f"{kind}_pool2d", [X2], case)


def test_avg_pool_divisor_override():
    hold_fn("avg_pool2d", [X2], dict(kernel_size=3, stride=2, padding=1,
                                     divisor_override=4))
    hold_fn("avg_pool3d", [X3], dict(kernel_size=2, stride=2, ceil_mode=True,
                                     exclusive=False, divisor_override=3))


def test_ceil_mode_where_torch_differs():
    """In 5, k 2, s 2, p 1: torch's ceil rule drops the last window (it
    starts in the padding), the reference's keeps it."""
    x = _f(1, 2, 5, 5, seed=5)
    for kind, extra in (("max", {}), ("avg", dict(exclusive=False))):
        out = hold_fn(f"{kind}_pool2d", [x],
                      dict(kernel_size=2, stride=2, padding=1,
                           ceil_mode=True, **extra))[0]
        assert out.shape == [1, 2, 4, 4]
    lib = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                                         ceil_mode=True)
    assert list(lib.shape) == [1, 2, 3, 3]


@pytest.mark.parametrize("n", [2, 3])
def test_pool_channel_last(n):
    x, fmt = (_cl(X2), "NHWC") if n == 2 else (_cl(X3), "NDHWC")
    for kind in ("max", "avg"):
        hold_fn(f"{kind}_pool{n}d", [x], dict(kernel_size=3, stride=2,
                                              padding=1, data_format=fmt))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_max_pool_integer(dtype):
    x = np.random.default_rng(6).integers(-100, 100, (2, 3, 9, 11)).astype(
        dtype)
    hold_fn("max_pool2d", [x], dict(kernel_size=3, stride=2, padding=1))


@pytest.mark.parametrize("case", [
    ("max_pool1d", X1, dict(kernel_size=4, stride=3, padding=1)),
    ("max_pool2d", X2, dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", _cl(X2), dict(kernel_size=3, stride=2, padding=[1, 0],
                                 data_format="NHWC")),
    ("max_pool3d", X3, dict(kernel_size=2, stride=2, padding=1)),
], ids=["1d", "2d", "nhwc", "3d"])
def test_max_pool_return_mask(case):
    name, x, kw = case
    out, mask = hold_fn(name, [x], dict(return_mask=True, **kw))
    assert mask.dtype == torch.int32 and out.shape == mask.shape


def test_return_mask_with_ceil_mode_defect_e():
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
              return_mask=True)
    r_out, r_mask = ref.nn.functional.max_pool2d(ref.to_tensor(X2C), **kw)
    p_out, p_mask = port.nn.functional.max_pool2d(port.to_tensor(X2C), **kw)
    # the reference: 6 x 7 windows pooled, 5 x 6 masked
    assert r_out.shape == [2, 3, 6, 7] and r_mask.shape == [2, 3, 5, 6]
    assert p_out.shape == p_mask.shape == [2, 3, 6, 7]
    np.testing.assert_array_equal(p_mask.numpy()[:, :, :5, :6],
                                  r_mask.numpy())
    # every index points at its window's maximum
    flat = X2C.reshape(2, 3, -1)
    picked = np.take_along_axis(flat, p_mask.numpy().reshape(2, 3, -1)
                                .astype(np.int64), axis=2)
    np.testing.assert_array_equal(picked.reshape(p_out.shape),
                                  p_out.numpy())


@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("size", [(3, 5), (1, 1), 7, (9, 11), (4, 4)],
                         ids=str)
def test_adaptive_pool2d(kind, size):
    hold_fn(f"adaptive_{kind}_pool2d", [X2], dict(output_size=size))


def test_adaptive_pool_1d_3d_channel_last():
    for kind in ("avg", "max"):
        hold_fn(f"adaptive_{kind}_pool1d", [X1], dict(output_size=5))
        hold_fn(f"adaptive_{kind}_pool3d", [X3],
                dict(output_size=(2, 4, 3)))
    hold_fn("adaptive_avg_pool2d", [_cl(X2)],
            dict(output_size=(4, 3), data_format="NHWC"))
    hold_fn("adaptive_avg_pool3d", [_cl(X3)],
            dict(output_size=(3, 3, 3), data_format="NDHWC"))


GRID = np.random.default_rng(7).uniform(-1.3, 1.3, (2, 4, 5, 2)).astype(
    np.float32)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(mode, padding_mode, align):
    hold_fn("grid_sample", [X2, GRID], dict(mode=mode,
                                            padding_mode=padding_mode,
                                            align_corners=align))


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid(align):
    theta = _f(2, 2, 3, seed=8)
    hold_fn("affine_grid", [theta, [2, 3, 4, 5]],
            dict(align_corners=align))


LAYERS = {
    "MaxPool1D": ((3, 2, 1), dict(return_mask=True), X1),
    "MaxPool2D": ((3, 2, 1), dict(ceil_mode=True), X2C),
    "MaxPool3D": ((2, 2), dict(), X3),
    "AvgPool1D": ((3, 2, 1), dict(exclusive=False), X1),
    "AvgPool2D": ((3, 2, 1), dict(ceil_mode=True, exclusive=False), X2C),
    "AvgPool3D": ((2, 2, 1), dict(divisor_override=5), X3),
    "AdaptiveAvgPool1D": ((5,), dict(), X1),
    "AdaptiveAvgPool2D": (((1, 1),), dict(), X2),
    "AdaptiveAvgPool3D": (((2, 3, 4),), dict(), X3),
    "AdaptiveMaxPool1D": ((4,), dict(), X1),
    "AdaptiveMaxPool2D": (((4, 5),), dict(), X2),
    "AdaptiveMaxPool3D": ((2,), dict(), X3),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_pool_layers(name):
    args, kw, x = LAYERS[name]
    rl, pl = pair(name, *args, **kw)
    hold(rl, pl, [x], what=name)
