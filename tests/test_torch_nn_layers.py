"""Every Layer class of the port's nn/layer activation, common,
container and loss modules against the reference's, on the CPU.

Each case builds the reference's layer and the port's with the same
arguments and carries the reference's state across with
``layer_state_from_jax``; the structured ``state_dict`` names must be
the reference's. The forward (the random layers in eval: their draws
are held by the functional tests' statistics) and the gradients of a
seeded cotangent with respect to every float input and parameter are
held at fp32 rtol 1e-5 (and 1e-5 of the tensor's largest magnitude);
the containers' bookkeeping equals the reference's. The norm layers and
``nn.utils`` are ``tests/test_torch_nn_norm.py``'s, the transformer
module ``tests/test_torch_nn_transformer.py``'s.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, _i, hold, pair

X = lambda: _f(2, 4, 6)  # noqa: E731

# name -> (constructor args, constructor kwargs, inputs, train)
ACTIVATION = {
    "CELU": ((), {"alpha": 0.7}, [X()]),
    "ELU": ((), {"alpha": 0.8}, [X()]),
    "GELU": ((True,), {}, [X()]),
    "GLU": ((), {"axis": -1}, [X()]),
    "Hardshrink": ((), {"threshold": 0.4}, [X()]),
    "Hardsigmoid": ((), {}, [X() * 4]),
    "Hardswish": ((), {}, [X() * 4]),
    "Hardtanh": ((), {"min": -0.5, "max": 0.8}, [X()]),
    "LeakyReLU": ((0.2,), {}, [X()]),
    "LogSigmoid": ((), {}, [X()]),
    "LogSoftmax": ((1,), {}, [X()]),
    "Maxout": ((2,), {}, [X()]),
    "Mish": ((), {}, [X()]),
    "PReLU": ((4, 0.3), {}, [X()]),
    "ReLU": ((), {}, [X()]),
    "ReLU6": ((), {}, [X() * 5]),
    "RReLU": ((0.1, 0.3), {}, [X()]),
    "SELU": ((), {}, [X()]),
    "Sigmoid": ((), {}, [X()]),
    "Silu": ((), {}, [X()]),
    "Softmax": ((), {}, [X()]),
    "Softplus": ((2.0, 5.0), {}, [X() * 4]),
    "Softshrink": ((), {"threshold": 0.3}, [X()]),
    "Softsign": ((), {}, [X()]),
    "Swish": ((), {}, [X()]),
    "Tanh": ((), {}, [X()]),
    "Tanhshrink": ((), {}, [X()]),
    "ThresholdedReLU": ((), {"threshold": 0.5, "value": -0.1}, [X()]),
}

IMG = lambda: _f(1, 2, 3, 4)  # noqa: E731
COMMON = {
    "Linear": ((6, 5), {}, [X()]),
    "LinearCompat": ((6, 3), {"bias_attr": False}, [X()]),
    "Identity": ((), {}, [X()]),
    "Embedding": ((10, 4), {"padding_idx": -9},
                  [_i(0, 1, 9, 1, 3, 2, shape=(2, 3))]),
    "Dropout": ((0.3,), {}, [X()]),
    "Dropout2D": ((0.3,), {}, [IMG()]),
    "Dropout3D": ((0.3,), {}, [_f(1, 2, 2, 2, 3)]),
    "AlphaDropout": ((0.3,), {}, [X()]),
    "Flatten": ((), {}, [_f(2, 3, 2, 2)]),
    "Upsample": ((), {"size": [6, 7], "mode": "bilinear"}, [IMG()]),
    "UpsamplingBilinear2D": ((), {"scale_factor": 2}, [IMG()]),
    "UpsamplingNearest2D": ((), {"size": [5, 9]}, [IMG()]),
    "Pad1D": (([1, 2],), {"mode": "reflect"}, [_f(2, 3, 5)]),
    "Pad2D": (([1, 0, 2, 1],), {"mode": "replicate"}, [IMG()]),
    "Pad3D": (([1, 1, 0, 1, 1, 0],), {"value": 0.5}, [_f(1, 2, 3, 3, 3)]),
    "ZeroPad2D": (([1, 1, 0, 2],), {}, [IMG()]),
    "CosineSimilarity": ((), {"axis": 1}, [_f(3, 4), _f(3, 4, seed=1)]),
    "Bilinear": ((4, 5, 3), {}, [_f(2, 4), _f(2, 5, seed=1)]),
    "PixelShuffle": ((2,), {}, [_f(1, 8, 2, 3)]),
    "PixelUnshuffle": ((2,), {}, [_f(1, 2, 4, 6)]),
    "ChannelShuffle": ((2,), {}, [_f(1, 6, 2, 2)]),
    "Unfold": ((2,), {"paddings": 1}, [_f(1, 2, 4, 4)]),
    "Fold": (([4, 4], 2), {"strides": 2}, [_f(1, 8, 4)]),
}

P = lambda: _f(3, 4, lo=0.05, hi=0.95)  # noqa: E731
LABELS = lambda: _i(0, 3, -100)  # noqa: E731
LOSS = {
    "CrossEntropyLoss": ((), {"weight": lambda pkg: pkg.to_tensor(
        _f(4, lo=0.5, hi=2.0))}, [_f(3, 4), LABELS()]),
    "MSELoss": ((), {}, [_f(3, 4), _f(3, 4, seed=1)]),
    "L1Loss": ((), {"reduction": "sum"}, [_f(3, 4), _f(3, 4, seed=1)]),
    "NLLLoss": ((), {}, [_f(3, 4), LABELS()]),
    "BCELoss": ((), {}, [P(), _f(3, 4, seed=1, lo=0.0, hi=1.0)]),
    "BCEWithLogitsLoss": ((), {"pos_weight": lambda pkg: pkg.to_tensor(
        _f(4, lo=0.5, hi=2.0))}, [_f(3, 4), _f(3, 4, seed=1, lo=0, hi=1)]),
    "KLDivLoss": ((), {"reduction": "batchmean"},
                  [_f(3, 4), _f(3, 4, seed=1, lo=0.1, hi=1.0)]),
    "SmoothL1Loss": ((), {"delta": 0.5}, [_f(3, 4), _f(3, 4, seed=1)]),
    "MarginRankingLoss": ((0.1,), {}, [_f(3), _f(3, seed=1),
                                      np.float32([1, -1, 1])]),
    "CTCLoss": ((), {}, [_f(6, 2, 4), _i(1, 2, 3, 2, 1, 0, shape=(2, 3)),
                         _i(6, 5), _i(3, 2)]),
    "HingeEmbeddingLoss": ((), {}, [_f(3, 4),
                                    np.float32([[1, -1, 1, -1]] * 3)]),
    "CosineEmbeddingLoss": ((), {"margin": 0.1},
                            [_f(3, 4), _f(3, 4, seed=1), _i(1, -1, 1)]),
    "TripletMarginLoss": ((), {}, [_f(3, 4), _f(3, 4, seed=1),
                                   _f(3, 4, seed=2)]),
    "TripletMarginWithDistanceLoss": ((), {"swap": True},
                                      [_f(3, 4), _f(3, 4, seed=1),
                                       _f(3, 4, seed=2)]),
    "SoftMarginLoss": ((), {}, [_f(3, 4), np.float32([[1, -1, 1, -1]] * 3)]),
    "MultiLabelSoftMarginLoss": ((), {}, [_f(3, 4),
                                          _f(3, 4, seed=1, lo=0, hi=1)]),
    "PoissonNLLLoss": ((), {}, [_f(3, 4), _f(3, 4, seed=1, lo=0, hi=3)]),
    "GaussianNLLLoss": ((), {}, [_f(3, 4), _f(3, 4, seed=1),
                                 _f(3, 4, seed=2, lo=0.5, hi=2.0)]),
    "SigmoidFocalLoss": ((), {}, [_f(3, 4), np.float32([[1, 0, 0, 1]] * 3)]),
}

TABLES = {"activation": ACTIVATION, "common": COMMON, "loss": LOSS}


def test_every_layer_class_has_a_case():
    for mod, table in TABLES.items():
        names = set(getattr(ref.nn.layer, mod).__all__)
        assert set(getattr(port.nn.layer, mod).__all__) == names, mod
        assert set(table) == names, mod
    assert set(port.nn.layer.container.__all__) == set(
        ref.nn.layer.container.__all__)


@pytest.mark.parametrize("mod,name", [(m, n) for m, t in TABLES.items()
                                      for n in sorted(t)])
def test_layer_against_reference(mod, name):
    args, kwargs, inputs = TABLES[mod][name]
    rl, pl = pair(name, *args, **kwargs)
    hold(rl, pl, inputs, train=False, what=name)


def test_containers():
    def build(pkg):
        from collections import OrderedDict

        seq = pkg.nn.Sequential(pkg.nn.Linear(6, 5), pkg.nn.ReLU(),
                                pkg.nn.Linear(5, 2))
        named = pkg.nn.Sequential(OrderedDict([("a", pkg.nn.Linear(6, 3)),
                                               ("b", pkg.nn.Tanh())]))
        lst = pkg.nn.LayerList([pkg.nn.Linear(2, 2) for _ in range(3)])
        lst.append(pkg.nn.Linear(2, 4))
        lst.insert(1, pkg.nn.ReLU())
        del lst[0]
        dct = pkg.nn.LayerDict({"x": pkg.nn.Linear(2, 2)})
        dct["y"] = pkg.nn.Linear(2, 3)
        dct.pop("x")
        top = pkg.nn.Layer()
        top.seq, top.named, top.lst, top.dct = seq, named, lst, dct
        return top

    rt, pt = build(ref), build(port)
    assert list(pt.state_dict()) == list(rt.state_dict())
    pt.set_state_dict(layer_state_from_jax(rt.state_dict(), "cpu"))
    assert [type(m).__name__ for m in pt.lst] == \
        [type(m).__name__ for m in rt.lst]
    assert list(pt.dct.keys()) == list(rt.dct.keys()) == ["y"]
    assert len(pt.seq[1:]) == len(rt.seq[1:]) == 2
    assert isinstance(pt.named["a"], port.nn.Linear)
    hold(rt.seq, pt.seq, [_f(3, 6)], what="Sequential")
    hold(rt.named, pt.named, [_f(3, 6)], what="Sequential (named)")


def test_parameter_list():
    ps = [port.Parameter(_f(2, 2)), port.Parameter(_f(3))]
    pl = port.nn.ParameterList(ps)
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    pl.append(port.Parameter(_f(1)))
    assert len(pl) == 3 and pl[-1] is list(pl)[2]
