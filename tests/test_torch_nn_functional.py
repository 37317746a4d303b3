"""Every op of the port's nn/functional activation, common, input and
norm modules against the reference's (``torch_nn_common.check_op``: the
reference's contract cases and cases written there, forward within rtol
1e-6, vjp within rtol 1e-5); the loss module's ops are
``tests/test_torch_nn_loss.py``'s. The names, ``differentiable`` flags
and AMP policies of all five modules' ops equal the reference's
registrations, and each module's ``__all__`` the reference's.

The random functionals draw from the port's generator, so they are held
by their statistics: dropout's kept share and scaling (``axis=``, both
modes), the feature and alpha dropouts' masks and moments, rrelu's
slopes, gumbel-softmax's rows, class-center sampling's contract.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dispatch import OpDef as RefOpDef
from paddle_tpu_torch.core.dispatch import OpDef as PortOpDef

from test_torch_ops import _assert_same, _np, _opdef
from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_common import (FWD_RTOL, MODULES, PORT_OPS, RANDOM, REF_OPS,
                             _f, _i, cases, check_op, same_fn)


def test_names_and_policies_are_the_references():
    assert set(PORT_OPS) == set(REF_OPS)
    assert len(REF_OPS) == 76
    for name in REF_OPS:
        r = _opdef(REF_OPS[name], RefOpDef)
        p = _opdef(PORT_OPS[name], PortOpDef)
        assert (p.name, p.differentiable, p.amp_policy) == (
            r.name, r.differentiable, r.amp_policy), name
    for m in MODULES:
        assert set(getattr(port.nn.functional, m).__all__) == set(
            getattr(ref.nn.functional, m).__all__), m


def test_every_op_has_a_case():
    covered = {n for n, _ in cases(MODULES)} | RANDOM
    assert covered == set(REF_OPS)


@pytest.mark.parametrize("name,i", cases(("activation", "common", "input",
                                          "norm")))
def test_op_against_reference(name, i):
    check_op(name, i)


# -- functions that are not a single op --------------------------------------

def test_inplace_variants():
    for name in ("relu_", "softmax_"):
        x = _f(3, 4)
        r = getattr(ref.nn.functional, name)(ref.to_tensor(x))
        p = getattr(port.nn.functional, name)(port.to_tensor(x))
        _assert_same(_np(p), _np(r), FWD_RTOL, name)


def test_eval_paths_of_the_random_functionals():
    x = _f(3, 4)
    same_fn("rrelu", [x], {"training": False})
    for name in ("dropout", "dropout2d", "dropout3d", "alpha_dropout"):
        kw = {"training": False}
        same_fn(name, [_f(2, 3, 4, 5, 6) if name == "dropout3d"
                        else _f(2, 3, 4, 5)], kw)
    same_fn("dropout", [x], {"training": False,
                              "mode": "downscale_in_infer", "p": 0.3})
    same_fn("dropout", [x], {"p": 1.0})


def test_embedding_renorm_against_reference():
    w = _f(6, 4) * 3
    idx = _i(0, 2, 2, 5)
    r = ref.nn.functional.embedding_renorm_(ref.to_tensor(w),
                                            ref.to_tensor(idx), 1.5)
    p = port.nn.functional.embedding_renorm_(port.to_tensor(w),
                                             port.to_tensor(idx), 1.5)
    _assert_same(_np(p), _np(r), FWD_RTOL, "embedding_renorm_")


N = 200_000


@pytest.mark.parametrize("p,mode", [(0.1, "upscale_in_train"),
                                    (0.3, "downscale_in_infer")])
def test_dropout_statistics(p, mode):
    port.seed(3)
    x = port.ones([N])
    y = port.nn.functional.dropout(x, p, mode=mode).numpy()
    kept = y != 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[kept], scale, rtol=1e-6)
    # the gradient is the mask, scaled
    xg = port.to_tensor(np.ones(N, np.float32), stop_gradient=False)
    port.seed(3)
    (g,) = port.grad([port.nn.functional.dropout(xg, p, mode=mode).sum()],
                     [xg])
    np.testing.assert_array_equal(g.numpy(), y)


def test_dropout_axis_masks_whole_slices():
    port.seed(4)
    y = port.nn.functional.dropout(port.ones([4000, 8]), 0.25,
                                   axis=0).numpy()
    rows = (y != 0).all(1) | (y == 0).all(1)
    assert rows.all()
    assert abs((y[:, 0] != 0).mean() - 0.75) < 0.03
    y2 = port.nn.functional.dropout(port.ones([6, 5, 3000]), 0.5,
                                    axis=[0, 2]).numpy()
    assert ((y2 != 0) == (y2[:, :1] != 0)).all()


def test_feature_and_alpha_dropout_statistics():
    port.seed(5)
    y = port.nn.functional.dropout2d(port.ones([500, 16, 3, 3]),
                                     0.4).numpy()
    ch = y.reshape(500, 16, 9)
    assert ((ch == ch[..., :1]).all())
    assert abs((ch[..., 0] != 0).mean() - 0.6) < 0.02
    y = port.nn.functional.dropout3d(port.ones([200, 3, 2, 2, 8]), 0.5,
                                     data_format="NDHWC").numpy()
    assert (y == y[:, :1, :1, :1, :]).all()
    x = port.randn([N])
    a = port.nn.functional.alpha_dropout(x, 0.2).numpy()
    # alpha dropout keeps a standard normal's mean and variance
    assert abs(a.mean()) < 0.02 and abs(a.std() - 1.0) < 0.02


def test_rrelu_and_gumbel_softmax_statistics():
    port.seed(6)
    x = -port.ones([N])
    slope = -port.nn.functional.rrelu(x, 0.1, 0.3).numpy()
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert abs(slope.mean() - 0.2) < 0.002
    logits = port.to_tensor(np.log(np.array([[0.1, 0.2, 0.7]] * 20000,
                                            np.float32)))
    y = port.nn.functional.gumbel_softmax(logits, temperature=0.5).numpy()
    np.testing.assert_allclose(y.sum(1), 1.0, rtol=1e-5)
    h = port.nn.functional.gumbel_softmax(logits, hard=True).numpy()
    assert set(np.unique(h)) <= {0.0, 1.0} and (h.sum(1) == 1).all()
    # hard samples follow softmax(logits)
    np.testing.assert_allclose(h.mean(0), [0.1, 0.2, 0.7], atol=0.015)


def test_class_center_sample_contract():
    port.seed(7)
    label = port.to_tensor(np.array([3, 7, 7, 12, 3, 0], np.int64))
    remapped, sampled = port.nn.functional.class_center_sample(label, 16, 6)
    s = sampled.numpy()
    r = remapped.numpy()
    assert len(s) == 6 and (np.diff(s) > 0).all()
    assert {0, 3, 7, 12} <= set(s.tolist())
    np.testing.assert_array_equal(s[r], label.numpy())
    with pytest.raises(ValueError):
        port.nn.functional.class_center_sample(label, 16, 3)
    # two model-parallel shards of 8 classes: every rank remaps against
    # both ranks' samples, which each reproduces from the shared seed
    outs = []
    for rank in (0, 1):
        port.seed(8)
        grp = type("G", (), {"rank": rank, "nranks": 2})()
        outs.append(port.nn.functional.class_center_sample(label, 8, 4,
                                                           group=grp))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    every = np.concatenate([outs[0][1].numpy(), outs[1][1].numpy()])
    np.testing.assert_array_equal(every[outs[0][0].numpy()], label.numpy())
