"""The port's ResNet family (``vision.models``) against the reference's,
on the CPU.

``resnet50()``'s ``state_dict()`` has the reference's 267 names (161
parameters, 106 BatchNorm buffers), shapes and order, and 25,557,032
parameters; so do ``wide_resnet50_2()`` and ``resnext50_32x4d()``'s
(the reference's are built under a constant global initializer: names
and shapes do not depend on the draws). ``pretrained=<path>`` loads a
reference-format pickle.
``resnet18(num_classes=10)`` at B 2, 3 x 64 x 64, in training mode
(batch statistics), the reference's weights and buffers carried across:
the logits within 2e-5 of their largest magnitude and the loss at rtol
1e-5, every parameter's gradient within 2e-4 of its largest magnitude;
two Momentum steps (lr 0.1, momentum 0.9, weight decay 1e-4) with
their losses at rtol 1e-4 and every parameter and BatchNorm buffer
after them within 1e-4 of its largest magnitude; one AMP O1 bf16
step's loss at rtol 2e-3 (conv in bf16, batch_norm in fp32 in both
packages). Each bound is a few times the error measured. At 32 x 32
layer4's BatchNorm normalises over 2 values a channel (1 x 1 x B 2),
which nearly cancel: both packages' logits are then fp32 rounding
apart by up to 17%, so the images are 64 x 64 (8 values a channel).
The reference resnet18 is built once for the file.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.utils.convert import (layer_state_from_jax,
                                            optimizer_state_from_jax)

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)

port.set_device("cpu")
B, C, HW = 2, 10, 64
LOGIT_TOL = 2e-5     # measured 5.2e-6 (scaled)
GRAD_TOL = 2e-4      # measured 4.0e-5 (scaled, the worst parameter)
STEP_TOL = 1e-4      # measured 3.1e-5 (a BatchNorm variance, scaled)
AMP_RTOL = 2e-3      # measured 2.2e-4


def _close(a, b, rtol, what, scaled=True):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = rtol * float(np.max(np.abs(b))) if scaled and b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def ref18():
    ref.seed(0)
    return rmodels.resnet18(num_classes=C)


def _port18(ref_model):
    m = port.vision.models.resnet18(num_classes=C)
    m.set_state_dict(layer_state_from_jax(ref_model.state_dict(), "cpu"))
    return m


def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, 3, HW, HW)).astype(np.float32),
            np.array([3, 7], np.int64))


def _loss(pkg, model, x, y, amp=False):
    xt, yt = pkg.to_tensor(x), pkg.to_tensor(y)
    if amp:
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(xt)
            return logits, pkg.nn.functional.cross_entropy(logits, yt)
    logits = model(xt)
    return logits, pkg.nn.functional.cross_entropy(logits, yt)


@pytest.mark.parametrize("name", ["resnet50", "wide_resnet50_2",
                                  "resnext50_32x4d"])
def test_resnet50_state_dict_matches_reference(name):
    init = ref.nn.initializer
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    try:
        r = getattr(rmodels, name)()
    finally:
        init.set_global_initializer(None, None)
    p = getattr(port.vision.models, name)()
    rs, ps = r.state_dict(), p.state_dict()
    assert len(ps) == 267 and list(ps) == list(rs)
    for k in rs:
        assert list(ps[k].shape) == list(rs[k].shape), k
    params = list(p.parameters())
    assert len(params) == 161
    if name == "resnet50":
        assert sum(q.size for q in params) == 25_557_032


def test_constructors():
    """All nine constructors exist; ``pretrained=True`` raises as the
    reference's does (no weights are bundled)."""
    for name in rmodels.resnet.__all__:
        assert callable(getattr(port.vision.models, name)), name
    with pytest.raises(NotImplementedError):
        port.vision.models.resnet18(pretrained=True)


def test_pretrained_path_loads_reference_weights(ref18, tmp_path):
    """``pretrained=<path>``: a reference-format ``.pdparams`` pickle of
    name -> array, loaded through ``hapi.weights.load_weights``."""
    import pickle

    path = tmp_path / "r18.pdparams"
    state = {k: v.numpy() for k, v in ref18.state_dict().items()}
    path.write_bytes(pickle.dumps(state))
    m = port.vision.models.resnet18(pretrained=str(path), num_classes=C)
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])


def test_resnet18_train_steps(ref18):
    """The first step's logits, loss and gradients, then two Momentum
    steps: losses, parameters and BatchNorm buffers."""
    pm = _port18(ref18)
    x, y = _batch()
    kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    r_opt = ref.optimizer.Momentum(parameters=ref18.parameters(), **kw)
    p_opt = port.optimizer.Momentum(parameters=pm.parameters(), **kw)
    for step in range(2):
        r_logits, r_loss = _loss(ref, ref18, x, y)
        p_logits, p_loss = _loss(port, pm, x, y)
        _close(p_loss.numpy(), r_loss.numpy(), 1e-5 if step == 0 else
               STEP_TOL, f"loss {step}", scaled=False)
        r_loss.backward()
        p_loss.backward()
        if step == 0:
            _close(p_logits.numpy(), r_logits.numpy(), LOGIT_TOL, "logits")
            for (n, rq), pq in zip(ref18.named_parameters(),
                                   pm.parameters()):
                _close(pq.grad.numpy(), rq.grad.numpy(), GRAD_TOL,
                       f"grad of {n}")
        for opt in (r_opt, p_opt):
            opt.step()
            opt.clear_grad()
    rs, ps = ref18.state_dict(), pm.state_dict()
    for k in rs:
        _close(ps[k].numpy(), rs[k].numpy(), STEP_TOL, f"{k} after 2 steps")
    # the velocities carry across by parameter position
    state = optimizer_state_from_jax(r_opt.state_dict(), p_opt,
                                     names=r_opt._parameter_names)
    assert len(state["state"]) == 62


def test_resnet18_amp_o1_step(ref18):
    pm = _port18(ref18)
    x, y = _batch()
    losses = []
    for pkg, model in ((ref, ref18), (port, pm)):
        logits, loss = _loss(pkg, model, x, y, amp=True)
        assert str(logits.dtype).endswith("bfloat16")
        loss.backward()
        grads = [q.grad for q in model.parameters()]
        assert all(g is not None for g in grads)
        losses.append(float(loss.numpy()))
        model.clear_gradients()
    _close(losses[1], losses[0], AMP_RTOL, "AMP O1 loss", scaled=False)
