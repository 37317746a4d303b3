"""BERT pretraining (``models/bert.py``) in the port against the
reference's, on the CPU.

``BertForPretraining`` at vocab 128, hidden 128, 2 layers, 2 heads of
64, ff 256, S 128, B 2, dropouts 0 (the attention's flash route: the op
``pallas_flash_attention`` twice a forward in both packages, K1-sep /
K3-sep's plain versions in the port, the reference's Pallas kernels in
interpret mode), the reference's weights carried across by
``layer_state_from_jax``; MLM labels -100 except on 15% of positions.
The user's loop (AdamW, lr 1e-4, weight decay 0.01): the first step's
MLM and NSP logits within rtol 1e-5 and every parameter's gradient
within rtol 1e-5 (1e-5 of the largest magnitude; the tied word
embedding takes both its uses; the key biases' gradients, 0 in exact
arithmetic, within 1e-5 of the largest gradient on both sides), three
steps' losses within rtol 1e-5 and the parameters after them within atol
1e-5 (the key biases, moved by AdamW on rounding noise alone, within 2
lr a step of their start on both sides); under AMP O1 bf16 the
three losses within rtol 1e-3 (the packages' bf16 matmuls sum in other
orders); in eval at the default dropouts (0.1) the logits within rtol
1e-5. The reference model is built and run once for the module.

Defect D (ROADMAP Queue 3): the reference's deep-copied encoder layers
keep their parameters' names, so its optimizer's state dict holds 30
entries for 46 parameters and ``set_state_dict`` loads one copy's
moments into every copy; the port's names are its own, and
``optimizer_state_from_jax`` refuses the reference's state rather than
pair it by position.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.models import bert as jb
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.utils.convert import (layer_state_from_jax,
                                            optimizer_state_from_jax)

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)

port.set_device("cpu")
SMALL = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 2, 128
STEPS = 3


def _close(a, b, rtol, what, scaled=True):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = rtol * float(np.max(np.abs(b))) if scaled and b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (B, S))
    tt = (np.arange(S)[None, :] >= rng.randint(S // 4, S, (B, 1))).astype(
        np.int64)
    mlm = rng.randint(0, SMALL["vocab_size"], (B, S))
    mlm[rng.rand(B, S) >= 0.15] = -100
    nsp = rng.randint(0, 2, (B,))
    return ids, tt, mlm, nsp


def _train(pkg, model, amp=False):
    """The user's loop; returns the losses, the first step's logits and
    gradients, the funnel's attention ops of the first step, and the
    optimizer."""
    cfg = model.bert.config
    crit = (jb if pkg is ref else tb).BertPretrainingCriterion(
        cfg.vocab_size)
    opt = pkg.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
    ids, tt, mlm, nsp = (pkg.to_tensor(a) for a in _batch())
    losses, first = [], None
    for step in range(STEPS):
        seen = []
        pkg.core.dispatch.DISPATCH_HOOKS.append(seen.append)
        try:
            if amp:
                with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
                    logits = model(ids, tt)
                    loss = crit(*logits, mlm, nsp)
            else:
                logits = model(ids, tt)
                loss = crit(*logits, mlm, nsp)
        finally:
            pkg.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
        loss.backward()
        if step == 0:
            first = ([t.numpy() for t in logits],
                     [p.grad.numpy() for p in model.parameters()],
                     [s for s in seen if "attention" in s])
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, first, opt


def _eval_logits(pkg, model):
    model.eval()
    ids, tt, _, _ = (pkg.to_tensor(a) for a in _batch())
    return [t.numpy() for t in model(ids, tt)]


def _port_model(state, **cfg_kw):
    m = tb.BertForPretraining(tb.BertConfig(**{**SMALL, **cfg_kw}))
    m.set_state_dict(layer_state_from_jax(state, "cpu"))
    return m


@pytest.fixture(scope="module")
def reference():
    """The reference's runs on one model, once: eval (at any dropout
    rate the same function: ``Dropout`` and the attention's
    ``dropout_p`` are off in eval), fp32 (logits, gradients, 3 steps),
    then from the same initial state bf16 AMP (3 steps)."""
    rm = jb.BertForPretraining(jb.BertConfig(**SMALL))
    state = {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()}
    names = [(n, tuple(p.shape)) for n, p in rm.named_parameters()]
    evl = _eval_logits(ref, rm)
    rm.train()
    fp32 = _train(ref, rm)
    final = [p.numpy() for p in rm.parameters()]
    rm.set_state_dict({k: ref.to_tensor(v) for k, v in state.items()})
    amp_losses = _train(ref, rm, amp=True)[0]
    return dict(state=state, names=names, fp32=fp32, final=final,
                amp=amp_losses, eval=evl)


def test_parameter_names_and_order(reference):
    pm = _port_model(reference["state"])
    pn = [(n, tuple(p.shape)) for n, p in pm.named_parameters()]
    assert pn == reference["names"] and len(pn) == 46
    assert pn[0][0] == "decoder_bias"
    assert list(pm.state_dict()) == list(reference["state"])
    # the port's deep-copied layer has parameter names of its own
    assert len({p.name for p in pm.parameters()}) == 46


def test_three_adamw_steps_fp32(reference):
    pm = _port_model(reference["state"])
    losses, (logits, grads, seen), _ = _train(port, pm)
    rlosses, (rlogits, rgrads, rseen), _ = reference["fp32"]
    assert seen == rseen == ["pallas_flash_attention"] * 2
    for name, a, b in zip(("mlm", "nsp"), logits, rlogits):
        _close(a, b, 1e-5, f"{name} logits")
    top = max(float(np.max(np.abs(g))) for g in rgrads)
    for (n, _), a, b in zip(reference["names"], grads, rgrads):
        if n.endswith("k_proj.bias"):
            # 0 in exact arithmetic (the softmax over keys ignores a
            # shift common to every key): rounding noise on both sides,
            # held to within 1e-5 of the largest gradient
            assert max(np.abs(a).max(), np.abs(b).max()) <= 1e-5 * top, n
        else:
            _close(a, b, 1e-5, f"grad {n}")
    _close(losses, rlosses, 1e-5, "losses", scaled=False)
    assert losses[-1] < losses[0]
    for (n, _), p, r in zip(reference["names"], pm.parameters(),
                            reference["final"]):
        if n.endswith("k_proj.bias"):
            # AdamW moves an element by ~lr a step whatever the rounding
            # of its gradient; here the gradient is all rounding, so each
            # side is held to stay within 2 lr a step of its start
            start = reference["state"][n]
            for side in (p.numpy(), r):
                assert np.abs(side - start).max() <= 2e-4 * STEPS, n
        else:
            np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=1e-5,
                                       err_msg=n)


def test_three_adamw_steps_amp_bf16(reference):
    pm = _port_model(reference["state"])
    losses = _train(port, pm, amp=True)[0]
    _close(losses, reference["amp"], 1e-3, "bf16 losses", scaled=False)
    assert losses[-1] < losses[0]


def test_eval_at_the_default_dropouts(reference):
    pm = _port_model(reference["state"], hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    seen = []
    port.core.dispatch.DISPATCH_HOOKS.append(seen.append)
    try:
        logits = _eval_logits(port, pm)
    finally:
        port.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
    assert seen.count("pallas_flash_attention") == 2
    assert "dropout_impl" not in seen
    for name, a, b in zip(("mlm", "nsp"), logits, reference["eval"]):
        _close(a, b, 1e-5, f"eval {name} logits")


def test_training_attention_dropout_takes_the_plain_route():
    """At the default attention dropout (0.1) training passes
    ``dropout_p=0.1`` to SDPA: the plain expression, no flash op."""
    m = tb.BertForPretraining(tb.BertConfig(**{
        **SMALL, "attention_probs_dropout_prob": 0.1}))
    ids, tt, _, _ = (port.to_tensor(a) for a in _batch())
    seen = []
    port.core.dispatch.DISPATCH_HOOKS.append(seen.append)
    try:
        m(ids, tt)
    finally:
        port.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
    assert seen.count("scaled_dot_product_attention") == 2
    assert "pallas_flash_attention" not in seen


def test_defect_d_and_the_converter_refusal(reference):
    _, _, ropt = reference["fp32"]
    rsd = ropt.state_dict()
    names = list(ropt._parameter_names)
    assert len(names) == 46 and len(set(names)) == 30
    assert len(rsd["state"]) == 30
    # the reference's set_state_dict gives every copy one copy's moments,
    # where the optimizer that wrote them held each its own
    order = [n for n, _ in reference["names"]]
    i0, i1 = (order.index(f"bert.encoder.layers.{j}.linear1.weight")
              for j in (0, 1))
    params = ropt._parameter_list
    ropt2 = ref.optimizer.AdamW(learning_rate=1e-4, parameters=params)
    ropt2.set_state_dict(rsd)

    def moment(opt, i):
        return np.asarray(opt._accumulators[id(params[i])]["moment1"])

    assert not np.array_equal(moment(ropt, i0), moment(ropt, i1))
    np.testing.assert_array_equal(moment(ropt2, i0), moment(ropt2, i1))
    # the port refuses both pairings
    pm = _port_model(reference["state"])
    popt = port.optimizer.AdamW(learning_rate=1e-4,
                                parameters=pm.parameters())
    with pytest.raises(ValueError, match="more than once"):
        optimizer_state_from_jax(rsd, popt, names=names)
    with pytest.raises(ValueError, match="30 reference parameter states "
                                         "for 46 parameters"):
        optimizer_state_from_jax(rsd, popt)
    # after a step the port's state has one entry a parameter
    for p in pm.parameters():
        p.grad = np.ones(p.shape, np.float32)
    popt.step()
    assert len(popt.state_dict()["state"]) == 46


def test_converter_pairs_by_name():
    """With the reference's names the entries go to their parameters
    whatever order the state dict lists them in."""
    rps = ref.nn.Linear(3, 4).parameters() + ref.nn.Linear(4, 2).parameters()
    ropt = ref.optimizer.AdamW(learning_rate=1e-2, parameters=rps)
    (sum((p * p).sum() for p in rps)).backward()
    ropt.step()
    sd = ropt.state_dict()
    sd["state"] = dict(reversed(list(sd["state"].items())))
    pps = [port.Parameter(p.numpy(), name=f"w{i}")
           for i, p in enumerate(rps)]
    popt = port.optimizer.AdamW(learning_rate=1e-2, parameters=pps)
    carried = optimizer_state_from_jax(sd, popt,
                                       names=ropt._parameter_names)
    for p, r in zip(pps, rps):
        got = carried["state"][p.name]["moment1"]
        want = np.asarray(ropt._accumulators[id(r)]["moment1"])
        np.testing.assert_array_equal(got.numpy(), want)
