"""The eager GPT Layer and the attention functionals against the
reference's, on the CPU.

The Layer: vocab 128, hidden 64, 2 layers, 4 heads, S 128, B 2, the
reference's weights carried across by ``layer_state_from_jax``; the
reference runs with its ``use_auto_fusion`` off (its JAX compiler needs
``jax.core.Var``), which it holds equal to its fused path, and its
Pallas kernels in interpret mode. Three AdamW steps (lr 1e-4, the
path's) with the global-norm clip; in fp32: every parameter's gradient
at the first step within rtol 1e-5 (and 1e-5 of the parameter's largest
gradient), the losses within rtol 1e-5, the parameters after the three
steps within atol 1e-5. In bf16 compute:
the three losses within rtol 1e-3 (the two packages' bf16 matmuls sum in
other orders).

SDPA at [2, 128, 4, 64] fp32, causal and not, with the flash flag on and
off, with a bool and an additive mask: the output and the three input
gradients within rtol 1e-5 (and 1e-5 of the largest magnitude), each
call routed as the reference routes it. ``flash_supported`` answers as
the reference's ``supported`` over a grid of shapes in fp32 and bf16.
Dropout 0.1: the kept share within 0.01 of 0.9, kept values scaled by
1 / 0.9.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import gpt as jg
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401

port.set_device("cpu")
SHAPE = dict(vocab_size=128, hidden=64, n_layers=2, n_heads=4, seq_len=128)
B = 2


@pytest.fixture
def ref_unfused():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _close(a, b, rtol, what, scaled=True):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = rtol * float(np.max(np.abs(b))) if scaled and b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _models(dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rm = jg.GPT(jg.GPTConfig(**SHAPE, dtype=jdt, param_dtype=jnp.float32),
                seed=0)
    pm = tg.GPT(tg.GPTConfig(**SHAPE, dtype=tdt, param_dtype=torch.float32),
                seed=0)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    return rm, pm


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, SHAPE["vocab_size"], (B, SHAPE["seq_len"])),
            rng.randint(0, SHAPE["vocab_size"], (B, SHAPE["seq_len"])))


def test_parameter_names_and_order(ref_unfused):
    rm, pm = _models("fp32")
    rn = [(n, tuple(p.shape)) for n, p in rm.named_parameters()]
    pn = [(n, tuple(p.shape)) for n, p in pm.named_parameters()]
    assert pn == rn and len(pn) == 16


def _train(pkg, m, tok, lab, steps=3):
    """The user's loop; returns the losses and the first step's
    gradients."""
    # the path's learning rate; AdamW moves an element whose gradient is
    # ~0 by up to lr whatever that gradient's rounding, so the parameter
    # bar (atol 1e-5) holds for lr up to ~1e-4
    opt = pkg.optimizer.AdamW(learning_rate=1e-4,
                              parameters=m.parameters(),
                              grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    losses, grads = [], None
    for _ in range(steps):
        loss = m.loss(pkg.to_tensor(tok), pkg.to_tensor(lab))
        loss.backward()
        if grads is None:
            grads = [p.grad.numpy() for p in m.parameters()]
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, grads


@pytest.mark.parametrize("dtype,rtol", [("fp32", 1e-5), ("bf16", 1e-3)])
def test_three_adamw_steps(ref_unfused, dtype, rtol):
    rm, pm = _models(dtype)
    tok, lab = _batch()
    rls, rgs = _train(ref, rm, tok, lab)
    pls, pgs = _train(port, pm, tok, lab)
    _close(pls, rls, rtol, "losses", scaled=False)
    assert pls[2] < pls[0]
    if dtype == "fp32":
        # the first loss's gradient of every parameter
        for (n, _), a, b in zip(rm.named_parameters(), pgs, rgs):
            _close(a, b, 1e-5, f"grad {n}")
        for (n, rp), pp in zip(rm.named_parameters(), pm.parameters()):
            np.testing.assert_allclose(pp.numpy(), rp.numpy(), rtol=0,
                                       atol=1e-5, err_msg=n)


def test_forward_logits(ref_unfused):
    rm, pm = _models("fp32")
    tok, _ = _batch()
    _close(pm(port.to_tensor(tok)).numpy(), rm(ref.to_tensor(tok)).numpy(),
           1e-5, "logits")


def test_funnel_ops_of_a_step(ref_unfused):
    """One eager step is one funnel op for the loss, whatever the model's
    size; the optimizer's update and the clip run outside the funnel."""
    _, pm = _models("fp32")
    tok, lab = _batch()
    seen = []
    port.core.dispatch.DISPATCH_HOOKS.append(seen.append)
    try:
        _train(port, pm, tok, lab, steps=1)
    finally:
        port.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
    assert seen == ["gpt_loss"]


# -- attention --------------------------------------------------------------

A_SHAPE = (2, 128, 4, 64)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(A_SHAPE).astype(np.float32)
            for _ in range(3)]


def _masks(kind):
    rng = np.random.default_rng(9)
    S = A_SHAPE[1]
    if kind == "bool":
        m = rng.random((A_SHAPE[0], 1, S, S)) < 0.8
        m[..., 0] = True
        return m
    if kind == "additive":
        return rng.standard_normal((1, A_SHAPE[2], S, S)).astype(np.float32)
    return None


def _sdpa(pkg, arrays, mask, causal, flag):
    flags = pkg.core.flags.GLOBAL_FLAGS
    old = flags.get("use_pallas_attention")
    flags.set("use_pallas_attention", flag)
    seen = []
    pkg.core.dispatch.DISPATCH_HOOKS.append(seen.append)
    try:
        q, k, v = (pkg.to_tensor(a, stop_gradient=False) for a in arrays)
        m = None if mask is None else pkg.to_tensor(mask)
        out = pkg.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m, is_causal=causal)
        cot = np.random.default_rng(4).standard_normal(A_SHAPE).astype(
            np.float32)
        grads = pkg.grad([out], [q, k, v], [pkg.to_tensor(cot)])
    finally:
        pkg.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
        flags.set("use_pallas_attention", old)
    return out.numpy(), [g.numpy() for g in grads], seen


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flag,mask", [(True, None), (False, None),
                                       (True, "bool"), (True, "additive")])
def test_sdpa_against_reference(causal, flag, mask):
    arrays = _qkv()
    m = _masks(mask)
    ro, rg, rseen = _sdpa(ref, arrays, m, causal, flag)
    po, pg, pseen = _sdpa(port, arrays, m, causal, flag)
    assert pseen == rseen
    assert pseen == (["pallas_flash_attention"] if flag and mask is None
                     else ["scaled_dot_product_attention"])
    _close(po, ro, 1e-5, "o")
    for name, a, b in zip("qkv", pg, rg):
        _close(a, b, 1e-5, f"d{name}")


def test_flash_attention_entry():
    arrays = _qkv(1)
    r = ref.nn.functional.flash_attention(
        *(ref.to_tensor(a) for a in arrays), causal=True)[0]
    p = port.nn.functional.flash_attention(
        *(port.to_tensor(a) for a in arrays), causal=True)[0]
    _close(p.numpy(), r.numpy(), 1e-5, "flash_attention")


def test_flash_attn_unpadded():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((10, 2, 16)).astype(np.float32)
               for _ in range(3))
    cu = np.asarray([0, 3, 10], np.int32)
    outs = []
    for pkg in (ref, port):
        t = [pkg.to_tensor(a) for a in (q, k, v)]
        outs.append(pkg.nn.functional.flash_attn_unpadded(
            *t, pkg.to_tensor(cu), pkg.to_tensor(cu), 7, 7, 0.25,
            causal=True)[0].numpy())
    _close(outs[1], outs[0], 1e-5, "unpadded")


def test_sdp_kernel_toggles_the_flag():
    with port.nn.functional.sdp_kernel(enable_flash=False):
        assert not port.get_flags("use_pallas_attention")[
            "use_pallas_attention"]
    assert port.get_flags("use_pallas_attention")["use_pallas_attention"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_supported_is_the_references(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for S in (64, 100, 128, 192, 256, 384, 640, 1000, 1024, 2048):
        for d in (32, 64, 80, 96, 128, 256, 512):
            for shape in ((2, S, 4, d), (S, 4, d), (1, 2, S, 4, d)):
                assert tfa.flash_supported(shape, tdt) == \
                    jfa.supported(shape, jdt), (shape, dtype)


def test_dropout_keeps_and_scales():
    """q = k = 0 gives every key probability 1/S; v one-hot per key makes
    the output the dropped probability row itself."""
    S = 64
    q = np.zeros((2, S, 4, S), np.float32)
    v = np.broadcast_to(np.eye(S, dtype=np.float32)[None, :, None, :],
                        (2, S, 4, S)).copy()
    port.seed(5)
    out = port.nn.functional.scaled_dot_product_attention(
        port.to_tensor(q), port.to_tensor(q), port.to_tensor(v),
        dropout_p=0.1).numpy()
    kept = out != 0
    assert abs(kept.mean() - 0.9) < 0.01
    np.testing.assert_allclose(out[kept], 1.0 / S / 0.9, rtol=1e-6)
    off = port.nn.functional.scaled_dot_product_attention(
        port.to_tensor(q), port.to_tensor(q), port.to_tensor(v),
        dropout_p=0.1, training=False).numpy()
    np.testing.assert_allclose(off, 1.0 / S, rtol=1e-6)
