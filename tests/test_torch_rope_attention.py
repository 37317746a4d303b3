"""The port's flash attention with RoPE in the tile (K11) against the JAX
reference on the CPU: the port's plain arm (what its wrapper runs on a
CPU tensor) against ``paddle_tpu.ops.pallas.fused_rope_attention
.fused_rope_flash_attention`` with ``use_kernel=True``, the Pallas kernel
in interpret mode, on the same numpy inputs, q rotated alone and with k,
head dims 128 and 256; the tables and the gate against the reference's.

Tolerance: fp32 rtol 1e-5 with atol 1e-5 (o is O(1); the plain arm's one
softmax against the kernel's blockwise online softmax differ in summation
order only). The tables are bit-equal."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_rope_attention as jr
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_rope_attention as tr


def _operands(seed, B, S, H, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, d).astype(np.float32) for _ in range(3))
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.arange(S, dtype=np.float32)[:, None] * inv
    return q, k, v, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("rope_k", [True, False])
@pytest.mark.parametrize("H,d", [(2, 128), (1, 256)])
def test_plain_arm_matches_reference_kernel(H, d, rope_k):
    q, k, v, cos, sin = _operands(d + rope_k, 1, 256, H, d)
    want = np.asarray(jr.fused_rope_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), causal=True,
        rope_k=rope_k, use_kernel=True))
    got = tr.fused_rope_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, cos, sin)), causal=True,
        rope_k=rope_k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_arm_is_rotation_then_flash():
    """Bitwise the composition the compiler replaces: apply_rope on the
    chosen side, then the separate-input flash."""
    from paddle_tpu_torch.models.llama import apply_rope

    q, k, v, cos, sin = (torch.from_numpy(a) for a in
                         _operands(3, 2, 128, 2, 128))
    cb, sb = cos[None, :, None, :], sin[None, :, None, :]
    want = tfa.flash_attention_raw(apply_rope(q, cb, sb), k, v, causal=True)
    got = tr.fused_rope_flash_attention(q, k, v, cos, sin, rope_k=False)
    assert torch.equal(got, want)


def test_rope_tables_bit_equal():
    _, _, _, cos, sin = _operands(0, 1, 128, 1, 128)
    jc, js = jr.rope_tables(jnp.asarray(cos), jnp.asarray(sin), 128)
    tc, ts = tr.rope_tables(torch.from_numpy(cos), torch.from_numpy(sin), 128)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [
    (1, 256, 2, 128), (1, 512, 1, 256), (1, 256, 2, 64), (1, 100, 2, 128),
    (256, 2, 128), (2, 128, 4, 128), (2, 192, 4, 128)])
def test_gate_equals_the_reference(shape):
    assert tr.fused_rope_supported(shape, torch.float32) == \
        jr.fused_rope_supported(shape, jnp.float32)


def test_gate_follows_the_flash_flags():
    try:
        GLOBAL_FLAGS.set("flash_attention_native_layout", False)
        assert not tr.fused_rope_supported((1, 256, 2, 128), torch.float32)
    finally:
        GLOBAL_FLAGS.set("flash_attention_native_layout", True)


def test_backward_is_a_later_slice():
    """The backward has come (K3 behind the rotary pullback): it runs and
    equals autograd through the plain composition (apply_rope, then the
    plain flash); tests/test_torch_llama_train.py holds it to jax.grad."""
    q, k, v, cos, sin = (torch.from_numpy(a) for a in
                         _operands(1, 1, 128, 1, 128))
    grads = []
    for fn in (tr.fused_rope_flash_attention, _composition):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, cos, sin)
        grads.append(torch.autograd.grad((o * o).sum(), leaves))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _composition(q, k, v, cos, sin):
    return tr.rope_flash_plain(q, k, v, cos, sin, True, q.shape[-1] ** -0.5,
                               True, True)[0]
