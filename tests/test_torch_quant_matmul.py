"""Weight-only int8 matmul and weight quantization in the PyTorch port
against the JAX reference: the plain version vs ``_quant_matmul_xla`` and
the Pallas kernel in interpret mode (fp32 atol/rtol 1e-5, another
summation order); ``absmax_quantize_int8`` bit-equal in values and
scales; the CUDA kernel vs the plain version on a card."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.quant_matmul import (_quant_matmul_xla,
                                                quant_matmul_kernel)
from paddle_tpu.ops.quant import absmax_quantize_int8 as jax_absmax
from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
from paddle_tpu_torch.ops.quant import absmax_quantize_int8
from paddle_tpu_torch.utils.convert import params_from_jax

ATOL = 1e-5


def _case(M=16, K=256, N=384, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale = (rng.random(size=(1, N)) * 1e-2).astype(np.float32)
    return x, wq, scale


def test_plain_matches_reference_xla_arm():
    x, wq, s = _case()
    ref = _quant_matmul_xla(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    got = quant_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                       torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_plain_matches_reference_kernel_interpret():
    x, wq, s = _case(M=8, K=256, N=256, seed=1)
    ref = quant_matmul_kernel(jnp.asarray(x), jnp.asarray(wq),
                              jnp.asarray(s), 8, 128, 128)
    got = quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq),
                             torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_plain_keeps_leading_dims():
    x, wq, s = _case(M=12)
    got = quant_matmul(torch.from_numpy(x).reshape(3, 4, -1),
                       torch.from_numpy(wq), torch.from_numpy(s[0]))
    assert got.shape == (3, 4, wq.shape[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_quantize_bit_equal(dtype):
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(2, 64, 48)) * 0.02, dtype)
    a = a.at[0, :, 5].set(0)                       # an all-zero column
    jq, js = jax_absmax(a, axis=-2, scale_dtype=jnp.bfloat16)
    tq, ts = absmax_quantize_int8(
        params_from_jax(np.asarray(a), "cpu"), axis=-2,
        scale_dtype=torch.bfloat16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        ts.view(torch.int16).numpy(),
        np.asarray(js).view(np.uint16).astype(np.int16))

