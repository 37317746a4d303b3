"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Skipped without one (a CUDA kernel has no CPU mode). This file
imports neither JAX nor the reference package, so it runs on the GPU
machine as it is:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: fp32 1e-4 (TF32 off, summation order only); bf16 attention
2e-2 (the plain version rounds probabilities to bf16 before the value
product); int8 matmul atol 1e-3 / rtol 1e-4 (fp32 accumulators)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rpa_case(G, d, bs, C=4, qb=4, nkv=2, mb=12, P=16, seed=0):
    rng = np.random.default_rng(seed)
    nH = nkv * G
    q = rng.normal(size=(C, qb, nH, d)).astype(np.float32)
    kp = rng.normal(size=(P, nkv, d, bs)).astype(np.float32)
    vp = rng.normal(size=(P, nkv, bs, d)).astype(np.float32)
    rows = rng.integers(1, P, size=(C, mb)).astype(np.int32)
    rows[3:] = 0
    pos0 = np.array([bs * mb - 1, bs - 2, bs + 3, 0], np.int32)[:C]
    n_valid = np.array([1, qb, 2, 1], np.int32)[:C]
    return q, kp, vp, rows, pos0, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,d,bs", [(1, 128, 128), (4, 128, 16),
                                    (4, 64, 32), (2, 256, 48)])
def test_rpa_kernel_matches_plain(cuda, dtype, atol, G, d, bs):
    q, kp, vp, rows, pos0, nv = _rpa_case(G, d, bs)
    fl = [torch.from_numpy(a).to(cuda, dtype) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(cuda) for a in (rows, pos0, nv)]
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*fl, *ints, 0.09)
    ref = ragged_paged_attention_plain(*fl, *ints, 0.09)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(16, 256, 384), (33, 100, 70),
                                   (512, 4096, 1024), (32, 4096, 1000)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8))
    s = torch.from_numpy((rng.random(size=(1, N)) * 1e-2).astype(np.float32))
    xt, wt, st = x.to(cuda, dtype), wq.to(cuda), s.to(cuda)
    before = quant_matmul.launches
    got = quant_matmul(xt, wt, st)
    ref = quant_matmul_plain(xt, wt, st)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_unsupported_geometry_raises(cuda):
    q, kp, vp, rows, pos0, nv = _rpa_case(1, 128, 128)
    fl = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(cuda) for a in (rows, pos0, nv)]
    with pytest.raises(ValueError):
        ragged_paged_attention(fl[0][..., :96].contiguous(),
                               fl[1][:, :, :96].contiguous(),
                               fl[2][..., :96].contiguous(), *ints, 0.1)
