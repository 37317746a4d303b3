"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Skipped without one (a CUDA kernel has no CPU mode). This file
imports neither JAX nor the reference package, so it runs on the GPU
machine as it is:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: fp32 1e-4 (TF32 off, summation order only); bf16 attention
2e-2 (the plain version rounds probabilities to bf16 before the value
product); int8 matmul atol 1e-3 / rtol 1e-4 (fp32 accumulators). The
training kernels are held element by element, each error over the larger
of the element's magnitude and the RMS of its row (a head row of o or
dqkv, a token row of dx, a vocab column of dhead; rows under 1e-3 of the
tensor's RMS, rounding noise of an exact 0, held to that floor): 1e-4 in
fp32, 3 * 2^-7 in bf16, three bf16 ulps (each side's output rounding,
and p, ds or dl rounded against another running max). The cross-entropy
logits have std 3,
so the softmax is far from flat, and dhead is also held on the vocab
columns that are no token's label, where dl is the softmax part alone.
The split flash backward (K3) must equal the merged one (K2) bit for bit
on the fused qkv, and its separate mode the fused mode on the same
values; the int8 kernels (K8q, K10q) must equal their fp kernels (K8,
K10) bit for bit on inputs dequantized beforehand, and their plain versions within
the fp kernels' tolerances; K13's fp32 output is held by row within 1e-5
(exact widenings of its inputs, fp32 sums in another order), its slot-0
rows exactly 0, a row's bits the same wherever a call carries it, its
launches through the cluster kernel at ``lora_plan_c == lora_plan``, and
shapes outside the reference's gate refused. The head-major flash (K17)
must equal K1-sep and K3-sep bit for bit on the same values; the paged decode kernels (K15, K14) are
held by row to their plain versions at the training tolerances above
(K15's plain version rounds p to the page dtype as the kernel does), and
K16 must equal K14 bit for bit, also at its own rings' edges
(``paged_dma_plan``, whose C plan must be the Python one). K9 runs in
three variants: each case asserts which variant's counter moved (``qmm_plan``); K14's ring
(``paged_ring_geometry``) and K15's (``paged_mxu_plan``, whose C plan
must be the Python one) are held at their edges: a length that ends on a
stage, one that ends on the ring's last stage, one inside a stage, 0 and
a full table. K10 and K10q at llama1b's decode (B 1, 8, 16): one kernel
launch a call (the kernel nodes of a CUDA graph that captured one call)
and one allocation, the output; the C launcher's cluster plan
``decode_plan``'s; deterministic. The flash tile loops (TMA + wgmma for bf16 at head dim 64
and 128): the C launchers' plan is ``flash_plan``'s; at several row
blocks per (batch, head) (the persistent forward's items, the backward's
ordered blocks) K1, K1-sep and K17's forward agree bit for bit, K2, K3,
K3 again, K3's separate mode and K17's backward too, K11 equals K1-sep
on rotated inputs, each within its tolerance of its plain version, and
every launch is counted as the wgmma variant (the launchers report what
they launched); the forward's scheduling counters are back at 0 after
each launch, each stream has its own, and a launch captured in a CUDA
graph owns one. The cross-entropy tile loop (TMA + wgmma for bf16): the C
launchers' plan is ``ce_plan``'s, every bf16 product is counted as the
wgmma variant (the entries report what they launched), K5 is bitwise
reproducible and K4/K5 hold their plain versions with ragged token, vocab
and slab edges. K7's walk is ``bias_gelu_plan``'s, and the first 256 rows
of gpt3-350m's FFN input alone give the bits of those rows of the whole
call. K8 / K8q (bf16, d 64/128, pages of a multiple of 64: splits by key
position in a cluster, a TMA ring, wgmma): the C plan is ``rpa_plan``'s;
at llama3-8b's width (mb 16 and 32) a query row's bits do not depend on
the chunk that carries it (decode, 4-row verify and 16-row prefill
chunks at every offset, positions on page and split edges, other
chunks and C varying), and K8q equals K8 on dequantized pages with
ragged n_valid and idle sink chunks. The serving fleet's overlapped wire:
an export staged while a step is in flight (gather on the engine's
stream, copy into pinned memory on a side stream) ships the synchronous
export's bytes, writes enqueued after the staging do not reach it, and
a deferred adoption commit lands before the next step reads the page."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import collections

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as ce
from paddle_tpu_torch.ops.kernels import lora_matmul as lm
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
                                    (4, 64, 32), (2, 256, 48), (4, 128, 64),
                                    (4, 64, 128), (16, 128, 256)])
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


def _qmm_case(cuda, dtype, M, K, N, seed=1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    wq = torch.randint(-127, 128, (K, N), generator=gen, device=cuda,
                       dtype=torch.int8)
    s = torch.rand((1, N), generator=gen, device=cuda) * 1e-2
    return x, wq, s


def _qmm_held(cuda, dtype, M, K, N):
    """K9 against its plain version; returns the variant that ran."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import qmm_plan

    x, wq, s = _qmm_case(cuda, dtype, M, K, N)
    variant = qmm_plan(M, K, N, dtype)["variant"]
    counter = "launches_" + variant
    before = (quant_matmul.launches, getattr(quant_matmul, counter))
    got = quant_matmul(x, wq, s)
    ref = quant_matmul_plain(x, wq, s)
    torch.cuda.synchronize()
    assert (quant_matmul.launches,
            getattr(quant_matmul, counter)) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3, rtol=1e-4)
    return variant


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(16, 256, 384), (33, 100, 70),
                                   (512, 4096, 1024), (32, 4096, 1000)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    want = {torch.float32: "fma"}.get(
        dtype, "mma" if K % 8 or N % 16 else "wgmma")
    assert _qmm_held(cuda, dtype, M, K, N) == want


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
    (512, 14336, 4096), (32, 4096, 128256),        # the engine's five
    (1, 4096, 1024), (63, 4096, 1024), (65, 4096, 4096), (511, 4096, 1024),
    (512, 200, 4096), (65, 4104, 1024), (33, 1000, 128256)])
def test_quant_matmul_wgmma_variant(cuda, M, K, N):
    """The TMA + wgmma variant at the engine's shapes and the tiles'
    edges: M 1, 63, 65, 511 (rows past M), K 200 and 4104 (a partial
    last K step), N 1024 (split K) and 128256 (501 tiles)."""
    assert _qmm_held(cuda, torch.bfloat16, M, K, N) == "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(512, 4096, 1000), (64, 4100, 1024),
                                   (1, 64, 24)])
def test_quant_matmul_unaligned_takes_mma(cuda, M, K, N):
    """Shapes TMA cannot take (N % 16, K % 8) go to the mma.sync kernel."""
    assert _qmm_held(cuda, torch.bfloat16, M, K, N) == "mma"


@pytest.mark.cuda
def test_unsupported_geometry_raises(cuda):
    q, kp, vp, rows, pos0, nv = _rpa_case(1, 128, 128)
    fl = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(cuda) for a in (rows, pos0, nv)]
    with pytest.raises(ValueError):
        ragged_paged_attention(fl[0][..., :96].contiguous(),
                               fl[1][:, :, :96].contiguous(),
                               fl[2][..., :96].contiguous(), *ints, 0.1)


def _scaled(got, ref, dim=-1):
    g, r = got.float(), ref.float()
    rms = r.pow(2).mean(dim=dim, keepdim=True).sqrt()
    floor = max(1e-3 * r.pow(2).mean().sqrt().item(), 1e-30)
    return ((g - r).abs() / torch.maximum(r.abs(), rms).clamp_min(floor)
            ).max().item()


def _heads(dqkv, h):
    B, S, H3 = dqkv.shape
    return dqkv.reshape(B, S, 3, h, H3 // (3 * h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("h,d,causal", [(4, 64, True), (2, 128, True),
                                        (2, 128, False), (1, 256, True)])
def test_flash_kernels_match_plain(cuda, dtype, tol, h, d, causal):
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(2, 192, 3 * h * d)).astype(
        np.float32)).to(cuda, dtype)
    do = torch.from_numpy(rng.normal(size=(2, 192, h, d)).astype(
        np.float32)).to(cuda, dtype)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(qkv, h, causal, d ** -0.5)
    ro, rlse = fa.flash_fwd_plain(qkv, h, causal, d ** -0.5)
    dqkv = fa.flash_bwd(qkv, o, lse, do, h, causal, d ** -0.5)
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert _scaled(o, ro) <= tol and _scaled(lse, rlse) <= 1e-4
    assert _scaled(_heads(dqkv, h), _heads(ref, h)) <= tol
    assert torch.equal(dqkv, fa.flash_bwd(qkv, o, lse, do, h, causal,
                                          d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("N,H,V", [(300, 128, 1000), (1024, 256, 4096),
                                   (300, 128, 9192)])
def test_fused_ce_kernels_match_plain(cuda, dtype, tol, N, H, V):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(
        cuda, dtype)
    wte = torch.from_numpy((rng.normal(size=(V, H)) * 3 / H ** 0.5).astype(
        np.float32)).to(cuda, dtype)
    lab = torch.from_numpy(rng.integers(0, V, size=N)).to(cuda)
    g = torch.from_numpy(rng.random(N).astype(np.float32)).to(cuda)
    before = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    nll, lse = ce.fused_ce_fwd(x, wte.t(), lab)
    rnll, rlse = ce.fused_ce_fwd_plain(x, wte.t(), lab)
    dx, dh = ce.fused_ce_bwd(x, wte.t(), lab, lse, g)
    rdx, rdh = ce.fused_ce_bwd_plain(x, wte.t(), lab, lse, g)
    torch.cuda.synchronize()
    slabs = -(-V // ce.SLAB)
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == \
        (before[0] + 2, before[1] + 3 * slabs)
    assert _scaled(nll, rnll) <= 1e-4 and _scaled(lse, rlse) <= 1e-4
    assert _scaled(dx, rdx) <= tol and _scaled(dh, rdh, dim=0) <= tol
    free = torch.ones(V, dtype=torch.bool, device=cuda)
    free[lab] = False
    assert _scaled(dh[:, free], rdh[:, free], dim=0) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H,V", [(16384, 1024, 50304), (4096, 2048, 50304),
                                   (300, 128, ce.SLAB + 1000)])
def test_ce_plan_c_matches_ce_plan(cuda, dtype, N, H, V):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ce.ce_plan_c(N, H, V, dtype) == ce.ce_plan(N, H, V, dtype, sms=sms)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(300, 128, ce.SLAB + 1000),
                                   (129, 384, 136), (1024, 256, 4096),
                                   (4100, 2048, 2 * ce.SLAB)])
def test_fused_ce_bf16_takes_wgmma_and_is_deterministic(cuda, N, H, V):
    """Every bf16 product of K4 and K5 is counted as the wgmma variant,
    one "stats" and three a slab; two backward calls are bit-equal; both
    hold their plain versions at ragged token, vocab and slab edges."""
    rng = np.random.default_rng(7)
    tol = 3 * 2 ** -7
    x = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    wte = torch.from_numpy((rng.normal(size=(V, H)) * 3 / H ** 0.5).astype(
        np.float32)).to(cuda, torch.bfloat16)
    lab = torch.from_numpy(rng.integers(0, V, size=N)).to(cuda)
    g = torch.from_numpy(rng.random(N).astype(np.float32)).to(cuda)
    before = collections.Counter(ce.PRODUCTS)
    nll, lse = ce.fused_ce_fwd(x, wte.t(), lab)
    dx, dh = ce.fused_ce_bwd(x, wte.t(), lab, lse, g)
    dx2, dh2 = ce.fused_ce_bwd(x, wte.t(), lab, lse, g)
    rnll, rlse = ce.fused_ce_fwd_plain(x, wte.t(), lab)
    rdx, rdh = ce.fused_ce_bwd_plain(x, wte.t(), lab, lse, g)
    torch.cuda.synchronize()
    slabs = -(-V // ce.SLAB)
    assert dict(ce.PRODUCTS - before) == {
        ("wgmma", "bfloat16", "stats"): 1,
        ("wgmma", "bfloat16", "dl"): 2 * slabs,
        ("wgmma", "bfloat16", "dx"): 2 * slabs,
        ("wgmma", "bfloat16", "dw"): 2 * slabs}
    assert torch.equal(dx, dx2) and torch.equal(dh, dh2)
    assert (nll - rnll).abs().max().item() <= 1e-3
    assert (lse - rlse).abs().max().item() <= 1e-3
    assert _scaled(dx, rdx) <= tol and _scaled(dh, rdh, dim=0) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,dtype", [(16384, 4096, torch.bfloat16),
                                       (300, 5504, torch.bfloat16),
                                       (512, 256, torch.float32),
                                       (7, 1000, torch.float32)])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_bias_gelu_plan_c_matches_plan(cuda, n, f, dtype, bias_dtype):
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    got = fba.bias_gelu_plan_c(n, f, dtype, bias_dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert got == fba.bias_gelu_plan(n, f, itemsize, got["resident"])
    assert got["resident"] >= torch.cuda.get_device_properties(
        cuda).multi_processor_count


@pytest.mark.cuda
def test_bias_gelu_rows_alone_give_the_call_bits(cuda):
    """K7 on the first 256 rows of a [16384, 4096] bf16 input (fp32
    bias) gives the bits of those rows of the whole call, and both are
    the plain composition's: the walk does not change an element's
    arithmetic."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    rng = np.random.default_rng(9)
    x = torch.from_numpy((2 * rng.normal(size=(16384, 4096))).astype(
        np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(cuda)
    y = fba.bias_gelu_fwd(x, b)
    head = fba.bias_gelu_fwd(x[:256].contiguous(), b)
    torch.cuda.synchronize()
    assert torch.equal(head, y[:256])
    assert torch.equal(y, fba.bias_gelu_plain(x, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("norm,sub,bias,act", [
    ("layer", True, True, None), ("layer", False, False, None),
    ("layer", True, False, "gelu"), ("rms", True, True, None),
    ("rms", False, False, "gelu")])
@pytest.mark.parametrize("n,h", [(256, 128), (512, 1024), (256, 4096)])
def test_norm_epilogue_kernel_matches_plain(cuda, dtype, tol, norm, sub,
                                            bias, act, n, h):
    """K6: r bit-equal to the plain composition, y within tol by row."""
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    rng = np.random.default_rng(4)

    def arr(*shape, mean=0.0, std=1.0):
        return torch.from_numpy((mean + std * rng.normal(size=shape)).astype(
            np.float32)).to(cuda)

    x = arr(n, h).to(dtype)
    s = arr(n, h).to(dtype) if sub else None
    b = arr(h, std=0.5) if bias else None
    g, be = arr(h, mean=1.0, std=0.2), arr(h, std=0.2)
    be = be.to(torch.bfloat16) if norm == "layer" else None
    before = fne.norm_epilogue_fwd.launches
    r, y = fne.norm_epilogue_fwd(x, s, b, g, be, norm, 1e-5, act)
    rr, ry = fne.norm_epilogue_plain(x, s, b, g, be, norm, 1e-5, act)
    torch.cuda.synchronize()
    assert fne.norm_epilogue_fwd.launches == before + 1
    assert torch.equal(r, rr)
    assert _scaled(y, ry) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("n,f", [(256, 128), (300, 4096), (1024, 1024)])
def test_bias_gelu_kernel_matches_plain(cuda, dtype, tol, n, f):
    """K7 within tol by row, the bias in fp32 and in bf16."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    rng = np.random.default_rng(5)
    x = torch.from_numpy((2 * rng.normal(size=(n, f))).astype(
        np.float32)).to(cuda, dtype)
    for b in (torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(
            cuda), torch.from_numpy(rng.normal(size=f).astype(
                np.float32)).to(cuda, torch.bfloat16)):
        before = fba.bias_gelu_fwd.launches
        y = fba.bias_gelu_fwd(x, b)
        ref = fba.bias_gelu_plain(x, b)
        torch.cuda.synchronize()
        assert fba.bias_gelu_fwd.launches == before + 1
        assert _scaled(y, ref) <= tol


@pytest.mark.cuda
def test_fused_gpt_forward_runs_the_kernels(cuda):
    """A small bf16 GPT's fused forward on the card launches K6 2L+1 and
    K7 L times and stays within three bf16 ulps of the unfused one."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    cfg = gpt.GPTConfig(vocab_size=512, hidden=256, n_layers=2, n_heads=4,
                        seq_len=256, remat=False)
    params = gpt.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, size=(2, 256))).to(cuda)
    before = (fne.norm_epilogue_fwd.launches, fba.bias_gelu_fwd.launches)
    fused, _ = gpt.model_apply(params, tokens, cfg, return_hidden=True)
    torch.cuda.synchronize()
    assert (fne.norm_epilogue_fwd.launches - before[0],
            fba.bias_gelu_fwd.launches - before[1]) == (5, 2)
    old = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", False)
    try:
        plain, _ = gpt.model_apply(params, tokens, cfg, return_hidden=True)
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", old)
    assert _scaled(fused, plain) <= 3 * 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("G,d,S", [(4, 128, 2048), (2, 64, 256),
                                   (8, 256, 512), (1, 128, 128)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, G, d, S):
    """K10 at cache positions 0, a ragged chunk, a chunk edge and S - 1,
    deterministic across calls."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    rng = np.random.default_rng(7)
    B, nkv = 3, 2
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((B, nkv * G, d), (B, nkv, S, d),
                               (B, nkv, S, d)))
    for pos in (0, 37, 63, 64, S - 1):
        before = da.decode_attention.launches
        got = da.decode_attention(q, ck, cv, pos, d ** -0.5)
        ref = da.decode_attention_plain(q, ck, cv, pos, d ** -0.5)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        assert _scaled(got, ref) <= tol, pos
        assert torch.equal(got, da.decode_attention(q, ck, cv, pos,
                                                    d ** -0.5))


def _rope_inputs(cuda, dtype, B, S, h, d, seed=8):
    from paddle_tpu_torch.models.llama import LlamaConfig, rope_angles

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    cos, sin = rope_angles(LlamaConfig(hidden=h * d, n_heads=h),
                           torch.arange(S, device=cuda))
    return q, k, v, cos, sin


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("h,d", [(2, 128), (1, 256)])
@pytest.mark.parametrize("rope_k", [False, True])
def test_rope_flash_kernel_matches_plain(cuda, dtype, tol, h, d, rope_k):
    """K11 within tol of its plain version, and bit-equal to K1's
    separate-input mode on apply_rope'd inputs (the same tile loop: any
    difference would be the rotation in the tile)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    q, k, v, cos, sin = _rope_inputs(cuda, dtype, 2, 192, h, d)
    before = fra.rope_flash_fwd.launches
    got = fra.rope_flash_fwd(q, k, v, cos, sin, True, d ** -0.5, True,
                             rope_k)[0]
    ref = fra.rope_flash_plain(q, k, v, cos, sin, True, d ** -0.5, True,
                               rope_k)[0]
    cb, sb = cos[None, :, None, :], sin[None, :, None, :]
    kr = fra._apply_rope_ref(k, cb, sb) if rope_k else k
    k1 = fa.flash_fwd_sep(fra._apply_rope_ref(q, cb, sb), kr, v, True,
                          d ** -0.5)[0]
    torch.cuda.synchronize()
    assert fra.rope_flash_fwd.launches == before + 1
    assert torch.equal(got, k1)
    assert _scaled(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("h,d,causal", [(4, 64, True), (2, 128, False),
                                        (1, 256, True)])
def test_flash_sep_kernel_matches_plain(cuda, dtype, tol, h, d, causal):
    """K1's separate-input mode, and equal to the fused-qkv mode on the
    same values."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, _, _ = _rope_inputs(cuda, dtype, 2, 192, h, d, seed=9)
    before = fa.flash_fwd_sep.launches
    got = fa.flash_fwd_sep(q, k, v, causal, d ** -0.5)[0]
    ref = fa.flash_sep_plain(q, k, v, causal, d ** -0.5)[0]
    qkv = torch.cat([t.reshape(2, 192, h * d) for t in (q, k, v)], dim=-1)
    fused, _ = fa.flash_fwd(qkv, h, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_fwd_sep.launches == before + 1
    assert torch.equal(got, fused)
    assert _scaled(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("n,f", [(256, 128), (300, 5504), (64, 14336)])
def test_swiglu_kernel_matches_plain(cuda, dtype, tol, n, f):
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    rng = np.random.default_rng(10)
    g, u = (torch.from_numpy((s * rng.normal(size=(n, f))).astype(
        np.float32)).to(cuda, dtype) for s in (2.0, 1.0))
    before = fba.swiglu_fwd.launches
    y = fba.swiglu_fwd(g, u)
    ref = fba.swiglu_plain(g, u)
    torch.cuda.synchronize()
    assert fba.swiglu_fwd.launches == before + 1
    assert _scaled(y, ref) <= tol


@pytest.mark.cuda
def test_llama_engine_runs_the_kernels(cuda):
    """A small bf16 LLaMA's generate on the card: K11, K12 and K6 in the
    fused prefill (L, L, 2L + 1), K10 L times per decode step."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    cfg = LlamaConfig(vocab_size=512, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=768, max_seq_len=512)
    m = LlamaForCausalLM(cfg, device=cuda)
    prompt = np.random.default_rng(11).integers(0, 512, size=(2, 128))
    counters = (da.decode_attention, fra.rope_flash_fwd, fba.swiglu_fwd,
                fne.norm_epilogue_fwd)
    before = [c.launches for c in counters]
    toks = m.generate(prompt, max_new_tokens=5)
    torch.cuda.synchronize()
    assert toks.shape == (2, 5)
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [2 * 4, 2, 2, 5]


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
        np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,d,bs", [(1, 128, 128), (4, 128, 16),
                                    (4, 64, 32), (2, 256, 48), (4, 128, 64),
                                    (4, 64, 128), (16, 128, 256)])
def test_rpa_int8_kernel_matches_k8_and_plain(cuda, dtype, atol, G, d, bs):
    """K8q: equal to K8 on the pages dequantized beforehand (torch.equal:
    the staged tiles are the same bits) and within K8's tolerance of the
    plain version."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention_int8
    from paddle_tpu_torch.ops.quant import dequantize_int8

    q, _, _, rows, pos0, nv = _rpa_case(G, d, bs)
    rng = np.random.default_rng(12)
    P, nkv = 16, 2
    kq, vq = _int8(rng, (P, nkv, d, bs)).to(cuda), _int8(
        rng, (P, nkv, bs, d)).to(cuda)
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, size=(P, nkv)).astype(
        np.float32)).to(cuda) for _ in range(2))
    qt = torch.from_numpy(q).to(cuda, dtype)
    ints = [torch.from_numpy(a).to(cuda) for a in (rows, pos0, nv)]
    before = ragged_paged_attention_int8.launches
    got = ragged_paged_attention(qt, kq, vq, *ints, 0.09, k_scales=ks,
                                 v_scales=vs)
    k8 = ragged_paged_attention(
        qt, dequantize_int8(kq, ks[:, :, None, None], dtype),
        dequantize_int8(vq, vs[:, :, None, None], dtype), *ints, 0.09)
    ref = ragged_paged_attention_plain(qt, kq, vq, *ints, 0.09, ks, vs)
    torch.cuda.synchronize()
    assert ragged_paged_attention_int8.launches == before + 1
    assert torch.equal(got, k8)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol,
                               rtol=atol)


# llama3-8b's attention width: 32 q heads, 8 kv heads, head dim 128
RPA_WIDTH = dict(nH=32, nKV=8, d=128, bs=128, qb=16)
RPA_EDGES = (0, 1, 63, 64, 127, 128, 129, 255, 256, 511, 512, 1023, 1024,
             1025, 2047, 2048, 3071, 3072, 4095)


def _rpa_pages(cuda, gen, P, quant):
    w = RPA_WIDTH
    shapes = ((P, w["nKV"], w["d"], w["bs"]), (P, w["nKV"], w["bs"], w["d"]))
    if quant:
        kp, vp = (torch.randint(-127, 128, sh, generator=gen, device=cuda,
                                dtype=torch.int8) for sh in shapes)
        return kp, vp, [torch.rand((P, w["nKV"]), generator=gen,
                                   device=cuda) * 0.02 + 0.01
                        for _ in range(2)]
    kp, vp = (torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16)
              for sh in shapes)
    return kp, vp, [None, None]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mb", [16, 32])
def test_rpa_rows_do_not_depend_on_their_chunk(cuda, mb, quant):
    """K8 / K8q's split combine: a query row's output bits are the same
    whether a decode chunk (n_valid 1), a verify chunk of 4 rows or a
    16-row prefill chunk carries it, at every offset of those chunks,
    for positions on tile (64), page (128) and split (1024 keys) edges, beside
    other requests' decode rows and idle sink rows, over calls of
    different C."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    w = RPA_WIDTH
    S, P, qb = mb * w["bs"], mb + 9, w["qb"]
    gen = torch.Generator(device=cuda).manual_seed(mb + 2 * quant)
    rng = np.random.default_rng(mb)
    q_all = torch.randn((S, w["nH"], w["d"]), generator=gen,
                        device=cuda).to(torch.bfloat16)
    kp, vp, sc = _rpa_pages(cuda, gen, P, quant)
    table = rng.permutation(np.arange(1, P))[:mb].astype(np.int32)
    carriers = [(p, nv, o) for p in RPA_EDGES for nv in (1, 4, 16)
                for o in range(nv) if p - o >= 0 and p - o + nv <= S]
    order = rng.permutation(len(carriers))
    before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
    got, i, call = {}, 0, 0
    while i < len(order):
        n = min((29, 64, 3, 50)[call % 4], len(order) - i)
        call += 1
        C = n + int(rng.integers(0, 4))
        q = torch.randn((C, qb, w["nH"], w["d"]), generator=gen,
                        device=cuda).to(torch.bfloat16)
        rows = np.zeros((C, mb), np.int32)
        pos0, nval = np.zeros(C, np.int32), np.ones(C, np.int32)
        slots = rng.permutation(C)
        for k, idx in enumerate(order[i:i + n]):
            p, nv, o = carriers[idx]
            c = int(slots[k])
            rows[c], pos0[c], nval[c] = table, p - o, nv
            q[c, :nv] = q_all[p - o:p - o + nv]
        for c in slots[n:]:
            if rng.random() < 0.5:
                rows[c] = rng.integers(1, P, size=mb)
                pos0[c] = rng.integers(0, S)
        out = ragged_paged_attention(
            q, kp, vp, *(torch.from_numpy(a).to(cuda)
                         for a in (rows, pos0, nval)), w["d"] ** -0.5,
            k_scales=sc[0], v_scales=sc[1])
        for k, idx in enumerate(order[i:i + n]):
            p, nv, o = carriers[idx]
            got[carriers[idx]] = out[int(slots[k]), o]
        i += n
    torch.cuda.synchronize()
    assert {k[0] for k in rpa.LAUNCHES_BY_PLAN - before} == {"wgmma"}
    for (p, nv, o), row in got.items():
        assert torch.equal(row, got[(p, 1, 0)]), (p, nv, o)


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [16, 32])
def test_rpa_int8_equals_k8_at_the_engine_width(cuda, mb):
    """K8q bit-equal to K8 on pages dequantized beforehand at llama3-8b's
    width, both through the wgmma variant: ragged n_valid (1, 2, 5, 16),
    chunks straddling pages and splits, a chunk at the table's end and
    idle sink chunks; K8 within 2e-2 of its plain version."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.quant import dequantize_int8

    w = RPA_WIDTH
    S, P, qb = mb * w["bs"], 2 * mb + 3, w["qb"]
    gen = torch.Generator(device=cuda).manual_seed(mb)
    rng = np.random.default_rng(mb + 1)
    kq, vq, (ks, vs) = _rpa_pages(cuda, gen, P, True)
    C = 12
    rows = np.stack([rng.permutation(np.arange(1, P))[:mb]
                     for _ in range(C)]).astype(np.int32)
    rows[9:] = 0                                      # idle: the sink
    pos0 = np.array([0, 127, 255, 300, S - 1, 1000, 250, 511, S - 16, 0, 0,
                     0], np.int32)
    nval = np.array([1, 2, 5, 16, 1, 16, 16, 2, 16, 1, 1, 1], np.int32)
    ints = [torch.from_numpy(a).to(cuda) for a in (rows, pos0, nval)]
    q = torch.randn((C, qb, w["nH"], w["d"]), generator=gen,
                    device=cuda).to(torch.bfloat16)
    kd = dequantize_int8(kq, ks[:, :, None, None], torch.bfloat16)
    vd = dequantize_int8(vq, vs[:, :, None, None], torch.bfloat16)
    before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
    got = ragged_paged_attention(q, kq, vq, *ints, 0.088, k_scales=ks,
                                 v_scales=vs)
    k8 = ragged_paged_attention(q, kd, vd, *ints, 0.088)
    ref = ragged_paged_attention_plain(q, kd, vd, *ints, 0.088)
    torch.cuda.synchronize()
    assert {k[0] for k in rpa.LAUNCHES_BY_PLAN - before} == {"wgmma"}
    assert torch.equal(got, k8)
    valid = torch.arange(qb, device=cuda)[None, :] < ints[2][:, None]
    err = (k8.float() - ref.float()).abs()[valid].max().item()
    assert err <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mb,bs,d,G,qb", [(16, 128, 128, 4, 16),
                                          (32, 128, 128, 4, 16),
                                          (12, 64, 64, 2, 4),
                                          (5, 256, 128, 16, 32),
                                          (12, 16, 128, 4, 4),
                                          (3, 128, 256, 1, 16)])
def test_rpa_plan_c_matches_plan(cuda, dtype, quant, mb, bs, d, G, qb):
    """The C launcher's plan is rpa_plan's; the card holds at least one
    cluster of the wgmma variant at once."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    plan = rpa.rpa_plan(mb, bs, d, G, qb, dtype, quant)
    plan_c = rpa.rpa_plan_c(mb, bs, d, G, qb, dtype, quant)
    assert {k: plan_c[k] for k in plan} == plan
    assert plan_c["clusters"] >= 1 or plan["variant"] != "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,qb,H,r,N", [(32, 16, 4096, 8, 4096),
                                        (5, 8, 384, 8, 1024),
                                        (4, 40, 640, 16, 512),
                                        (2, 8, 128, 4, 128),
                                        (3, 24, 1536, 16, 384)])
def test_lora_kernel_matches_plain(cuda, dtype, C, qb, H, r, N):
    """K13 within 1e-5 of the plain fp32 version by row, slot-0 rows
    exactly 0, deterministic, every launch through the cluster kernel at
    ``lora_plan_c == lora_plan`` (shapes inside the reference's gate:
    clusters of 8, 4, 2 and 1 block, one and several 8-row groups and H
    chunks)."""
    from paddle_tpu_torch.ops.kernels.lora_matmul import (lora_matmul,
                                                          lora_matmul_plain)

    rng = np.random.default_rng(13)
    S = 5
    x = torch.from_numpy(rng.normal(size=(C, qb, H)).astype(np.float32))
    a = torch.from_numpy((0.05 * rng.normal(size=(S, H, r))).astype(
        np.float32))
    b = torch.from_numpy((0.05 * rng.normal(size=(S, r, N))).astype(
        np.float32))
    a[0], b[0] = 0, 0
    ids = torch.from_numpy(rng.integers(0, S, size=C).astype(np.int32))
    ids[0] = 0
    x, a, b = (t.to(cuda, dtype) for t in (x, a, b))
    ids = ids.to(cuda)
    before = lora_matmul.launches
    by_plan = collections.Counter(lm.LAUNCHES_BY_PLAN)
    got = lora_matmul(x, a, b, ids)
    ref = lora_matmul_plain(x, a, b, ids)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    dt = str(dtype).replace("torch.", "")
    assert lm.LAUNCHES_BY_PLAN - by_plan == collections.Counter(
        {("cluster", dt, H, N, r): 1})
    es = dtype.itemsize
    assert lm.lora_plan_c(H, N, r, es) == lm.lora_plan(H, N, r, es)
    assert got.dtype == torch.float32 and _scaled(got, ref) <= 1e-5
    assert (got[ids == 0] == 0).all()
    assert torch.equal(got, lora_matmul(x, a, b, ids))


@pytest.mark.cuda
def test_lora_fp32_long_h_holds_to_fp64(cuda):
    """K13 in fp32 at H 14336 (clusters of 8, 1792 columns of H a block,
    several chunks and row groups) within 1e-5 of an fp64 evaluation of
    the same function, row by row; slot-0 rows exactly 0. (The fp32
    plain version, one cuBLAS sum over all of H, is held to the kernel
    at H up to 4096.)"""
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul

    rng = np.random.default_rng(13)
    C, qb, H, r, N, S = 3, 24, 14336, 16, 384, 5
    x = torch.from_numpy(rng.normal(size=(C, qb, H)).astype(np.float32))
    a = torch.from_numpy((0.05 * rng.normal(size=(S, H, r))).astype(
        np.float32))
    b = torch.from_numpy((0.05 * rng.normal(size=(S, r, N))).astype(
        np.float32))
    a[0], b[0] = 0, 0
    ids = torch.from_numpy(np.array([0, 3, 1], np.int32))
    ref = torch.einsum("cqr,crn->cqn",
                       torch.einsum("cqh,chr->cqr", x.double(),
                                    a[ids.long()].double()),
                       b[ids.long()].double())
    got = lora_matmul(x.to(cuda), a.to(cuda), b.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert (got[0] == 0).all()
    assert _scaled(got[1:].cpu().double(), ref[1:]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,r,N", [(4096, 8, 4096), (4096, 8, 1024),
                                   (640, 16, 384)])
def test_lora_rows_do_not_depend_on_their_call(cuda, dtype, H, r, N):
    """K13: the same x row on the same adapter, carried at other (c, i)
    in calls of other C (1, 3 and 33 packed rows, qb 8 and 16), gives
    ``torch.equal`` output rows."""
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul

    rng = np.random.default_rng(17)
    S, C, qb = 4, 6, 16
    a = torch.from_numpy((0.05 * rng.normal(size=(S, H, r))).astype(
        np.float32)).to(cuda, dtype)
    b = torch.from_numpy((0.05 * rng.normal(size=(S, r, N))).astype(
        np.float32)).to(cuda, dtype)
    x = torch.from_numpy(rng.normal(size=(C, qb, H)).astype(
        np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.integers(0, S, size=C).astype(
        np.int32)).to(cuda)
    ref = lora_matmul(x, a, b, ids)
    for C2, qb2 in ((1, 8), (3, 16), (33, 8)):
        x2 = torch.from_numpy(rng.normal(size=(C2, qb2, H)).astype(
            np.float32)).to(cuda, dtype)
        ids2 = torch.from_numpy(rng.integers(0, S, size=C2).astype(
            np.int32)).to(cuda)
        moves = [((c, int(rng.integers(qb))), (c2, int(rng.integers(qb2))))
                 for c2, c in zip(range(C2), rng.integers(0, C, size=C2))]
        for (c, i), (c2, i2) in moves:
            x2[c2, i2] = x[c, i]
            ids2[c2] = ids[c]
        got = lora_matmul(x2, a, b, ids2)
        torch.cuda.synchronize()
        for (c, i), (c2, i2) in moves:
            assert torch.equal(got[c2, i2], ref[c, i]), (C2, c, i, c2, i2)


@pytest.mark.cuda
@pytest.mark.parametrize("C,qb,H,r,N", [(2, 3, 256, 8, 1024),
                                        (2, 8, 300, 8, 1024),
                                        (2, 8, 256, 8, 1000),
                                        (2, 8, 256, 12, 1024)])
def test_lora_refuses_shapes_outside_the_gate(cuda, C, qb, H, r, N):
    """K13 raises, and launches nothing, where qb % 8, H % 128, N % 128
    or r in (4, 8, 16) fails (the reference's kernel gate)."""
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul

    x = torch.zeros((C, qb, H), device=cuda, dtype=torch.bfloat16)
    a = torch.zeros((3, H, r), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros((3, r, N), device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros((C,), device=cuda, dtype=torch.int32)
    before = lora_matmul.launches
    with pytest.raises(ValueError):
        lora_matmul(x, a, b, ids)
    assert lora_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("G,d,S", [(4, 128, 2048), (2, 64, 256),
                                   (8, 256, 512)])
def test_decode_attention_int8_kernel_matches_k10_and_plain(cuda, dtype, tol,
                                                            G, d, S):
    """K10q through the public entry: equal to K10 on the cache
    dequantized beforehand (torch.equal) and within K10's tolerance of
    the plain version."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.quant import dequantize_int8

    rng = np.random.default_rng(14)
    B, nkv = 3, 2
    q = torch.from_numpy(rng.normal(size=(B, nkv * G, d)).astype(
        np.float32)).to(cuda, dtype)
    kq, vq = (_int8(rng, (B, nkv, S, d)).to(cuda) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, size=(B, nkv, S))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    kd = dequantize_int8(kq, ks[..., None], dtype)
    vd = dequantize_int8(vq, vs[..., None], dtype)
    for pos in (0, 37, 64, S - 1):
        before = da.decode_attention_int8.launches
        got = da.decode_attention(q, kq, vq, pos, d ** -0.5, k_scale=ks,
                                  v_scale=vs)
        ref = da.decode_attention_plain(q, kq, vq, pos, d ** -0.5, ks, vs)
        k10 = da.decode_attention(q, kd, vd, pos, d ** -0.5)
        torch.cuda.synchronize()
        assert da.decode_attention_int8.launches == before + 1
        assert torch.equal(got, k10), pos
        assert _scaled(got, ref) <= tol, pos


def _kernel_nodes(fn, tmp_path):
    """(kernel launches of one call of ``fn``, the graph's DOT text): the
    kernel nodes of a CUDA graph that captured the call, each a record
    whose label starts with KERNEL and names the function."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    path = tmp_path / "call.dot"
    graph.debug_dump(str(path))
    text = path.read_text()
    return text.count('label="{KERNEL'), text


def _allocations(fn):
    """(fn(), the caching allocator's allocations during it)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["allocation.all.allocated"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16])
def test_decode_attention_one_launch_at_llama1b(cuda, B, tmp_path):
    """K10 and K10q at llama1b's decode (nKV 4, G 4, S 2048, d 128, bf16)
    at every cache position check_decode_attention holds: one kernel
    launch and one allocation (the output) a call, the C launcher's plan
    decode_plan's, deterministic, K10q equal to K10 on the caches
    dequantized beforehand, both held to the plain version."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.quant import dequantize_int8

    rng = np.random.default_rng(B)
    nkv, G, S, d, dt = 4, 4, 2048, 128, torch.bfloat16
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda, dt) for s in ((B, nkv * G, d), (B, nkv, S, d), (B, nkv, S, d)))
    kq, vq = (_int8(rng, (B, nkv, S, d)).to(cuda) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, size=(B, nkv, S))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    kd, vd = (dequantize_int8(x, sc[..., None], dt)
              for x, sc in ((kq, ks), (vq, vs)))
    for pos in (0, 100, 511, 639, 2047):
        for quant in (False, True):
            assert da.decode_plan_c(B, nkv, G, S, d, pos, dt, quant) == \
                da.decode_plan(B, nkv, G, d, pos, dt, quant)
        got, n = _allocations(lambda: da.decode_attention(q, ck, cv, pos,
                                                          d ** -0.5))
        assert n == 1, pos
        assert torch.equal(got, da.decode_attention(q, ck, cv, pos,
                                                    d ** -0.5)), pos
        ref = da.decode_attention_plain(q, ck, cv, pos, d ** -0.5)
        assert _scaled(got, ref) <= 3 * 2 ** -7, pos
        got, n = _allocations(lambda: da.decode_attention(
            q, kq, vq, pos, d ** -0.5, k_scale=ks, v_scale=vs))
        assert n == 1, pos
        assert torch.equal(got, da.decode_attention(q, kd, vd, pos,
                                                    d ** -0.5)), pos
    for fn in (lambda: da.decode_attention(q, ck, cv, 639, d ** -0.5),
               lambda: da.decode_attention(q, kq, vq, 639, d ** -0.5,
                                           k_scale=ks, v_scale=vs)):
        n, text = _kernel_nodes(fn, tmp_path)
        assert n == 1 and text.count("decode_kernel") == 1, text


@pytest.mark.cuda
def test_decode_plan_c_is_decode_plan(cuda):
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    for B, nkv in ((1, 4), (16, 4), (3, 2), (100, 8)):
        for G in (1, 3, 4, 16):
            for d in (64, 128, 256):
                for pos in (0, 63, 64, 639, 4095):
                    for dt in (torch.bfloat16, torch.float32):
                        for quant in (False, True):
                            args = (B, nkv, G, d, pos, dt, quant)
                            assert da.decode_plan_c(
                                B, nkv, G, 4096, d, pos, dt, quant) == \
                                da.decode_plan(*args), args


@pytest.mark.cuda
def test_serving_engine_runs_the_int8_and_lora_kernels(cuda):
    """A small bf16 engine with int8 KV pages and LoRA on the card: K8q
    once per layer and step (K8 never), K13 twice per layer and step."""
    from paddle_tpu_torch.inference.multitenant import make_lora
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention_int8

    cfg = LlamaConfig(vocab_size=512, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=768, max_seq_len=512)
    eng = ServingEngine(cfg, max_batch=2, page_size=16, max_seq=256,
                        prefill_budget=64, kv_quant=True, lora=True,
                        device=cuda)
    eng.register_adapter("a", make_lora(cfg, 8, seed=1))
    rng = np.random.default_rng(15)
    reqs = [Request(rid=i, prompt=rng.integers(1, 512, size=40).astype(
        np.int32), max_new_tokens=6, adapter_id="a" if i else None)
        for i in range(3)]
    before = (ragged_paged_attention.launches,
              ragged_paged_attention_int8.launches, lora_matmul.launches)
    by_plan = collections.Counter(lm.LAUNCHES_BY_PLAN)
    st = eng.run(reqs)
    torch.cuda.synchronize()
    n = st["unified_steps"]
    assert all(len(r.out_tokens) == 6 for r in reqs)
    assert (ragged_paged_attention.launches - before[0],
            ragged_paged_attention_int8.launches - before[1],
            lora_matmul.launches - before[2]) == (0, 2 * n, 4 * n)
    # q (N 512) and v (N 256) deltas, both through the cluster kernel
    dt = str(cfg.dtype).replace("torch.", "")
    assert lm.LAUNCHES_BY_PLAN - by_plan == collections.Counter(
        {("cluster", dt, 512, 512, 8): 2 * n,
         ("cluster", dt, 512, 256, 8): 2 * n})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("h,d,causal", [(4, 64, True), (2, 128, True),
                                        (2, 128, False), (1, 256, True)])
def test_split_flash_backward_matches_k2_and_plain(cuda, dtype, tol, h, d,
                                                   causal):
    """K3: in its fused-qkv mode bit-equal to K2; in its separate mode
    within the tolerance of its plain version and equal to the fused mode
    on the same q, k, v packed into one qkv."""
    q, k, v, _, _ = _rope_inputs(cuda, dtype, 2, 192, h, d, seed=11)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    qkv = torch.cat([t.reshape(2, 192, h * d) for t in (q, k, v)], dim=-1)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(qkv, h, causal, scale)
    before = (fa.flash_bwd.launches, fa.flash_bwd_split.launches,
              fa.flash_bwd_sep.launches)
    k2 = fa.flash_bwd(qkv, o, lse, do, h, causal, scale)
    k3 = fa.flash_bwd_split(qkv, o, lse, do, h, causal, scale)
    sep = fa.flash_bwd_sep(q, k, v, o, lse, do, causal, scale)
    ref = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_bwd.launches, fa.flash_bwd_split.launches,
            fa.flash_bwd_sep.launches) == (before[0] + 1, before[1] + 2,
                                           before[2] + 2)
    assert torch.equal(k3, k2)
    assert torch.equal(k3, torch.cat([t.reshape(2, 192, h * d)
                                      for t in sep], dim=-1))
    for got, want in zip(sep, ref):
        assert _scaled(got, want) <= tol


@pytest.mark.cuda
def test_stochastic_round_unbiased_on_the_card(cuda):
    from paddle_tpu_torch.parallel.train_step import _stochastic_round

    x = torch.full((1 << 20,), 1.0 + 1.5e-3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    out = _stochastic_round(x, torch.bfloat16, gen).float()
    assert sorted(torch.unique(out).tolist()) == [1.0, 1.0078125]
    assert abs(out.mean().item() - (1.0 + 1.5e-3)) < 5e-4
    assert torch.equal(_stochastic_round(x, torch.float32, gen), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("h,d,causal", [(5, 64, True), (4, 64, False),
                                        (2, 128, True), (1, 256, True)])
def test_head_major_flash_equals_k1_and_k3_sep(cuda, dtype, tol, h, d,
                                               causal):
    """K17 (head-major [B, h, S, d]): bit-equal to K1-sep forward and
    K3-sep backward on the same values, and within the tolerance of its
    plain version."""
    q, k, v, _, _ = _rope_inputs(cuda, dtype, 2, 192, h, d, seed=12)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    q_, k_, v_, do_ = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    scale = d ** -0.5
    before = (fa.flash_fwd_hm.launches, fa.flash_bwd_hm.launches)
    o, lse = fa.flash_fwd_hm(q_, k_, v_, causal, scale)
    grads = fa.flash_bwd_hm(q_, k_, v_, o, lse, do_, causal, scale)
    o_sep, lse_sep = fa.flash_fwd_sep(q, k, v, causal, scale)
    sep = fa.flash_bwd_sep(q, k, v, o_sep, lse_sep, do, causal, scale)
    ref_o, _ = fa.flash_fwd_hm_plain(q_, k_, v_, causal, scale)
    ref = fa.flash_bwd_hm_plain(q_, k_, v_, o, lse, do_, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_hm.launches, fa.flash_bwd_hm.launches) == \
        (before[0] + 1, before[1] + 2)
    assert torch.equal(o.transpose(1, 2), o_sep) and torch.equal(lse,
                                                                  lse_sep)
    for a, b in zip(grads, sep):
        assert torch.equal(a.transpose(1, 2), b)
    assert _scaled(o, ref_o) <= tol
    for got, want in zip(grads, ref):
        assert _scaled(got, want) <= tol


def _paged_inputs(cuda, dtype, nkv, G, d, bs, lens, d_major, seed):
    rng = np.random.default_rng(seed)
    B, mb = len(lens), 4
    P = B * mb + 3
    q = rng.normal(size=(B, nkv * G, d)).astype(np.float32)
    k = rng.normal(size=(P, nkv, d, bs) if d_major else
                   (P, nkv, bs, d)).astype(np.float32)
    v = rng.normal(size=(P, nkv, bs, d)).astype(np.float32)
    table = rng.permutation(P)[:B * mb].reshape(B, mb).astype(np.int32)
    lens = np.minimum(np.asarray(lens), mb * bs).astype(np.int32)
    return ([torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v)]
            + [torch.from_numpy(a).to(cuda) for a in (table, lens)])


PAGED_LENS = [1, 0, 200, 10 ** 6, 129]          # 10**6: a full table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("nkv,G,d,bs", [(2, 4, 128, 128), (8, 1, 128, 128),
                                        (1, 12, 256, 128), (2, 4, 128, 256)])
def test_paged_mxu_kernel_matches_plain(cuda, dtype, tol, nkv, G, d, bs):
    """K15 over d-major pages, GQA, ragged lengths (a length-0 sequence
    among them) on a shuffled table."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    q, kt, v, table, lens = _paged_inputs(cuda, dtype, nkv, G, d, bs,
                                          PAGED_LENS, True, seed=13)
    before = da.paged_decode_attention_mxu.launches
    got = da.paged_decode_attention_mxu(q, kt, v, table, lens, d ** -0.5)
    ref = da.paged_decode_mxu_plain(q, kt, v, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_mxu.launches == before + 1
    assert _scaled(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("nh,d,bs", [(8, 64, 16), (4, 128, 128),
                                     (2, 256, 128), (4, 128, 40)])
def test_paged_token_major_kernels_match_plain(cuda, dtype, tol, nh, d, bs):
    """K14 against its plain version, K16 bit-equal to K14."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    q, k, v, table, lens = _paged_inputs(cuda, dtype, nh, 1, d, bs,
                                         PAGED_LENS, False, seed=14)
    before = (da.paged_decode_attention_kernel.launches,
              da.paged_decode_attention_dma.launches)
    k14 = da.paged_decode_attention_kernel(q, k, v, table, lens, d ** -0.5)
    k16 = da.paged_decode_attention_dma(q, k, v, table, lens, d ** -0.5)
    ref = da.paged_decode_plain(q, k, v, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert (da.paged_decode_attention_kernel.launches,
            da.paged_decode_attention_dma.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.equal(k14, k16)
    assert _scaled(k14, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("nh,d,bs", [(4, 128, 128), (2, 256, 128),
                                     (4, 64, 40), (8, 64, 16), (2, 256, 40)])
def test_paged_ring_edges(cuda, dtype, tol, nh, d, bs):
    """K14 at its ring's edges, bit-equal to K16 and held to the plain
    version: lengths ending on a stage, on the ring's last stage, inside
    a stage, 0, and a full table."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    tile, stages, _ = da.paged_ring_geometry(d, bs, dtype.itemsize)
    lens = [tile, tile * stages, tile + 3, 0, 10 ** 6, bs + 1]
    q, k, v, table, lens = _paged_inputs(cuda, dtype, nh, 1, d, bs, lens,
                                         False, seed=15)
    before = da.paged_decode_attention_kernel.launches
    k14 = da.paged_decode_attention_kernel(q, k, v, table, lens, d ** -0.5)
    k16 = da.paged_decode_attention_dma(q, k, v, table, lens, d ** -0.5)
    ref = da.paged_decode_plain(q, k, v, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_kernel.launches == before + 1
    assert torch.equal(k14, k16)
    assert _scaled(k14, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bs", [16, 64, 128])
def test_paged_dma_ring_edges(cuda, dtype, d, bs):
    """K16 at its own rings' edges (``paged_dma_plan``, whose C plan
    must be the Python one): lengths 1, 0 (every page read), ending on a
    tile, inside the second tile, on the k ring's last stage, a page and
    one (a partial last page), a full table; bit-equal to K14 and
    deterministic."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = dtype.itemsize
    plan = da.paged_dma_plan(d, bs, es)
    assert da.paged_dma_plan_c(d, bs, es) == plan
    tile, k_stages = plan[:2]
    lens = [1, 0, tile, tile + 3, tile * k_stages, bs + 1, 10 ** 6]
    q, k, v, table, lens = _paged_inputs(cuda, dtype, 4, 1, d, bs, lens,
                                         False, seed=18)
    before = da.paged_decode_attention_dma.launches
    k16 = da.paged_decode_attention_dma(q, k, v, table, lens, d ** -0.5)
    again = da.paged_decode_attention_dma(q, k, v, table, lens, d ** -0.5)
    k14 = da.paged_decode_attention_kernel(q, k, v, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_dma.launches == before + 2
    assert torch.equal(k16, k14) and torch.equal(k16, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3 * 2 ** -7)])
@pytest.mark.parametrize("nkv,G,d,bs", [(2, 4, 128, 128), (8, 1, 128, 128),
                                        (1, 12, 256, 128), (2, 3, 64, 40),
                                        (4, 2, 128, 256)])
def test_paged_mxu_ring_edges(cuda, dtype, tol, nkv, G, d, bs):
    """K15 at its ring's edges (paged_mxu_plan): lengths ending on a v
    stage, on a page, a stage into the next page, on the ring's last
    slot, 0 and a full table; the C launcher's plan paged_mxu_plan's;
    deterministic; held to the plain version."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = dtype.itemsize
    k_rows, v_rows, stages, _ = da.paged_mxu_plan(d, bs, G, es)
    assert da.paged_mxu_plan_c(d, bs, G, es) == (k_rows, v_rows, stages,
                                                 da.paged_mxu_plan(
                                                     d, bs, G, es)[3])
    lens = [v_rows, bs, bs + v_rows, stages * v_rows, 0, 10 ** 6, bs - 1]
    q, kt, v, table, lens = _paged_inputs(cuda, dtype, nkv, G, d, bs, lens,
                                          True, seed=16)
    before = da.paged_decode_attention_mxu.launches
    got = da.paged_decode_attention_mxu(q, kt, v, table, lens, d ** -0.5)
    again = da.paged_decode_attention_mxu(q, kt, v, table, lens, d ** -0.5)
    ref = da.paged_decode_mxu_plain(q, kt, v, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_mxu.launches == before + 2
    assert torch.equal(got, again)
    assert _scaled(got, ref) <= tol


PLAN_PARTS = ("fwd", "both", "dq", "dkv")


@pytest.mark.cuda
def test_flash_plan_c_is_flash_plan(cuda):
    """The C launchers' choice (flash_plan_c) is flash_plan's: variant,
    tiles, stages, shared bytes, block order and L2 chunk."""
    for S in (64, 192, 512, 1024, 8192, 8256):
        for d in (64, 128, 256):
            for dtype in (torch.bfloat16, torch.float32):
                for part in PLAN_PARTS:
                    for bh in (1, 16, 256):
                        for causal in (True, False):
                            args = (S, d, dtype, part, causal, bh)
                            assert fa.flash_plan_c(*args) == \
                                fa.flash_plan(*args), args


def _wgmma_counts():
    return {f.__name__: f.launches_wgmma for f in (
        fa.flash_fwd, fa.flash_fwd_sep, fa.flash_fwd_hm, fa.flash_bwd,
        fa.flash_bwd_split, fa.flash_bwd_sep, fa.flash_bwd_hm)}


@pytest.mark.cuda
@pytest.mark.parametrize("S,h,d,causal", [(1024, 4, 64, True),
                                          (320, 3, 128, True),
                                          (320, 2, 128, False),
                                          (2048, 16, 128, True),
                                          (1088, 5, 64, False)])
def test_wgmma_flash_bodies_agree(cuda, S, h, d, causal):
    rng = np.random.default_rng(S + h)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, S, h, d)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(4))
    qkv = torch.cat([t.reshape(2, S, h * d) for t in (q, k, v)], dim=-1)
    scale, tol = d ** -0.5, 3 * 2 ** -7
    before = _wgmma_counts()
    o, lse = fa.flash_fwd(qkv, h, causal, scale)
    o_sep, lse_sep = fa.flash_fwd_sep(q, k, v, causal, scale)
    q_, k_, v_, do_ = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    o_hm, lse_hm = fa.flash_fwd_hm(q_, k_, v_, causal, scale)
    k2 = fa.flash_bwd(qkv, o, lse, do, h, causal, scale)
    k3 = fa.flash_bwd_split(qkv, o, lse, do, h, causal, scale)
    k3_again = fa.flash_bwd_split(qkv, o, lse, do, h, causal, scale)
    sep = fa.flash_bwd_sep(q, k, v, o, lse, do, causal, scale)
    hm = fa.flash_bwd_hm(q_, k_, v_, o_hm, lse_hm, do_, causal, scale)
    ro, rlse = fa.flash_sep_plain(q, k, v, causal, scale)
    ref = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    after = _wgmma_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 1, "flash_fwd_sep": 1, "flash_fwd_hm": 1,
        "flash_bwd": 1, "flash_bwd_split": 4, "flash_bwd_sep": 2,
        "flash_bwd_hm": 2}
    assert torch.equal(o, o_sep) and torch.equal(lse, lse_sep)
    assert torch.equal(o_hm.transpose(1, 2), o_sep)
    assert torch.equal(lse_hm, lse_sep)
    assert _scaled(o, ro) <= tol and _scaled(lse, rlse) <= 1e-4
    assert torch.equal(k3, k2) and torch.equal(k3, k3_again)
    assert torch.equal(k3, torch.cat([t.reshape(2, S, h * d) for t in sep],
                                     dim=-1))
    for a, b, want in zip(hm, sep, ref):
        assert torch.equal(a.transpose(1, 2), b)
        assert _scaled(b, want) <= tol
    assert all(int(buf.abs().sum()) == 0 for buf in fa._SCHED.values())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [320, 1024])
@pytest.mark.parametrize("rope_k", [False, True])
def test_rope_flash_wgmma_at_several_row_blocks(cuda, S, rope_k):
    """K11 (the producer warpgroup rotates q, and k under rope_k, in the
    swizzled tiles) equals K1-sep on apply_rope'd inputs bit for bit at
    several row blocks per (batch, head), and holds its plain version."""
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    q, k, v, cos, sin = _rope_inputs(cuda, torch.bfloat16, 2, S, 4, 128,
                                     seed=S)
    before = fra.rope_flash_fwd.launches_wgmma
    got = fra.rope_flash_fwd(q, k, v, cos, sin, True, 128 ** -0.5, True,
                             rope_k)[0]
    cb, sb = cos[None, :, None, :], sin[None, :, None, :]
    kr = fra._apply_rope_ref(k, cb, sb) if rope_k else k
    k1 = fa.flash_fwd_sep(fra._apply_rope_ref(q, cb, sb), kr, v, True,
                          128 ** -0.5)[0]
    ref = fra.rope_flash_plain(q, k, v, cos, sin, True, 128 ** -0.5, True,
                               rope_k)[0]
    torch.cuda.synchronize()
    assert fra.rope_flash_fwd.launches_wgmma == before + 1
    assert torch.equal(got, k1)
    assert _scaled(got, ref) <= 3 * 2 ** -7


@pytest.mark.cuda
def test_sched_scratch_by_stream_and_capture(cuda):
    """The persistent forward's scheduling scratch: one buffer a stream,
    reused on it and left zero by each launch; a launch that a CUDA graph
    captures owns a slot of its own, and the graph's replays give the
    eager launch's bits while an eager launch on another stream runs."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 1024, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(3))
    want = fa.flash_fwd_sep(q, k, v, True, 0.125)[0]
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda)
    default = torch.cuda.default_stream(cuda).cuda_stream
    assert fa.sched_scratch(q, side.cuda_stream) is \
        fa.sched_scratch(q, side.cuda_stream)
    assert fa.sched_scratch(q, side.cuda_stream) is not \
        fa.sched_scratch(q, default)
    graph, out = torch.cuda.CUDAGraph(), None
    used = fa._CAPTURED[q.device][1]
    with torch.cuda.graph(graph):
        out = fa.flash_fwd_sep(q, k, v, True, 0.125)[0]
    assert fa._CAPTURED[q.device][1] == used + 1
    for _ in range(3):
        graph.replay()
        with torch.cuda.stream(side):
            other = fa.flash_fwd_sep(q, k, v, True, 0.125)[0]
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(other, want)
    assert all(int(buf.abs().sum()) == 0 for buf in fa._SCHED.values())
    assert all(int(slots.abs().sum()) == 0
               for slots, _ in fa._CAPTURED.values())


def _wire_engine(cuda, dtype, **kw):
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=512, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=768, max_seq_len=512,
                      dtype=dtype, param_dtype=dtype)
    params = kw.pop("params", None)
    eng = ServingEngine(cfg, params=params, max_batch=2, page_size=16,
                        max_seq=256, prefill_budget=64, device=cuda, **kw)
    return eng


def _same_shipment(a, b) -> None:
    for k in ("hashes", "crc", "dtype", "geom", "quant_mode"):
        assert a[k] == b[k], k
    for k in ("k", "v", "k_scales", "v_scales"):
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_staged_export_equals_sync_export_with_a_step_in_flight(cuda,
                                                                kv_quant):
    """The overlapped wire's export on the card: staged while a step is
    in flight (gather on the engine's stream, copy on a side stream into
    pinned memory) it ships the synchronous export's bytes and crcs; and
    writes to the pages enqueued right after the staging (a reused page)
    do not reach the staged copy."""
    from paddle_tpu_torch.inference.serving import Request

    eng = _wire_engine(cuda, torch.bfloat16, kv_quant=kv_quant,
                       wire_overlap=True)
    req = Request(rid=0, prompt=np.arange(1, 41, dtype=np.int32),
                  max_new_tokens=16)
    eng.submit(req)
    while len(req.out_tokens) < 3:
        eng.step(now=1e18)
    eng.step(now=1e18)
    assert eng._inflight is not None
    staged = eng.stage_request_pages(0)
    assert staged["staged"] and staged["k"].is_pinned()
    sync = eng.export_request_pages(0)
    _same_shipment(eng.finalize_shipment(staged), sync)
    pages = torch.as_tensor(eng._full_rows[0][:len(sync["hashes"])],
                            dtype=torch.long, device=cuda)
    staged = eng.stage_request_pages(0)
    for arr in (eng.k_pages, eng.v_pages):
        arr.index_fill_(1, pages, 0)
    _same_shipment(eng.finalize_shipment(staged), sync)
    assert not bool(eng.k_pages[:, pages].any())


@pytest.mark.cuda
def test_deferred_commit_lands_before_the_next_step_reads(cuda):
    """An adoption on the overlapped wire publishes the pages at once and
    writes their bytes at the next dispatch, before that step's kernels:
    the step that admits a request sharing the prefix attends the
    adopted bytes, the pages equal the shipment's, and the stream is the
    donor's own."""
    from paddle_tpu_torch.inference.serving import Request

    donor = _wire_engine(cuda, torch.float32)
    prompt = np.random.default_rng(3).integers(1, 512, size=40).astype(
        np.int32)
    ref = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    donor.submit(ref)
    while len(ref.out_tokens) < 1:
        donor.step(now=1e18)
    ship = donor.export_request_pages(0)
    while donor.step(now=1e18):
        pass
    recv = _wire_engine(cuda, torch.float32, params=donor.params,
                        wire_overlap=True)
    assert recv.adopt_pages(ship) == 2 and len(recv._commit_pending) == 1
    pages = [recv.pool.cache[h] for h in ship["hashes"]]
    assert not bool(recv.k_pages[:, pages].any())      # not yet written
    req = Request(rid=1, prompt=prompt.copy(), max_new_tokens=8)
    recv.submit(req)
    recv.step(now=1e18)
    assert not recv._commit_pending
    assert recv.stats["prefill_cached_tokens"] == 32
    for j, p in enumerate(pages):
        assert recv.k_pages[:, p].cpu().numpy().tobytes() == \
            ship["k"][j].tobytes()
        assert recv.v_pages[:, p].cpu().numpy().tobytes() == \
            ship["v"][j].tobytes()
    while recv.step(now=1e18):
        pass
    assert req.out_tokens == ref.out_tokens
