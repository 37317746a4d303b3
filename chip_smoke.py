"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card

Phases, each failing loudly (any failure exits nonzero):

1. ``kernels``: build every CUDA kernel from ``paddle_tpu_torch/csrc/``,
   hold each against its plain PyTorch version at the shapes the serving
   main path gives it (llama3-8b), and time kernel, plain version and the
   nearest single PyTorch library call. K8 in bf16 through its split /
   TMA ring / wgmma variant (the C launcher's plan ``rpa_plan_c`` equal to
   ``rpa_plan``), eager and device (CUDA graph) times beside SDPA's, a
   digest of its output, and row independence at mb 16 and 32: the same
   query rows carried by decode, 4-row verify and 16-row prefill chunks
   at every offset, on page and split edges, are bit-equal.
2. ``engine``: ``ServingEngine(llama_presets("llama3-8b"))`` at full
   width with random bf16 weights drawn on the card from a seed, serving
   eight requests (half share a 256-token prefix, greedy and sampled);
   the attention kernel's launch count must equal layers x steps.
3. ``int8``: the same traffic through the weight-only int8 engine; the
   int8 matmul kernel's launch count must equal (7 x layers + 1) x steps,
   every one through its TMA + wgmma variant.
4. ``cpu``: a small fp32 config (head dim 128) on the card and on the
   CPU with identical weights; greedy streams must be equal except where
   the CPU's top-2 logit margin is under 1e-4.
5. ``train_kernels``: the training kernels against their plain versions:
   flash attention forward (K1) and backward (K2) at the gpt3-350m
   attention shape and a small fp32 case at head dim 64 and 128 (K2 run
   twice, bitwise equal), and the vocab-streaming cross-entropy forward
   (K4) and backward (K5) at the gpt3-350m loss shape and a small case
   with ragged tiles in fp32 and bf16 (every bf16 product through the
   TMA + wgmma route as the C entries report it, the C launchers' plan
   ``ce_plan_c`` equal to ``ce_plan``); kernel (eager and in a CUDA
   graph), plain, the bf16 cuBLAS products they compute and library
   times beside the bound. Outputs are held element by element (see
   ``_scaled_err``), and dhead also on the vocab columns no token has as
   its label, where dl is the softmax part alone. Then the residual +
   bias + norm epilogue (K6) at the gpt3-350m norm shape in its layer
   forms (residual + bias, norm-only, with the gelu), the rms form at
   H 4096 and small fp32 cases, r bit-equal and y by row; and the bias +
   gelu (K7) at the gpt3-350m FFN shape and a small fp32 case (its 2-D
   walk the C launcher's, ``bias_gelu_plan_c`` equal to
   ``bias_gelu_plan``; the first 256 rows alone bit-equal to those rows
   of the whole call; eager and device times beside F.gelu's). The split
   flash backward (K3): in its fused-qkv mode at gpt3-1.3b's S 8192
   shape (B 1, h 16, d 128, bf16) bit-equal to K2 and timed beside it,
   at S 2048 against its plain version; in its separate mode at
   llama1b's training shape (B 2, S 2048, h 16, d 128) against its
   plain version and bit-equal to the fused mode on the same values;
   small fp32 cases at head dims 64, 128 and 256, causal and not; K3's
   (and K2's) device time in a CUDA graph beside the eager one. The
   head-major flash (K17, forward and split backward on [B, h, S, d]):
   bit-equal to K1-sep and K3-sep on the same values and held against
   its plain version at gpt3-350m's attention (B 16, S 1024, h 16, d 64,
   bf16; timed beside SDPA on the same head-major operands), at h 5
   (odd heads, d 64) and in small fp32 cases.
6. ``train``: ``make_train_step(gpt3-350m)`` at full width (24 layers,
   B 16, S 1024, bf16 moments, fp32 masters) on random weights drawn on
   the card, with the fusion compiler on (its default), 3 warm-up steps
   and the best of 3 windows of 4 steps; the loss must start near ln(V)
   and fall, K1/K2 must launch 24 times per step, K4/K5 once per step (2
   launches and 3 per 8192-column vocab slab, 21; every one of their
   1 + 3 x 7 bf16 products a step through the wgmma route, and the C
   launchers' plan ``ce_plan``'s), K6 2L + 1 = 49 times
   and K7 24 times, and the fusion report must list 49 applied
   ``layer_epilogue`` and 24 applied ``bias_gelu`` sites and no error.
   The same step then runs with ``use_auto_fusion`` off, and its step
   time and peak memory are printed beside the fused step's; and a third
   time, fusion on, under ``FLAGS_flash_attention_native_layout=0``: K17
   forward 24 and dq + dk/dv 48 launches a step, no K1/K2, its first
   loss (same weights and batch) within rtol 1e-3 of the native step's.
7. ``train_cpu``: a small fp32 GPT trained 3 steps on the card and on the
   CPU from identical weights, fusion on for both; losses within rtol
   1e-4 and parameters within atol 1e-4 (TF32 off), every training kernel
   launched on the card: without remat, under remat=True and "full", and
   with flash_attention_fused_dqkv off (K3, never K2); then a small fp32
   LLaMA (head dim 128, G 2): llama_loss and its gradients on the card
   (K11, K3, K6, K12) against the CPU, by row within 1e-4.
7a. ``train_13b``: ``make_train_step(gpt3-1.3b)`` at full width (24
   layers, hidden 2048, vocab 50304), bf16 moments, weights="sr-bf16"
   (no master; the SR function's unbiasedness checked on the card
   first), fusion on, random weights drawn on the card, at bench.py's
   three configurations: B 4 S 1024 remat=True, B 1 S 4096 remat=True,
   B 1 S 8192 remat="full"; 3 warm-up steps, best of 3 windows. The loss
   starts within 0.5 of ln(V) and falls; per step K1 launches L = 24
   times (both policies save the flash o/lse), K2 L at S 1024 and 4096,
   K3 2L at S 8192 (the 6 MiB gate), K6 4L + 1 and K7 2L (recomputed in
   the backward), K4/K5's products all through wgmma; at S 4096 the
   peak memory of the forward + backward falls from remat False to True
   to "full" (the whole step's peak is printed beside it). Prints
   bench.py's gpt3_1p3b_* keys (MFU against 989 TFLOP/s) and the peaks
   on one line.
7b. ``llama_train``: gradients of llama_loss at llama1b (16 layers,
   bf16), B 2, S 2048, remat=True: fusion on (K11 L times in the forward,
   K11 L again and K3 2L in the backward, no K2) and off (K1-sep and K3);
   finite loss and gradients; both routes' gradients against fp32 ones
   (weights cast up, fusion off), the fused route's mean relative error
   within 1.1x the unfused one's; forward and backward ms and peak
   memory printed.
8. ``decode_kernels``: the LLaMA engine's kernels against their plain
   versions at the llama1b shapes: dense GQA decode attention (K10) at
   B 1, 8, 16 and five cache positions (one allocation a call, the
   output; the C launcher's cluster plan ``decode_plan``'s; eager and
   CUDA-graph device times beside SDPA's), flash with RoPE in the tile (K11,
   bit-equal to K1 on apply_rope'd inputs; device times in a CUDA graph,
   beside SDPA on rotated q/k and apply_rope + SDPA, the composition K11
   replaces), K1's separate-input mode and
   swiglu (K12, also at llama3-8b's width), each with kernel, plain,
   library time and bound; and K6 in the rms form at the prefill's rows
   and width (residual and norm-only, r bit-equal, y by row).
9. ``decode``: ``LlamaForCausalLM`` at llama1b (vocab 32000, hidden 2048,
   16 layers, 16 heads, 4 kv heads, ffn 5504; random bf16 weights drawn
   on the card from seed 0) on the reference bench's decode protocol:
   512-token prompts, prefill ms and decode tokens/s at B 1, 8 and 16
   (128 new tokens, greedy), a sampled run, the weight-only int8 engine
   at B 8, the fusion-off engine at B 1 against the fused one by teacher
   forcing (the fused greedy stream fed to the fused, the unfused and an
   fp32 engine; every step's logits of each bf16 engine held to the fp32
   one's, the fused one's mean error within 1.1x the unfused one's), a
   profiled decode window, and llama3-8b at B 1. Per generate K10
   launches L x (new - 1), K11 and K12 L and K6 2L + 1 (the prefill's
   fusion report: 2L + 1 rms_epilogue, L rope_attention, L swiglu
   applied, no error), K9 (7L + 1) x new with int8 weights.
10. ``decode_cpu``: a small fp32 LLaMA (head dim 128, G 2) generating on
   the card and on the CPU from identical weights, fusion on; greedy
   streams equal except where the CPU's top-2 margin is under 1e-4.
11. ``serving_kernels``: the serving engine's int8, speculative and
   multi-tenant kernels against their plain versions: K8q (int8 pages,
   the wgmma variant in bf16, device times, a digest, row independence)
   at the llama3-8b step's attention shapes in bf16 and fp32 and K10q
   (int8 dense cache) at K10's shapes, each bit-equal to its fp kernel on
   the inputs dequantized beforehand; K13 (grouped LoRA BGMV: a cluster
   a packed row, the shrink split over H) at the step's q and v
   projections, within 1e-5 of its fp32 plain version, slot-0 rows
   exactly 0, a row's bits the same at other (c, i) in calls of other C,
   its C plan ``lora_plan``'s; kernel, plain, library time and bound
   (K13 and K10q also on the device, K10q one allocation a call).
12. ``serving``: llama3-8b serving (random bf16 weights from seed 0):
   (a) int8 KV pages against bf16 (K8q L per step, 65552 KV bytes per
   token); (b) speculative decode, k 3, with the n-gram proposer and with
   drafts known to be right or wrong, streams held to the
   non-speculative engine's; (c) two LoRA adapters, priorities and a
   schema-constrained request on a tight pool (K13 2L per step, every
   launch through the cluster kernel at ``lora_plan_c == lora_plan``, a
   preemption, the ledger summed after every step, no-adapter streams
   held to the LoRA-off engine's); (d) card against CPU, small fp32, int8
   KV with the multi-tenant axes and with speculation; (e) the public
   int8 decode entry (K10q). Streams are held by ``_serving_streams_agree``:
   equal, except from a token the reference engine's own logits hold
   within 1e-4 of the other pick.
13. ``paged_kernels``: the incubate paged decode's kernels against their
   plain versions: K15 (d-major k pages, GQA native; p rounded to bf16 as
   the kernel does) at llama2-7b's width (32 heads of 128, page 128, 16
   blocks) and llama3-8b's GQA (8 kv heads, 4 q heads each), K14
   (token-major pages) and K16 (warp-specialised, bit-equal to K14),
   with ragged lengths (1, mid-page, a full table, 0) on a shuffled
   table, bf16 and fp32, K16 also at its rings' edges (d 64 / 128 / 256,
   pages of 16 / 64 / 128); the C ring plans ``paged_mxu_plan``'s and
   ``paged_dma_plan``'s; kernel and SDPA on
   pre-gathered pages, eager and on the device, plain and the bound (the
   valid tokens' k and v, q and o) at the paged phase's last step.
14. ``paged``: ``block_multihead_attention`` at llama2-7b's attention
   width: 32 PagedKVCaches (bf16, page 128, 2048 tokens, B 8), a
   1024-token prefill (K1-sep 32 times) and 64 decode steps on d-major
   pages (K15 32 times a step), then on token-major pages (K14 32 times
   a step); layer 0 of every 16th step and every layer of the last held
   against the plain version; K16 on the token-major caches, bit-equal to
   K14; a GQA pass at llama3-8b's width through paged_decode_attention
   (K15); a small fp32 cache on the card against the CPU.

After each of the phases train, train_13b, llama_train, decode and paged
every bf16 flash launch at head dim 64 or 128 must have taken the TMA +
wgmma variant, as the C launchers report what they launched
(``flash_attention.LAUNCHES_BY_PLAN``), and at every shape launched the
C launchers' plan must be ``flash_plan``'s. After each of the phases
engine and int8, cpu and serving every K8 / K8q launch must have taken
its plan's variant, every bf16 one at head dim 128 the split / TMA ring /
wgmma one (``ragged_paged_attention.LAUNCHES_BY_PLAN``), and at every
shape launched ``rpa_plan_c`` must equal ``rpa_plan``.

Prints the card's name and power limit, one JSON line ``{"kernels": ...}``
and, last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("kernels", "engine", "int8", "cpu", "train_kernels", "train",
          "train_cpu", "train_13b", "llama_train", "decode_kernels",
          "decode", "decode_cpu", "serving_kernels", "serving",
          "paged_kernels", "paged")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores (K6, K7)
RPA_BF16_ATOL = 2e-2             # bf16 output; plain rounds p/l to bf16
RPA_FP32_ATOL = 1e-4             # fp32 inputs, TF32 off, sum order only
QMM_ATOL = 1e-3                  # fp32 accumulators, sum order only
MARGIN = 1e-4                    # CPU top-2 logit margin of a tie
# training kernels: each element's error over the larger of its own
# magnitude and the RMS of its row (head row of o / dqkv, token row of dx,
# vocab column of dhead), see _scaled_err
BF16_TOL = 3 * 2 ** -7           # 3 bf16 ulps (an ulp is <= 2^-7 of a value):
                                 # each side's output rounding, and p or dl
                                 # rounded against another running max
ZERO_ROW = 1e-3                  # rows under this share of the tensor's RMS
                                 # are rounding noise of an exact 0 (dq of
                                 # query 0: ds = p (dp - delta) = 0)
FP32_TOL = 1e-4                  # fp32 inputs, TF32 off, sum order only
CE_FWD_ATOL = 1e-3               # fp32 nll / lse from bf16 operands
CE_LOGIT_STD = 3.0               # x ~ N(0, 1), wte ~ N(0, 9 / H): the top
                                 # probability of a row is ~0.1, not ~1 / V
TRAIN_CPU_RTOL = 1e-4            # card vs CPU losses, fp32
TRAIN_CPU_ATOL = 1e-4            # card vs CPU parameters after 3 steps


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so that the host's share (the wrapper, the launch)
    drops out of the reading."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5, warmup=1) / iters


def _bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# phases whose every bf16 flash launch at head dim 64 or 128 must take the
# TMA + wgmma variant (flash_attention.flash_plan)
FLASH_WGMMA_PHASES = ("train", "train_13b", "llama_train", "decode", "paged")


def _flash_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return collections.Counter(fa.LAUNCHES_BY_PLAN)


def _check_flash_variants(tag: str, before: collections.Counter) -> None:
    """The flash launches since ``before``, by (variant as the C launcher
    reported it, dtype, head dim, S, part, (batch, head) pairs): every
    bf16 one at head dim 64 or 128 took "wgmma", at least one did, and at
    every shape launched the C launchers' plan (``flash_plan_c``) is
    flash_plan's."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    diff = fa.LAUNCHES_BY_PLAN - before
    for (variant, dt, d, S, part, bh), n in sorted(diff.items()):
        dtype = getattr(torch, dt)
        plan = fa.flash_plan(S, d, dtype, part, bh=bh)
        if fa.flash_plan_c(S, d, dtype, part, bh=bh) != plan:
            raise AssertionError(f"{tag}: flash_plan_c {S} {d} {dt} {part} "
                                 f"!= flash_plan {plan}")
        if dt == "bfloat16" and d in (64, 128) and variant != "wgmma":
            raise AssertionError(f"{tag}: {n} bf16 d{d} flash {part} "
                                 f"launches took {variant}")
    wg = sum(n for key, n in diff.items() if key[0] == "wgmma")
    print(f"{tag}: flash launches by (variant, dtype, d, S, part, bh): "
          + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items())))
    if wg == 0:
        raise AssertionError(f"{tag}: no flash launch took the wgmma variant")


RPA_SHAPE = (32, 16, 32, 8, 128, 128, 16, 129)  # C qb nH nKV d bs mb P
# phases whose every bf16 d 128 K8 / K8q launch must take the split / TMA
# ring / wgmma variant (ragged_paged_attention.rpa_plan)
RPA_WGMMA_PHASES = ("engine/int8", "cpu", "serving")


def _rpa_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return collections.Counter(rpa.LAUNCHES_BY_PLAN)


def _check_rpa_variants(tag: str, before: collections.Counter) -> None:
    """The K8 / K8q launches since ``before``, by (variant as the C entry
    reported it, dtype, d, bs, mb, G, qb, int8 pages): each took its
    plan's variant, every bf16 one at head dim 128 "wgmma", at least one
    launched, and at every shape launched the C launcher's plan
    (``rpa_plan_c``) is ``rpa_plan``'s."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    diff = rpa.LAUNCHES_BY_PLAN - before
    if not diff:
        raise AssertionError(f"{tag}: no K8 / K8q launch")
    clusters = []
    for (variant, dt, d, bs, mb, G, qb, quant), n in sorted(diff.items()):
        dtype = getattr(torch, dt)
        plan = rpa.rpa_plan(mb, bs, d, G, qb, dtype, quant)
        plan_c = rpa.rpa_plan_c(mb, bs, d, G, qb, dtype, quant)
        if {k: plan_c[k] for k in plan} != plan:
            raise AssertionError(f"{tag}: rpa_plan_c {plan_c} != rpa_plan "
                                 f"{plan} at mb {mb} bs {bs} d {d} {dt}")
        if variant != plan["variant"] or (dt == "bfloat16" and d == 128
                                          and variant != "wgmma"):
            raise AssertionError(f"{tag}: {n} {dt} d{d} K8 launches took "
                                 f"{variant}, plan {plan['variant']}")
        clusters.append(plan_c["clusters"])
    print(f"{tag}: K8/K8q launches by (variant, dtype, d, bs, mb, G, qb, "
          "int8): " + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items()))
          + f"; clusters the card holds at once (wgmma) {clusters}")


def _rpa_rows(dev):
    """The llama3-8b engine step's attention rows: decode rows, page-
    straddling prefill chunks, partial chunks and idle sink rows. Returns
    (rows, pos0, n_valid) on ``dev``, the number of pages the chunks
    reach (a page shared by chunks counted once) and the flops of the
    valid query rows' dots over their causal keys."""
    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    rng = np.random.RandomState(1)
    rows = np.zeros((C, mb), np.int32)
    pos0 = np.zeros((C,), np.int32)
    nval = np.ones((C,), np.int32)
    for c in range(24):
        rows[c] = rng.permutation(np.arange(1, P))[:mb]
        if c < 8:                                  # decode rows
            pos0[c], nval[c] = rng.randint(0, mb * bs), 1
        elif c < 20:                               # prefill chunks
            pos0[c] = 120 + 128 * (c - 8) % 1900   # straddle pages
            nval[c] = qb
        else:                                      # partial chunks
            pos0[c], nval[c] = rng.randint(0, 1500), rng.randint(2, qb)
    # rows 24.. stay idle against the sink page: pos0 0, n_valid 1
    pages = set()
    flops = 0.0
    for c in range(C):
        last = pos0[c] + nval[c] - 1
        pages.update(int(p) for p in rows[c, :last // bs + 1])
        for i in range(nval[c]):
            flops += 4.0 * nH * d * (pos0[c] + i + 1)
    return (tuple(torch.from_numpy(a).to(dev) for a in (rows, pos0, nval)),
            len(pages), flops)


def _sdpa_on_pages(q, kp, vp, rows_t, pos_t, nv_t, scale):
    """The library yardstick of K8 and K8q: SDPA over the pre-gathered
    pages (GQA expanded) with the engine's mask; a timing closure."""
    C, qb, nH, d = q.shape
    nKV, bs, mb = kp.shape[1], kp.shape[3], rows_t.shape[1]
    dev = q.device
    idx = rows_t.long()
    kg = kp[idx].permute(0, 2, 1, 4, 3).reshape(C, nKV, mb * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(C, nKV, mb * bs, d)
    kg = kg.repeat_interleave(nH // nKV, dim=1)
    vg = vg.repeat_interleave(nH // nKV, dim=1)
    qh = q.transpose(1, 2)
    qpos = pos_t[:, None] + torch.minimum(
        torch.arange(qb, device=dev)[None, :], nv_t[:, None] - 1)
    mask = (torch.arange(mb * bs, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale)


# query positions the row-independence holds put on tile (64) and page
# (128) edges and on split edges (1024 keys a split at mb 16 and 32)
RPA_EDGE_POS = (0, 1, 63, 64, 127, 128, 129, 255, 256, 511, 512, 1023, 1024,
                1025, 1500, 2047, 2048, 3071, 3072, 4095)


def _digest(*ts) -> str:
    """A short digest of tensors' bits, to compare two checkouts' output."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _rpa_row_independence(dev, mb: int, quant: bool, seed: int) -> int:
    """K8 (K8q with ``quant``) at llama3-8b's attention width (nH 32, nKV
    8, d 128, bs 128, qb 16, bf16): the same query rows carried by a
    decode chunk (n_valid 1), a verify chunk of 4 rows and a 16-row
    prefill chunk, at every offset of those chunks, for positions on page
    and split edges (``RPA_EDGE_POS``), beside filler chunks (decode rows
    of other requests, idle sink rows), spread over calls of different C.
    Every carried row must be torch.equal to the decode chunk's. Returns
    the rows held."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    nH, nKV, d, bs, qb = 32, 8, 128, 128, 16
    S = mb * bs
    P = mb + 9
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16
    q_all = torch.randn((S, nH, d), generator=gen, device=dev).to(bf)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8)
                  for shape in ((P, nKV, d, bs), (P, nKV, bs, d)))
        sc = [torch.rand((P, nKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2)]
    else:
        kp = torch.randn((P, nKV, d, bs), generator=gen, device=dev).to(bf)
        vp = torch.randn((P, nKV, bs, d), generator=gen, device=dev).to(bf)
        sc = [None, None]
    table = np.asarray(rng.permutation(np.arange(1, P))[:mb], np.int32)
    carriers = [(p, nv, o) for p in RPA_EDGE_POS if p < S
                for nv in (1, 4, 16) for o in range(nv)
                if p - o >= 0 and p - o + nv <= S]
    order = rng.permutation(len(carriers))
    got = {}
    i, call, sizes = 0, 0, (37, 64, 5, 61, 23, 64, 48)
    while i < len(order):
        n = min(sizes[call % len(sizes)], len(order) - i)
        call += 1
        fill = rng.randint(0, 4)
        C = n + fill
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(bf)
        rows = np.zeros((C, mb), np.int32)
        pos0 = np.zeros(C, np.int32)
        nval = np.ones(C, np.int32)
        slots = rng.permutation(C)
        mine = []
        for k, idx in enumerate(order[i:i + n]):
            p, nv, o = carriers[idx]
            c = int(slots[k])
            rows[c], pos0[c], nval[c] = table, p - o, nv
            q[c, :nv] = q_all[p - o:p - o + nv]
            mine.append((c, carriers[idx]))
        for c in slots[n:]:
            if rng.rand() < 0.5:             # another request's decode row
                rows[c] = rng.randint(1, P, size=mb)
                pos0[c] = rng.randint(0, S)
            # else idle against the sink page: pos0 0, n_valid 1
        out = rpa.ragged_paged_attention(
            q, kp, vp, *(torch.from_numpy(a).to(dev)
                         for a in (rows, pos0, nval)), d ** -0.5,
            k_scales=sc[0], v_scales=sc[1])
        for c, (p, nv, o) in mine:
            got[(p, nv, o)] = out[c, o]
        i += n
    held = 0
    for (p, nv, o), row in got.items():
        ref = got[(p, 1, 0)]
        if not torch.equal(row, ref):
            n_diff = (row != ref).sum().item()
            raise AssertionError(
                f"K8{'q' if quant else ''} mb {mb}: position {p} carried at "
                f"offset {o} of a {nv}-row chunk differs from the decode "
                f"chunk's row in {n_diff} elements")
        held += 1
    return held


def check_rpa(dev) -> dict:
    """K8 at the llama3-8b attention shapes (``_rpa_rows``): fp32 (the FMA
    kernel) and bf16 (the split / TMA ring / wgmma kernel, whose C plan
    must be ``rpa_plan``'s) against the plain version; eager and device
    (CUDA graph) times beside SDPA on pre-gathered pages; a digest of the
    bf16 output; row independence at mb 16 and 32."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    (rows_t, pos_t, nv_t), n_pages, flops = _rpa_rows(dev)
    scale = 1.0 / math.sqrt(d)
    errs = {}
    for dt, tol in ((torch.float32, RPA_FP32_ATOL),
                    (torch.bfloat16, RPA_BF16_ATOL)):
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(dt)
        kp = torch.randn((P, nKV, d, bs), generator=gen, device=dev).to(dt)
        vp = torch.randn((P, nKV, bs, d), generator=gen, device=dev).to(dt)
        before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
        got = rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t, nv_t,
                                         scale)
        ref = rpa.ragged_paged_attention_plain(q, kp, vp, rows_t, pos_t,
                                               nv_t, scale)
        torch.cuda.synchronize()
        _check_rpa_variants(f"rpa {dt}", before)
        valid = (torch.arange(qb, device=dev)[None, :] < nv_t[:, None])
        err = (got.float() - ref.float()).abs()[valid].max().item()
        print(f"rpa {dt}: max_abs_err {err:.3e} (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"rpa {dt}: max_abs_err {err} > {tol}")
        errs[dt] = err
    print(f"rpa bf16 output digest {_digest(got)}")
    fn = lambda: rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t, nv_t,
                                            scale)
    ms, graph_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: rpa.ragged_paged_attention_plain(
        q, kp, vp, rows_t, pos_t, nv_t, scale))
    sdpa = _sdpa_on_pages(q, kp, vp, rows_t, pos_t, nv_t, scale)
    library_ms, graph_library_ms = _time_ms(sdpa), _graph_ms(sdpa)
    # what these inputs need: q and o once, every page a chunk reaches
    # once (pages shared between chunks counted once), and the dots of
    # the valid query rows over their causal keys
    nbytes = (2 * q.numel() * 2 + n_pages * 2 * nKV * bs * d * 2
              + (rows_t.numel() + 2 * C) * 4)
    bound_ms, bound_by = _bound(nbytes, flops)
    held = sum(_rpa_row_independence(dev, m, False, 30 + m)
               for m in (16, 32))
    print(f"rpa bf16: row independence: {held} carried rows bit-equal to "
          "their decode chunk's (mb 16 and 32)")
    print(f"rpa bf16: kernel {ms:.4f} ms (device {graph_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (device "
          f"{graph_library_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:85",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32":
            errs[torch.float32], "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "graph_library_ms": graph_library_ms,
            "shape": f"C{C} qb{qb} nH{nH} nKV{nKV} d{d} bs{bs} mb{mb}"}


def check_rpa_int8(dev) -> dict:
    """K8q at the llama3-8b attention shapes (``_rpa_rows``), int8 pages
    with [P, nKV] fp32 scales, bf16 (the wgmma kernel, int8 boxes through
    its ring) and fp32 q (FMA kernel): equal to K8 on the pre-dequantized
    pages (torch.equal: the dequantized tiles are the same bits, so any
    difference is the dequant), and within K8's tolerance of the plain
    version; eager and device times, a digest, row independence at mb
    16."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.quant import dequantize_int8

    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(21)
    (rows_t, pos_t, nv_t), n_pages, flops = _rpa_rows(dev)
    scale = 1.0 / math.sqrt(d)
    kq, vq = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8)
              for shape in ((P, nKV, d, bs), (P, nKV, bs, d)))
    ks, vs = (torch.rand((P, nKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2))
    valid = (torch.arange(qb, device=dev)[None, :] < nv_t[:, None])
    errs = {}
    for dt, tol in ((torch.float32, RPA_FP32_ATOL),
                    (torch.bfloat16, RPA_BF16_ATOL)):
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(dt)
        kd = dequantize_int8(kq, ks[:, :, None, None], dt)
        vd = dequantize_int8(vq, vs[:, :, None, None], dt)
        before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
        got = rpa.ragged_paged_attention_int8(q, kq, vq, ks, vs, rows_t,
                                              pos_t, nv_t, scale)
        torch.cuda.synchronize()
        _check_rpa_variants(f"K8q {dt}", before)
        k8 = rpa.ragged_paged_attention(q, kd, vd, rows_t, pos_t, nv_t,
                                        scale)
        ref = rpa.ragged_paged_attention_plain(q, kq, vq, rows_t, pos_t,
                                               nv_t, scale, ks, vs)
        torch.cuda.synchronize()
        if not torch.equal(got, k8):
            n = (got != k8).sum().item()
            raise AssertionError(f"K8q {dt}: {n} elements differ from K8 "
                                 "on the pre-dequantized pages")
        err = (got.float() - ref.float()).abs()[valid].max().item()
        print(f"K8q {dt}: equal to K8 on dequantized pages; max_abs_err "
              f"{err:.3e} against plain (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"K8q {dt}: max_abs_err {err} > {tol}")
        errs[dt] = err
    print(f"K8q bf16 output digest {_digest(got)}")
    fn = lambda: rpa.ragged_paged_attention_int8(q, kq, vq, ks, vs, rows_t,
                                                 pos_t, nv_t, scale)
    ms, graph_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: rpa.ragged_paged_attention_plain(
        q, kq, vq, rows_t, pos_t, nv_t, scale, ks, vs))
    sdpa = _sdpa_on_pages(q, kd, vd, rows_t, pos_t, nv_t, scale)
    library_ms, graph_library_ms = _time_ms(sdpa), _graph_ms(sdpa)
    # q and o (bf16) once, the int8 pages the chunks reach once with
    # their two fp32 scales, the int32 rows
    nbytes = (2 * q.numel() * 2 + n_pages * 2 * nKV * (bs * d + 4)
              + (rows_t.numel() + 2 * C) * 4)
    bound_ms, bound_by = _bound(nbytes, flops)
    held = _rpa_row_independence(dev, 16, True, 41)
    print(f"K8q bf16: row independence: {held} carried rows bit-equal to "
          "their decode chunk's (mb 16)")
    print(f"K8q bf16: kernel {ms:.4f} ms (device {graph_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa on dequantized pages {library_ms:.4f} "
          f"ms (device {graph_library_ms:.4f}), bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"name": "ragged_paged_attention_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:85",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32], "ms": ms,
            "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "graph_library_ms": graph_library_ms,
            "shape": f"C{C} qb{qb} nH{nH} nKV{nKV} d{d} bs{bs} mb{mb} int8"}


LORA_TOL = 1e-5        # fp32 products of exact bf16 widenings; sum order


def _lora_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    return collections.Counter(lm.LAUNCHES_BY_PLAN)


def _check_lora_variants(tag: str, before: collections.Counter,
                         want: int | None = None) -> int:
    """The K13 launches since ``before``, by (variant as the C entry
    reported it, dtype, H, N, r): every one took the cluster kernel, at
    every shape launched the C launcher's plan (``lora_plan_c``) is
    ``lora_plan``'s, and there are ``want`` of them where given. Returns
    their number."""
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    diff = lm.LAUNCHES_BY_PLAN - before
    for (variant, dt, H, N, r), n in sorted(diff.items()):
        es = torch.empty((), dtype=getattr(torch, dt)).element_size()
        plan = lm.lora_plan(H, N, r, es)
        if lm.lora_plan_c(H, N, r, es) != plan:
            raise AssertionError(f"{tag}: lora_plan_c {H} {N} {r} {dt} != "
                                 f"lora_plan {plan}")
        if variant != "cluster":
            raise AssertionError(f"{tag}: {n} K13 launches took {variant}")
    total = sum(diff.values())
    print(f"{tag}: K13 launches by (variant, dtype, H, N, r): "
          + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items())))
    if total == 0 or (want is not None and total != want):
        raise AssertionError(f"{tag}: {total} K13 launches, want "
                             f"{want if want is not None else '> 0'}")
    return total


def _lora_row_independence(lm, x, a, b, ids, gen) -> int:
    """Rows of ``x`` carried again at other (c, i) in calls of other C
    (1, 5 and 40 packed rows, the rest random rows on random slots):
    each carried row's output is ``torch.equal`` to the first call's."""
    C, qb, H = x.shape
    S = a.shape[0]
    ref = lm.lora_matmul(x, a, b, ids)
    rng = np.random.RandomState(5)
    held = 0
    for C2 in (1, 5, 40):
        x2 = torch.randn((C2, qb, H), generator=gen, device=x.device).to(
            x.dtype)
        ids2 = torch.from_numpy(rng.randint(0, S, size=C2).astype(
            np.int32)).to(x.device)
        moves = []
        for _ in range(min(C2 * qb, 12)):
            src = (rng.randint(C), rng.randint(qb))
            dst = (rng.randint(C2), rng.randint(qb))
            if any(m[1][0] == dst[0] for m in moves):
                continue                     # one source row's slot a c
            x2[dst] = x[src]
            ids2[dst[0]] = ids[src[0]]
            moves.append((src, dst))
        got = lm.lora_matmul(x2, a, b, ids2)
        for src, dst in moves:
            if not torch.equal(got[dst], ref[src]):
                raise AssertionError(f"K13: row {src} carried at {dst} of "
                                     f"a {C2}-row call differs")
            held += 1
    return held


def check_lora(dev) -> dict:
    """K13 at the llama3-8b engine step's shapes: x [32, 16, 4096] bf16,
    rank 8, 5 slots (slot 0 the zero identity), N 4096 (q) and 1024 (v),
    mixed ids with 0; fp32 out held by row to the plain version within
    LORA_TOL (``_scaled_err``), slot-0 rows exactly 0; a row's bits the
    same at other (c, i) in calls of other C; every launch through the
    cluster kernel at ``lora_plan_c == lora_plan``; eager and device
    (CUDA graph) times beside two fp32 bmm on the pre-gathered A and B;
    a digest of each output."""
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    gen = torch.Generator(device=dev).manual_seed(22)
    C, qb, H, r, S = 32, 16, 4096, 8, 5
    x = torch.randn((C, qb, H), generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(22).randint(
        0, S, size=C).astype(np.int32)).to(dev)
    ids[:3] = torch.tensor([0, 1, 4], dtype=torch.int32, device=dev)
    recs = {}
    before = _lora_launch_counts()
    for N in (4096, 1024):
        a = (torch.randn((S, H, r), generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        b = (torch.randn((S, r, N), generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        a[0], b[0] = 0, 0
        got = lm.lora_matmul(x, a, b, ids)
        ref = lm.lora_matmul_plain(x, a, b, ids)
        torch.cuda.synchronize()
        err = _hold(f"K13 N{N}", got, ref, LORA_TOL)
        zero = got[ids == 0]
        if not (zero == 0).all():
            raise AssertionError(f"K13 N{N}: slot-0 rows are not exactly 0")
        held = _lora_row_independence(lm, x, a, b, ids, gen)
        fn = lambda: lm.lora_matmul(x, a, b, ids)  # noqa: E731
        ms, graph_ms = _time_ms(fn), _graph_ms(fn)
        plain_ms = _time_ms(lambda: lm.lora_matmul_plain(x, a, b, ids))
        # library yardstick: two fp32 bmm on the pre-gathered A and B
        xf = x.float()
        ag, bg = a[ids.long()].float(), b[ids.long()].float()
        lib = lambda: torch.bmm(torch.bmm(xf, ag), bg)  # noqa: E731
        library_ms, graph_library_ms = _time_ms(lib), _graph_ms(lib)
        used = len(set(ids.tolist()))
        nbytes = (x.numel() * 2 + used * (H * r + r * N) * 2 + C * 4
                  + C * qb * N * 4)
        bound_ms, bound_by = _bound(nbytes, 2.0 * C * qb * r * (H + N),
                                    FP32_FLOP_PER_S)
        print(f"K13 N{N}: {int((ids == 0).sum())} slot-0 rows exactly 0; "
              f"{held} rows carried at other (c, i) and C bit-equal; output "
              f"digest {_digest(got)}; kernel {ms:.4f} ms (device "
              f"{graph_ms:.4f}), plain {plain_ms:.4f} ms, two fp32 bmm "
              f"{library_ms:.4f} ms (device {graph_library_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        recs[N] = {"name": "lora_matmul", "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/lora_matmul.cu",
                   "replaces": "paddle_tpu/ops/pallas/lora_matmul.py:57",
                   "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms,
                   "graph_library_ms": graph_library_ms,
                   "shape": f"C{C} qb{qb} H{H} r{r} N{N} bf16"}
        del xf, ag, bg
    _check_lora_variants("K13 kernel checks", before)
    for key in ("ms", "graph_ms", "bound_ms", "library_ms",
                "graph_library_ms"):
        recs[4096][f"{key}_n1024"] = recs[1024][key]
    return recs[4096]


QMM_SHAPES = (  # (M, K, N): the layer matmuls at C*qb = 512, the head at C
    (512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
    (512, 14336, 4096), (32, 4096, 128256))
# K9 launches of one llama3-8b engine step by shape: per layer wq and wo,
# wk and wv, w1 and w3, w2; the head once
QMM_STEP_WEIGHTS = (2 * 32, 2 * 32, 2 * 32, 32, 1)


def _int8pack_mm_on_card() -> bool:
    """Whether PyTorch has a CUDA kernel for aten::_weight_int8pack_mm
    (a yardstick only: the port never calls it)."""
    dump = torch._C._dispatch_dump("aten::_weight_int8pack_mm")
    return any(line.startswith("CUDA") for line in dump.splitlines())


def check_qmm(dev) -> dict:
    """K9 at every matmul shape of the int8 engine step, with the variant
    and tile ``qmm_plan`` gave it; the launch-weighted total of one engine
    step; the entry kept for the kernels line is the FFN up-projection,
    the largest."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qmm
    from paddle_tpu_torch.ops.quant import absmax_quantize_int8

    gen = torch.Generator(device=dev).manual_seed(2)
    main = None
    int8pack = _int8pack_mm_on_card()
    step = {"ms": 0.0, "library_ms": 0.0, "int8pack_ms": 0.0,
            "bound_ms": 0.0, "graph_ms": 0.0, "graph_library_ms": 0.0}
    for (M, K, N), n in zip(QMM_SHAPES, QMM_STEP_WEIGHTS):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        wq, s = absmax_quantize_int8(w, axis=-2, scale_dtype=torch.bfloat16)
        plan = qmm.qmm_plan(M, K, N)
        before = qmm.quant_matmul.launches_wgmma
        got = qmm.quant_matmul(x, wq, s)
        ref = qmm.quant_matmul_plain(x, wq, s)
        torch.cuda.synchronize()
        if qmm.quant_matmul.launches_wgmma != before + 1:
            raise AssertionError(f"qmm {M}x{K}x{N}: not the wgmma variant")
        err = (got - ref).abs().max().item()
        if not err <= QMM_ATOL:
            raise AssertionError(f"qmm {M}x{K}x{N}: max_abs_err {err}")
        ms = _time_ms(lambda: qmm.quant_matmul(x, wq, s))
        plain_ms = _time_ms(lambda: qmm.quant_matmul_plain(x, wq, s))
        wb = w.contiguous()
        library_ms = _time_ms(lambda: torch.matmul(x, wb))
        graph_ms = _graph_ms(lambda: qmm.quant_matmul(x, wq, s))
        graph_lib_ms = _graph_ms(lambda: torch.matmul(x, wb))
        pack_ms = None
        if int8pack:
            wt = wq.t().contiguous()                    # [N, K]
            sf = s.reshape(N).to(torch.bfloat16)
            pack_ms = _time_ms(
                lambda: torch._weight_int8pack_mm(x, wt, sf))
            step["int8pack_ms"] += n * pack_ms
            del wt
        nbytes = M * K * 2 + K * N + N * 2 + M * N * 4
        bound_ms, bound_by = _bound(nbytes, 2.0 * M * K * N)
        for k, v in (("ms", ms), ("library_ms", library_ms),
                     ("bound_ms", bound_ms), ("graph_ms", graph_ms),
                     ("graph_library_ms", graph_lib_ms)):
            step[k] += n * v
        tile = {k: plan[k] for k in ("bm", "bn", "tiles", "splits",
                                     "stages")}
        pack = "none on this card" if pack_ms is None else f"{pack_ms:.4f} ms"
        print(f"qmm M{M} K{K} N{N} ({plan['variant']} {tile}): max_abs_err "
              f"{err:.3e} (atol {QMM_ATOL}), kernel {ms:.4f} ms (device "
              f"{graph_ms:.4f} in a CUDA graph), plain {plain_ms:.4f} ms, "
              f"bf16 matmul {library_ms:.4f} ms (device {graph_lib_ms:.4f}), "
              f"_weight_int8pack_mm {pack}, bound {bound_ms:.4f} ms "
              f"({bound_by}), {n} a step")
        rec = {"name": "quant_matmul", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
               "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:53",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "int8pack_ms": pack_ms,
               "graph_ms": graph_ms, "graph_library_ms": graph_lib_ms,
               "shape": f"M{M} K{K} N{N}", "variant": plan["variant"]}
        if N == 14336:
            main = rec
        del x, w, wq, s, wb, got, ref
    print(f"qmm one llama3-8b engine step ({sum(QMM_STEP_WEIGHTS)} K9 "
          f"launches): kernel {step['ms']:.3f} ms (device "
          f"{step['graph_ms']:.3f}), bf16 matmul {step['library_ms']:.3f} ms "
          f"(device {step['graph_library_ms']:.3f}), _weight_int8pack_mm "
          f"{step['int8pack_ms']:.3f} ms (never called by the port), "
          f"bound {step['bound_ms']:.3f} ms")
    main["engine_step_ms"] = step["ms"]
    main["engine_step_library_ms"] = step["library_ms"]
    main["engine_step_graph_ms"] = step["graph_ms"]
    return main


def _requests(cls, vocab: int, seed: int = 0):
    """Eight requests, four at t = 0 and four at t = 0.3 s: half share a
    256-token prefix (the late ones find it in the prefix cache), prompts
    40-600 tokens, greedy and sampled (temperature 0.9, top_p 0.85),
    16-32 new tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, size=256).astype(np.int32)
    reqs = []
    for i in range(8):
        if i % 2 == 0:
            tail = rng.randint(1, vocab, size=rng.randint(8, 345))
            prompt = np.concatenate([prefix, tail.astype(np.int32)])
        else:
            prompt = rng.randint(1, vocab, size=rng.randint(40, 601)).astype(
                np.int32)
        kw = dict(temperature=0.9, top_p=0.85, seed=100 + i) if i % 4 >= 2 \
            else {}
        reqs.append(cls(rid=i, prompt=prompt, arrival=0.3 * (i >= 4),
                        max_new_tokens=int(rng.randint(16, 33)), **kw))
    return reqs


def run_engine(cfg, params, dev, weight_only_int8: bool,
               profile: bool = False):
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention

    eng = ServingEngine(cfg, params=params, max_batch=8, page_size=128,
                        max_seq=2048, weight_only_int8=weight_only_int8,
                        device=dev)
    reqs = _requests(Request, cfg.vocab_size)
    step_s = []                   # host seconds of each step() call
    step = eng.step

    def timed_step(*args, **kw):
        t = time.perf_counter()
        out = step(*args, **kw)
        step_s.append(time.perf_counter() - t)
        return out

    eng.step = timed_step
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    quant_matmul.launches = quant_matmul.launches_wgmma = 0
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            stats = eng.run(reqs)
            torch.cuda.synchronize()
        _print_profile(prof, stats)
    else:
        stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_wgmma": quant_matmul.launches_wgmma}
    steps = stats["unified_steps"]
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
            raise AssertionError(f"request {r.rid} did not complete")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    if stats["prefix_cache_hits"] == 0:
        raise AssertionError("no prefix-cache hit on the shared prefix")
    acc = eng.page_accounting()
    if acc["total"] != eng.n_pages - 1:
        raise AssertionError(f"page ledger {acc} != {eng.n_pages - 1}")
    L = cfg.n_layers
    if launches["ragged_paged_attention"] != L * steps:
        raise AssertionError(f"attention launches {launches} != {L} x "
                             f"{steps} steps")
    want_qmm = (7 * L + 1) * steps if weight_only_int8 else 0
    if launches["quant_matmul"] != want_qmm or \
            launches["quant_matmul_wgmma"] != want_qmm:
        raise AssertionError(f"int8 matmul launches {launches} != "
                             f"{want_qmm}")
    tag = "int8" if weight_only_int8 else "bf16"
    print(f"engine {tag}{' (profiled)' if profile else ''}: {len(reqs)} "
          f"requests, {steps} steps, "
          f"{stats['wall_s'] / steps * 1e3:.1f} ms/step (step() median "
          f"{1e3 * float(np.median(step_s)):.1f} ms, first "
          f"{1e3 * step_s[0]:.1f} ms), "
          f"{stats['total_new_tokens']} tokens, "
          f"{stats['throughput_tok_s']:.1f} tok/s, ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, prefix hits "
          f"{stats['prefix_cache_hits']}, launches {launches}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return reqs, launches


def _print_profile(prof, stats) -> None:
    """Device time by kernel over the engine run (device-side events only:
    a host op's entry would count its kernels twice), and the device's
    busy share of the run's wall time (the profiler's own cost included)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if e.device_type == cuda and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evs)
    wall_us = stats["wall_s"] * 1e6
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of "
          f"{wall_us / 1e3:.1f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def _dense_logits(cfg, params, tokens: np.ndarray) -> torch.Tensor:
    """Plain causal forward of the whole sequence on the CPU (no pages):
    the next-token logits after ``tokens``."""
    from paddle_tpu_torch.models.llama import (_mm, apply_rope, rms_norm,
                                               rope_angles)

    T = len(tokens)
    nH, nKV, dH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(T, dtype=torch.int32)
    cos, sin = rope_angles(cfg, pos)
    cos, sin = cos[:, None, :], sin[:, None, :]
    x = params["wte"][torch.from_numpy(tokens).long()].to(cfg.dtype)
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    for layer in range(cfg.n_layers):
        bp = {k: v[layer] for k, v in params["blocks"].items()}
        h = rms_norm(x, bp["attn_norm"], cfg.rms_eps)
        q = apply_rope(_mm(h, bp["wq"], cfg).reshape(T, nH, dH), cos, sin)
        k = apply_rope(_mm(h, bp["wk"], cfg).reshape(T, nKV, dH), cos, sin)
        v = _mm(h, bp["wv"], cfg).reshape(T, nKV, dH)
        k = k.repeat_interleave(nH // nKV, dim=1)
        v = v.repeat_interleave(nH // nKV, dim=1)
        s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / math.sqrt(dH)
        p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, v.float()).to(cfg.dtype)
        x = x + _mm(o.reshape(T, nH * dH), bp["wo"], cfg)
        h = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
        g = torch.nn.functional.silu(_mm(h, bp["w_gate"], cfg).float())
        x = x + _mm(g.to(cfg.dtype) * _mm(h, bp["w_up"], cfg),
                    bp["w_down"], cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _mm(x[-1:], params["head"], cfg).float()[0]


def check_cuda_vs_cpu(dev) -> None:
    """Greedy streams of a small fp32 config (head dim 128, page 16) on
    the card and on the CPU from identical weights."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu")
    cuda_params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                       if isinstance(v, dict) else v.to(dev))
                   for k, v in cpu_params.items()}
    streams = {}
    for name, params, device in (("cpu", cpu_params, "cpu"),
                                 ("cuda", cuda_params, dev)):
        rng = np.random.RandomState(4)
        reqs = [Request(rid=i, prompt=rng.randint(
                    1, 1024, size=rng.randint(10, 120)).astype(np.int32),
                    max_new_tokens=12) for i in range(5)]
        eng = ServingEngine(cfg, params=params, max_batch=2, page_size=16,
                            max_seq=512, prefill_budget=64, device=device)
        eng.run(reqs)
        streams[name] = (reqs, eng.page_accounting())
    exceptions = 0
    for a, b in zip(streams["cpu"][0], streams["cuda"][0]):
        if a.out_tokens == b.out_tokens:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out_tokens,
                                                   b.out_tokens)) if x != y)
        ctx = np.concatenate([a.prompt, np.asarray(a.out_tokens[:j],
                                                   np.int32)])
        top2 = torch.topk(_dense_logits(cfg, cpu_params, ctx), 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"cpu/cuda: request {a.rid} differs at token {j}, CPU top-2 "
              f"margin {margin:.3e}")
        if margin >= MARGIN:
            raise AssertionError(f"request {a.rid}: streams differ at {j} "
                                 f"with margin {margin}")
        exceptions += 1
    if streams["cpu"][1] != streams["cuda"][1]:
        raise AssertionError(f"ledgers differ: {streams['cpu'][1]} vs "
                             f"{streams['cuda'][1]}")
    print(f"cpu/cuda: {len(streams['cpu'][0])} greedy streams equal, "
          f"{exceptions} near-tie exceptions")


def _scaled_err(got, ref, dim: int = -1) -> tuple[float, float]:
    """(max |got - ref|, max of |got - ref| / max(|ref|, RMS of ref along
    ``dim``)): each element's error in units of its own magnitude, floored
    by its row's RMS so that elements near zero are held to the row's
    scale and rows of small values to their own; rows whose RMS is under
    ZERO_ROW of the whole tensor's are held to that floor."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rms = r.pow(2).mean(dim=dim, keepdim=True).sqrt()
    floor = ZERO_ROW * r.pow(2).mean().sqrt().item()
    scale = torch.maximum(r.abs(), rms).clamp_min(max(floor, 1e-30))
    return diff.max().item(), (diff / scale).max().item()


def _hold(name: str, got, ref, tol: float, dim: int = -1) -> float:
    err, scaled = _scaled_err(got, ref, dim)
    print(f"{name}: max_abs_err {err:.3e}, scaled {scaled:.3e} (tol "
          f"{tol:.3e})")
    if not scaled <= tol:
        raise AssertionError(f"{name}: scaled error {scaled} > {tol}")
    return err


def _heads(dqkv, h: int):
    """[B, S, 3*h*d] -> [B, S, 3, h, d]: rows of one head of q, k or v."""
    B, S, H3 = dqkv.shape
    return dqkv.reshape(B, S, 3, h, H3 // (3 * h))


def check_flash(dev) -> tuple[dict, dict]:
    """K1 and K2 at the gpt3-350m attention shape (bf16, causal) and at a
    small fp32 case for head dims 64 and 128 (causal and not)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(5)
    for d in (64, 128):
        for causal in (True, False):
            h, S = 256 // d * 2, 256
            qkv = torch.randn((2, S, 3 * h * d), generator=gen, device=dev)
            do = torch.randn((2, S, h, d), generator=gen, device=dev)
            o, lse = fa.flash_fwd(qkv, h, causal, d ** -0.5)
            ro, rlse = fa.flash_fwd_plain(qkv, h, causal, d ** -0.5)
            tag = f"flash fp32 d{d} causal={causal}"
            _hold(tag + " o", o, ro, FP32_TOL)
            _hold(tag + " lse", lse, rlse, FP32_TOL)
            dqkv = fa.flash_bwd(qkv, o, lse, do, h, causal, d ** -0.5)
            ref = fa.flash_bwd_plain(qkv, ro, rlse, do, h, causal, d ** -0.5)
            _hold(tag + " dqkv", _heads(dqkv, h), _heads(ref, h), FP32_TOL)
    B, S, h, d = 16, 1024, 16, 64
    scale = d ** -0.5
    qkv = torch.randn((B, S, 3 * h * d), generator=gen,
                      device=dev).to(torch.bfloat16)
    do = torch.randn((B, S, h, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    ro, rlse = fa.flash_fwd_plain(qkv, h, True, scale)
    err_o = _hold("flash bf16 o", o, ro, BF16_TOL)
    _hold("flash bf16 o, rows 768..1023", o[:, 768:], ro[:, 768:], BF16_TOL)
    _hold("flash bf16 lse", lse, rlse, FP32_TOL)
    dqkv = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    again = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    if not torch.equal(dqkv, again):
        raise AssertionError("flash backward is not deterministic")
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    err_d = _hold("flash bf16 dqkv", _heads(dqkv, h), _heads(ref, h),
                  BF16_TOL)
    del ro, rlse, ref, again
    torch.cuda.empty_cache()
    fwd_ms = _time_ms(lambda: fa.flash_fwd(qkv, h, True, scale))
    bwd_ms = _time_ms(lambda: fa.flash_bwd(qkv, o, lse, do, h, True, scale))
    fwd_plain = _time_ms(lambda: fa.flash_fwd_plain(qkv, h, True, scale),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: fa.flash_bwd_plain(qkv, o, lse, do, h,
                                                    True, scale),
                         iters=3, warmup=1)
    # library yardstick: SDPA on contiguous head-major q, k, v
    q, k, v = (t.reshape(B, S, h, d).transpose(1, 2).contiguous()
               .requires_grad_(True) for t in qkv.split(h * d, dim=-1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = _time_ms(lambda: sdpa(q, k, v, is_causal=True))
    out = sdpa(q, k, v, is_causal=True)
    do_h = do.transpose(1, 2).contiguous()
    lib_bwd = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), do_h,
                                                   retain_graph=True))
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    qkv_b, o_b, st_b = qkv.numel() * 2, o.numel() * 2, B * h * S * 4
    f_bound = _bound(qkv_b + o_b + st_b, 4.0 * d * pairs)
    b_bound = _bound(2 * qkv_b + o_b + 2 * st_b, 10.0 * d * pairs)
    print(f"flash fwd: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
          f"sdpa {lib_fwd:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]})")
    print(f"flash bwd: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
          f"sdpa bwd {lib_bwd:.4f} ms, bound {b_bound[0]:.4f} ms "
          f"({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = f"B{B} S{S} h{h} d{d} causal"
    return ({"name": "flash_fwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":139", "max_abs_err": err_o,
             "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": f_bound[0],
             "bound_by": f_bound[1], "library_ms": lib_fwd, "shape": shape},
            {"name": "flash_bwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":298", "max_abs_err": err_d,
             "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": b_bound[0],
             "bound_by": b_bound[1], "library_ms": lib_bwd, "shape": shape})


def _hold_long_dqkv(name: str, got, ref) -> float:
    """dqkv [B, S, 3, h, d] at a long sequence: dk, dv and dq's rows
    1..S-1 by row at BF16_TOL; dq's row 0 is 0 in exact arithmetic
    (ds_00 = dp_00 - delta_0 with o_0 = v_0), rounding noise on both
    sides, whose size does not fall with S while the tensor's RMS, and so
    the ZERO_ROW floor, does: both sides' row 0 must lie under that
    floor."""
    err = max(_hold(name + " dk, dv", got[:, :, 1:], ref[:, :, 1:],
                    BF16_TOL),
              _hold(name + " dq rows 1..", got[:, 1:, 0], ref[:, 1:, 0],
                    BF16_TOL))
    floor = ZERO_ROW * ref[:, :, 0].float().pow(2).mean().sqrt().item()
    row0 = max(got[:, 0, 0].float().abs().max().item(),
               ref[:, 0, 0].float().abs().max().item())
    print(f"{name} dq row 0: max |value| {row0:.3e} (floor {floor:.3e})")
    if not row0 <= floor:
        raise AssertionError(f"{name}: dq row 0 reaches {row0} > {floor}")
    return max(err, (got[:, 0, 0].float() - ref[:, 0, 0].float()).abs()
               .max().item())


def _split_timing(fa, inputs, sep: bool, B, S, h, d, plain_iters=3):
    """(K3 ms, K2 ms or None, plain ms, SDPA backward ms, bound, K3
    device ms) of K3 in one mode at one shape: kernel, the merged K2 on
    the same inputs (fused mode), the plain version and the library
    yardstick (the backward of causal SDPA on contiguous head-major q, k,
    v); K3's device time (and K2's) in a CUDA graph of 5 calls."""
    scale = d ** -0.5
    if sep:
        q, k, v, o, lse, do = inputs
        k3 = lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, True, scale)
        ms = _time_ms(k3)
        k2_ms = k2_dev = None
        plain_ms = _time_ms(lambda: fa.flash_bwd_sep_plain(
            q, k, v, o, lse, do, True, scale), iters=plain_iters, warmup=1)
        heads = (q, k, v)
    else:
        qkv, o, lse, do = inputs
        k3 = lambda: fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
        ms = _time_ms(k3)
        k2 = lambda: fa.flash_bwd(qkv, o, lse, do, h, True, scale)
        k2_ms = _time_ms(k2)
        k2_dev = _graph_ms(k2, iters=5)
        plain_ms = _time_ms(lambda: fa.flash_bwd_plain(
            qkv, o, lse, do, h, True, scale), iters=plain_iters, warmup=1)
        heads = qkv.split(h * d, dim=-1)
    dev_ms = _graph_ms(k3, iters=5)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.reshape(B, S, h, d).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in heads)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(qh, kh, vh, is_causal=True)
    do_h = do.transpose(1, 2).contiguous()
    lib_ms = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_h,
                                                  retain_graph=True))
    del out, qh, kh, vh, do_h
    torch.cuda.empty_cache()
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    qkv_b, o_b, st_b = 3 * B * S * h * d * 2, B * S * h * d * 2, B * h * S * 4
    # the function needs 5 products of 2d flop a pair (s, dp, dq, dk, dv),
    # as K2's bound counts; the dq kernel's second s and dp are K3's cost
    bound = _bound(2 * qkv_b + o_b + 2 * st_b, 10.0 * d * pairs)
    print(f"  device times (CUDA graph): K3 {dev_ms:.4f} ms"
          + ("" if k2_dev is None else f", K2 {k2_dev:.4f} ms"))
    return ms, k2_ms, plain_ms, lib_ms, bound, dev_ms


def check_flash_split(dev) -> tuple[dict, dict]:
    """K3, the split flash backward, in its two modes: fused-qkv at
    gpt3-1.3b's long-context shape (B 1, S 8192, h 16, d 128, bf16; the
    step the 6 MiB gate sends to K3) bit-equal to K2 on the same inputs
    and timed beside it; fused-qkv at S 2048 against its plain version;
    separate at llama1b's training shape (B 2, S 2048, h 16, d 128,
    bf16) against its plain version and bit-equal to the fused mode on
    the same values packed into one qkv; small fp32 cases at head dims
    64, 128 and 256, causal and not, both modes."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(13)
    for d in (64, 128, 256):
        for causal in (True, False):
            h, S = 2, 256
            q, k, v, do = (torch.randn((2, S, h, d), generator=gen,
                                       device=dev) for _ in range(4))
            qkv = torch.cat([t.reshape(2, S, h * d) for t in (q, k, v)], -1)
            o, lse = fa.flash_fwd(qkv, h, causal, d ** -0.5)
            tag = f"flash split fp32 d{d} causal={causal}"
            got = fa.flash_bwd_split(qkv, o, lse, do, h, causal, d ** -0.5)
            ref = fa.flash_bwd_plain(qkv, o, lse, do, h, causal, d ** -0.5)
            _hold(tag + " dqkv", _heads(got, h), _heads(ref, h), FP32_TOL)
            if not torch.equal(got, fa.flash_bwd(qkv, o, lse, do, h, causal,
                                                 d ** -0.5)):
                raise AssertionError(tag + ": K3 != K2")
            sep = fa.flash_bwd_sep(q, k, v, o, lse, do, causal, d ** -0.5)
            if not torch.equal(got, torch.cat([t.reshape(2, S, h * d)
                                               for t in sep], -1)):
                raise AssertionError(tag + ": separate != fused mode")
    bf = torch.bfloat16
    # fused mode at S 2048 against the plain version
    B, S, h, d = 1, 2048, 16, 128
    scale = d ** -0.5
    qkv = torch.randn((B, S, 3 * h * d), generator=gen, device=dev).to(bf)
    do = torch.randn((B, S, h, d), generator=gen, device=dev).to(bf)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    got = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    _hold("flash split bf16 S2048 dqkv", _heads(got, h), _heads(ref, h),
          BF16_TOL)
    del got, ref
    torch.cuda.empty_cache()
    ms, k2_ms, plain_ms, lib_ms, bound, _ = _split_timing(
        fa, (qkv, o, lse, do), False, B, S, h, d)
    print(f"flash split bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms on the same inputs, plain {plain_ms:.4f} ms, "
          f"sdpa bwd {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    del qkv, do, o, lse
    torch.cuda.empty_cache()
    # fused mode at the S 8192 step: K3 == K2, both timed
    B, S = 1, 8192
    qkv = torch.randn((B, S, 3 * h * d), generator=gen, device=dev).to(bf)
    do = torch.randn((B, S, h, d), generator=gen, device=dev).to(bf)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    got = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    again = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    k2 = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    if not (torch.equal(got, k2) and torch.equal(got, again)):
        raise AssertionError("flash split S8192: K3 != K2 (or not "
                             "deterministic)")
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    err_f = _hold_long_dqkv("flash split bf16 S8192", _heads(got, h),
                            _heads(ref, h))
    del got, again, k2, ref
    torch.cuda.empty_cache()
    ms, k2_ms, plain_ms, lib_ms, bound, dev_f = _split_timing(
        fa, (qkv, o, lse, do), False, B, S, h, d, plain_iters=2)
    print(f"flash split bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms on the same inputs, plain {plain_ms:.4f} ms, "
          f"sdpa bwd {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    rec_f = {"name": "flash_bwd_split", "route": "cuda", "source": src,
             "replaces": ref_py + ":195,236", "max_abs_err": err_f,
             "ms": ms, "device_ms": dev_f, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
             "k2_ms": k2_ms, "shape": f"B{B} S{S} h{h} d{d} causal fused"}
    del qkv, do, o, lse
    torch.cuda.empty_cache()
    # separate mode at llama1b's training shape
    B, S = 2, 2048
    q, k, v, do = (torch.randn((B, S, h, d), generator=gen,
                               device=dev).to(bf) for _ in range(4))
    o, lse = fa.flash_fwd_sep(q, k, v, True, scale)
    sep = fa.flash_bwd_sep(q, k, v, o, lse, do, True, scale)
    ref = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, True, scale)
    err_s = 0.0
    for name, a, b in zip("qkv", sep, ref):
        err_s = max(err_s, _hold(f"flash sep bf16 B{B} S{S} d{name}", a, b,
                                 BF16_TOL))
    qkv = torch.cat([t.reshape(B, S, h * d) for t in (q, k, v)], -1)
    fused = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    if not torch.equal(fused, torch.cat([t.reshape(B, S, h * d)
                                         for t in sep], -1)):
        raise AssertionError("flash sep: separate != fused mode on packed "
                             "inputs")
    del qkv, fused, sep, ref
    torch.cuda.empty_cache()
    ms, _, plain_ms, lib_ms, bound, dev_s = _split_timing(
        fa, (q, k, v, o, lse, do), True, B, S, h, d)
    print(f"flash sep bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    rec_s = {"name": "flash_bwd_sep", "route": "cuda", "source": src,
             "replaces": ref_py + ":195,236", "max_abs_err": err_s,
             "ms": ms, "device_ms": dev_s, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
             "shape": f"B{B} S{S} h{h} d{d} causal separate"}
    return rec_f, rec_s


def _hm(*ts):
    """[B, S, h, d] -> contiguous head-major [B, h, S, d]."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def _k17_equal_to_sep(fa, tag, q, k, v, do, causal, scale) -> tuple:
    """K17 on head-major copies of separate q, k, v against K1-sep and
    K3-sep on the originals: the same bodies with head strides, so
    bit-equal (torch.equal). Returns K17's (o, lse, dq, dk, dv)."""
    q_, k_, v_, do_ = _hm(q, k, v, do)
    o, lse = fa.flash_fwd_hm(q_, k_, v_, causal, scale)
    grads = fa.flash_bwd_hm(q_, k_, v_, o, lse, do_, causal, scale)
    o_sep, lse_sep = fa.flash_fwd_sep(q, k, v, causal, scale)
    sep = fa.flash_bwd_sep(q, k, v, o_sep, lse_sep, do, causal, scale)
    torch.cuda.synchronize()
    if not (torch.equal(o.transpose(1, 2), o_sep)
            and torch.equal(lse, lse_sep)):
        raise AssertionError(f"{tag}: K17 forward != K1-sep")
    for name, a, b in zip("qkv", grads, sep):
        if not torch.equal(a.transpose(1, 2), b):
            raise AssertionError(f"{tag}: K17 d{name} != K3-sep")
    return (o, lse, *grads)


def check_flash_head_major(dev) -> tuple[dict, dict]:
    """K17, the head-major flash forward and split backward ([B, h, S, d],
    FLAGS_flash_attention_native_layout=0 and odd head counts at d 64):
    bit-equal to K1-sep and K3-sep on the same values and within the
    tolerance of its plain version, in small fp32 cases (head dims 64
    with 5 heads, 128, 256; causal and not), at gpt3-350m's attention (B
    16, S 1024, h 16, d 64, bf16; timed) and at h 5, d 64."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(17)

    def case(B, S, h, d, dt):
        return [torch.randn((B, S, h, d), generator=gen, device=dev).to(dt)
                for _ in range(4)]

    for h, d in ((5, 64), (2, 128), (1, 256)):
        for causal in (True, False):
            q, k, v, do = case(2, 256, h, d, torch.float32)
            tag = f"K17 fp32 h{h} d{d} causal={causal}"
            o, lse, *grads = _k17_equal_to_sep(fa, tag, q, k, v, do, causal,
                                               d ** -0.5)
            q_, k_, v_, do_ = _hm(q, k, v, do)
            ro, rlse = fa.flash_fwd_hm_plain(q_, k_, v_, causal, d ** -0.5)
            _hold(tag + " o", o, ro, FP32_TOL)
            _hold(tag + " lse", lse, rlse, FP32_TOL)
            ref = fa.flash_bwd_hm_plain(q_, k_, v_, o, lse, do_, causal,
                                        d ** -0.5)
            for name, a, b in zip("qkv", grads, ref):
                _hold(f"{tag} d{name}", a, b, FP32_TOL)
    bf = torch.bfloat16
    err_f = err_b = 0.0
    for B, S, h, d in ((16, 1024, 5, 64), (16, 1024, 16, 64)):
        scale = d ** -0.5
        q, k, v, do = case(B, S, h, d, bf)
        tag = f"K17 bf16 B{B} S{S} h{h} d{d}"
        o, lse, *grads = _k17_equal_to_sep(fa, tag, q, k, v, do, True, scale)
        q_, k_, v_, do_ = _hm(q, k, v, do)
        ro, _ = fa.flash_fwd_hm_plain(q_, k_, v_, True, scale)
        err_f = max(err_f, _hold(tag + " o", o, ro, BF16_TOL))
        del ro
        ref = fa.flash_bwd_hm_plain(q_, k_, v_, o, lse, do_, True, scale)
        for name, a, b in zip("qkv", grads, ref):
            err_b = max(err_b, _hold(f"{tag} d{name}", a, b, BF16_TOL))
        del ref, grads
        torch.cuda.empty_cache()
    # timed at gpt3-350m's attention, the flagged step's shape
    fwd_ms = _time_ms(lambda: fa.flash_fwd_hm(q_, k_, v_, True, scale))
    bwd_ms = _time_ms(lambda: fa.flash_bwd_hm(q_, k_, v_, o, lse, do_, True,
                                              scale))
    fwd_plain = _time_ms(lambda: fa.flash_fwd_hm_plain(q_, k_, v_, True,
                                                       scale),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: fa.flash_bwd_hm_plain(
        q_, k_, v_, o, lse, do_, True, scale), iters=3, warmup=1)
    # library yardstick: SDPA on the same head-major q, k, v
    qh, kh, vh = (t.clone().requires_grad_(True) for t in (q_, k_, v_))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = _time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    out = sdpa(qh, kh, vh, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_,
                                                   retain_graph=True))
    del out, qh, kh, vh
    torch.cuda.empty_cache()
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    in_b, st_b = q.numel() * 2, B * h * S * 4
    f_bound = _bound(3 * in_b + in_b + st_b, 4.0 * d * pairs)
    # q, k, v, do and lse, delta read, dq, dk, dv written (K2's count)
    b_bound = _bound(7 * in_b + 2 * st_b, 10.0 * d * pairs)
    print(f"K17 fwd B{B} S{S} h{h} d{d}: kernel {fwd_ms:.4f} ms, plain "
          f"{fwd_plain:.4f} ms, sdpa {lib_fwd:.4f} ms, bound "
          f"{f_bound[0]:.4f} ms ({f_bound[1]})")
    print(f"K17 bwd B{B} S{S} h{h} d{d}: kernel {bwd_ms:.4f} ms (dq + "
          f"dk/dv), plain {bwd_plain:.4f} ms, sdpa bwd {lib_bwd:.4f} ms, "
          f"bound {b_bound[0]:.4f} ms ({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = f"B{B} S{S} h{h} d{d} causal, head-major, bf16"
    return ({"name": "flash_fwd_hm", "route": "cuda", "source": src,
             "replaces": ref_py + ":490", "max_abs_err": err_f,
             "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": f_bound[0],
             "bound_by": f_bound[1], "library_ms": lib_fwd, "shape": shape},
            {"name": "flash_bwd_hm", "route": "cuda", "source": src,
             "replaces": ref_py + ":545,585", "max_abs_err": err_b,
             "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": b_bound[0],
             "bound_by": b_bound[1], "library_ms": lib_bwd, "shape": shape})


def check_ce(dev) -> tuple[dict, dict]:
    """K4 and K5 at the gpt3-350m loss shape (bf16, N 16384, H 1024,
    V 50304) and at a small case with ragged token and vocab tiles, fp32
    and bf16."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    gen = torch.Generator(device=dev).manual_seed(6)

    def case(N, H, V, dt):
        x = torch.randn((N, H), generator=gen, device=dev).to(dt)
        wte = (torch.randn((V, H), generator=gen, device=dev)
               * (CE_LOGIT_STD / math.sqrt(H))).to(dt)
        lab = torch.randint(0, V, (N,), generator=gen, device=dev)
        g = torch.full((N,), 1.0 / N, device=dev)
        return x, wte, lab, g

    def hold_bwd(tag, dx, dh, rdx, rdh, lab, tol):
        """dx by token row, dhead by vocab column; the columns that are
        no token's label hold only the softmax part of dl."""
        err = max(_hold(tag + " dx", dx, rdx, tol),
                  _hold(tag + " dhead", dh, rdh, tol, dim=0))
        free = torch.ones(dh.shape[1], dtype=torch.bool, device=dev)
        free[lab] = False
        _hold(f"{tag} dhead, {int(free.sum())} columns without a label",
              dh[:, free], rdh[:, free], tol, dim=0)
        return err

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = collections.Counter(ce.PRODUCTS)
    # ragged token and vocab tiles, two vocab slabs, the last ragged
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        if ce.ce_plan_c(300, 128, ce.SLAB + 1000, dt) != ce.ce_plan(
                300, 128, ce.SLAB + 1000, dt, sms=sms):
            raise AssertionError(f"ce_plan_c != ce_plan, small {dt}")
        x, wte, lab, g = case(300, 128, ce.SLAB + 1000, dt)
        nll, lse = ce.fused_ce_fwd(x, wte.t(), lab)
        rnll, rlse = ce.fused_ce_fwd_plain(x, wte.t(), lab)
        _hold(f"ce {dt} small nll", nll, rnll, FP32_TOL)
        _hold(f"ce {dt} small lse", lse, rlse, FP32_TOL)
        dx, dh = ce.fused_ce_bwd(x, wte.t(), lab, lse, g)
        rdx, rdh = ce.fused_ce_bwd_plain(x, wte.t(), lab, lse, g)
        hold_bwd(f"ce {dt} small", dx, dh, rdx, rdh, lab, tol)

    N, H, V = 16384, 1024, 50304
    if ce.ce_plan_c(N, H, V) != ce.ce_plan(N, H, V, sms=sms):
        raise AssertionError("ce_plan_c != ce_plan at the gpt3-350m shape")
    x, wte, lab, g = case(N, H, V, torch.bfloat16)
    head = wte.t()
    nll, lse = ce.fused_ce_fwd(x, head, lab)
    rnll, rlse = ce.fused_ce_fwd_plain(x, head, lab)
    err_f = (nll - rnll).abs().max().item()
    err_l = (lse - rlse).abs().max().item()
    top_p = torch.exp(torch.matmul(x[:1024].float(), wte.float().t())
                      .amax(-1) - rlse[:1024]).mean().item()
    print(f"ce bf16 nll / lse: max_abs_err {err_f:.3e} / {err_l:.3e} "
          f"(atol {CE_FWD_ATOL}); mean top probability {top_p:.3f} over "
          "1024 tokens")
    if not max(err_f, err_l) <= CE_FWD_ATOL:
        raise AssertionError(f"ce fwd: max_abs_err {err_f} / {err_l}")
    del rnll, rlse
    dx, dh = ce.fused_ce_bwd(x, head, lab, lse, g)
    dx2, dh2 = ce.fused_ce_bwd(x, head, lab, lse, g)
    if not (torch.equal(dx, dx2) and torch.equal(dh, dh2)):
        raise AssertionError("ce backward is not deterministic")
    del dx2, dh2
    rdx, rdh = ce.fused_ce_bwd_plain(x, head, lab, lse, g)
    err_b = hold_bwd("ce bf16", dx, dh, rdx, rdh, lab, BF16_TOL)
    del rdx, rdh, dx, dh
    torch.cuda.empty_cache()
    # every bf16 product above went through the wgmma route, as the C
    # entries reported what they launched
    seen = ce.PRODUCTS - before
    variants = sorted({v for v, dt, _ in seen if dt == "bfloat16"})
    if variants != ["wgmma"]:
        raise AssertionError(f"ce bf16 products took {variants}: {seen}")
    fwd_ms = _time_ms(lambda: ce.fused_ce_fwd(x, head, lab), iters=5)
    bwd_ms = _time_ms(lambda: ce.fused_ce_bwd(x, head, lab, lse, g),
                      iters=3)
    fwd_dev = _graph_ms(lambda: ce.fused_ce_fwd(x, head, lab), iters=5)
    bwd_dev = _graph_ms(lambda: ce.fused_ce_bwd(x, head, lab, lse, g),
                        iters=3)
    # the products the kernels compute, as bf16 cuBLAS calls: x @ w^T for
    # K4; per vocab slab x @ w_slab^T, dl @ w_slab and dl^T @ x for K5
    slabs = [wte[v0:v0 + ce.SLAB] for v0 in range(0, V, ce.SLAB)]
    dls = [(1e-4 * torch.randn((N, ws.shape[0]), generator=gen,
                               device=dev)).to(torch.bfloat16)
           for ws in slabs]

    def bwd_products():
        for ws, dl in zip(slabs, dls):
            x @ ws.t()
            dl @ ws
            dl.t() @ x

    fwd_products = _time_ms(lambda: x @ wte.t(), iters=5)
    bwd_products_ms = _time_ms(bwd_products, iters=3)
    del slabs, dls
    torch.cuda.empty_cache()
    fwd_plain = _time_ms(lambda: ce.fused_ce_fwd_plain(x, head, lab),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: ce.fused_ce_bwd_plain(x, head, lab, lse,
                                                       g), iters=2, warmup=1)
    # library yardstick: F.cross_entropy on the fp32 logits x @ wte.T
    xf = x.float().requires_grad_(True)
    wf = wte.float().requires_grad_(True)
    xent = torch.nn.functional.cross_entropy

    def lib_fwd():
        return xent(xf @ wf.t(), lab, reduction="sum")

    lib_fwd_ms = _time_ms(lib_fwd, iters=3, warmup=1)
    loss = lib_fwd() / N
    lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        loss, (xf, wf), retain_graph=True), iters=3, warmup=1)
    del loss, xf, wf
    torch.cuda.empty_cache()
    io = (N * H + V * H) * 2 + N * 4
    f_bound = _bound(io + 2 * N * 4, 2.0 * N * H * V)
    b_bound = _bound(io + 2 * N * 4 + (N * H + V * H) * 2, 6.0 * N * H * V)
    print(f"ce fwd: kernel {fwd_ms:.4f} ms (device {fwd_dev:.4f}), plain "
          f"{fwd_plain:.4f} ms, bf16 products {fwd_products:.4f} ms, "
          f"cross_entropy {lib_fwd_ms:.4f} ms, bound {f_bound[0]:.4f} ms "
          f"({f_bound[1]})")
    print(f"ce bwd: kernel {bwd_ms:.4f} ms (device {bwd_dev:.4f}), plain "
          f"{bwd_plain:.4f} ms, bf16 products {bwd_products_ms:.4f} ms, "
          f"cross_entropy bwd {lib_bwd_ms:.4f} ms, bound {b_bound[0]:.4f} "
          f"ms ({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/fused_ce.cu"
    ref_py = "paddle_tpu/ops/pallas/fused_ce.py"
    shape = f"N{N} H{H} V{V}"
    return ({"name": "fused_ce_fwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":81", "max_abs_err": max(err_f, err_l),
             "ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": fwd_plain,
             "bound_ms": f_bound[0], "bound_by": f_bound[1],
             "library_ms": lib_fwd_ms, "products_ms": fwd_products,
             "variant": variants[0], "shape": shape},
            {"name": "fused_ce_bwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":125", "max_abs_err": err_b,
             "ms": bwd_ms, "device_ms": bwd_dev, "plain_ms": bwd_plain,
             "bound_ms": b_bound[0], "bound_by": b_bound[1],
             "library_ms": lib_bwd_ms, "products_ms": bwd_products_ms,
             "variant": variants[0], "shape": shape})


def _vec(gen, dev, h: int, mean: float, std: float, dtype=torch.float32):
    return (mean + std * torch.randn((h,), generator=gen, device=dev)).to(
        dtype)


def _norm_case(gen, dev, worst, tag, n, h, dt, norm, sub, bias, beta,
               act=None, gain_dtype=torch.float32):
    """One K6 case against its plain version: r bit-equal, y held by
    _scaled_err by row; the worst y error goes into ``worst[dt]``."""
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    x = torch.randn((n, h), generator=gen, device=dev).to(dt)
    s = (torch.randn((n, h), generator=gen, device=dev).to(dt)
         if sub else None)
    b = _vec(gen, dev, h, 0.0, 0.5) if bias else None
    g = _vec(gen, dev, h, 1.0, 0.2, gain_dtype)
    be = _vec(gen, dev, h, 0.0, 0.2) if beta else None
    r, y = fne.norm_epilogue_fwd(x, s, b, g, be, norm, 1e-5, act)
    rr, ry = fne.norm_epilogue_plain(x, s, b, g, be, norm, 1e-5, act)
    torch.cuda.synchronize()
    if not torch.equal(r, rr):
        raise AssertionError(f"K6 {tag}: r is not bit-equal to the plain "
                             "composition")
    tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
    worst[dt] = max(worst[dt], _hold(f"K6 {tag} y (r bit-equal)", y, ry,
                                     tol))
    return x, s, b, g, be


def check_norm_epilogue(dev) -> dict:
    """K6 against its plain version: at the gpt3-350m norm shape
    ([16384, 1024] bf16) in the residual + bias layer form (ln2 and the
    next layer's ln1), the norm-only form (layer 0's ln1), with the tanh
    gelu, the rms form at H 4096 (llama3-8b's), and small fp32 cases. r
    must be bit-equal; y is held by _scaled_err by row."""
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}

    def case(*args, **kw):
        return _norm_case(gen, dev, worst, *args, **kw)

    N, H = 16384, 1024
    bf = torch.bfloat16
    x, s, b, g, be = case("layer residual+bias bf16 [16384, 1024]", N, H, bf,
                          "layer", True, True, True)
    case("layer norm-only bf16 [16384, 1024]", N, H, bf, "layer", False,
         False, True)
    case("layer residual+bias gelu bf16 [16384, 1024]", N, H, bf, "layer",
         True, True, True, "gelu")
    case("rms residual bf16 [4096, 4096]", 4096, 4096, bf, "rms", True,
         False, False)
    case("layer residual+bias fp32 [512, 256]", 512, 256, torch.float32,
         "layer", True, True, True)
    case("rms residual+bias gelu fp32 [512, 4096]", 512, 4096,
         torch.float32, "rms", True, True, False, "gelu")
    ms = _time_ms(lambda: fne.norm_epilogue_fwd(x, s, b, g, be, "layer",
                                                1e-5))
    plain_ms = _time_ms(lambda: fne.norm_epilogue_plain(x, s, b, g, be,
                                                        "layer", 1e-5))
    # nearest library call: F.layer_norm on a precomputed r (the adds
    # left out), weight and bias in r's dtype
    r = (x + s) + b.to(bf)
    gb, beb = g.to(bf), be.to(bf)
    library_ms = _time_ms(lambda: torch.nn.functional.layer_norm(
        r, (H,), gb, beb, 1e-5))
    bound_ms, bound_by = _bound(4 * N * H * 2 + 3 * H * 4, 10.0 * N * H,
                                FP32_FLOP_PER_S)
    print(f"K6 layer residual+bias bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, layer_norm on r {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "fused_norm_epilogue", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_norm_epilogue.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm_epilogue.py:106",
            "max_abs_err": worst[bf], "max_abs_err_fp32":
            worst[torch.float32], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"N{N} H{H} layer, residual + bias, bf16"}


def check_bias_gelu(dev) -> dict:
    """K7 against its plain version at the gpt3-350m FFN shape
    ([16384, 4096] bf16, fp32 bias) and a small fp32 case."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev).manual_seed(10)
    errs = {}
    for (n, f), dt, tol in (((16384, 4096), torch.bfloat16, BF16_TOL),
                            ((512, 256), torch.float32, FP32_TOL)):
        x = (2.0 * torch.randn((n, f), generator=gen, device=dev)).to(dt)
        b = _vec(gen, dev, f, 0.0, 0.5)
        y = fba.bias_gelu_fwd(x, b)
        ref = fba.bias_gelu_plain(x, b)
        torch.cuda.synchronize()
        errs[dt] = _hold(f"K7 {dt} [{n}, {f}]", y, ref, tol)
    x = (2.0 * torch.randn((16384, 4096), generator=gen,
                           device=dev)).to(torch.bfloat16)
    b = _vec(gen, dev, 4096, 0.0, 0.5)
    # the 2-D walk: the C launcher's is bias_gelu_plan's, and the first
    # 256 rows alone give the bits of those rows of the whole call
    N, Fd = x.shape
    walk = fba.bias_gelu_plan_c(N, Fd, x.dtype, b.dtype)
    if walk != fba.bias_gelu_plan(N, Fd, x.element_size(),
                                  walk["resident"]):
        raise AssertionError(f"bias_gelu_plan_c {walk} != bias_gelu_plan")
    if not torch.equal(fba.bias_gelu_fwd(x[:256], b),
                       fba.bias_gelu_fwd(x, b)[:256]):
        raise AssertionError("K7: rows 0-255 alone differ from the call's")
    ms = _time_ms(lambda: fba.bias_gelu_fwd(x, b))
    device_ms = _graph_ms(lambda: fba.bias_gelu_fwd(x, b))
    plain_ms = _time_ms(lambda: fba.bias_gelu_plain(x, b))
    # nearest library call: the tanh gelu on a pre-biased input (the add
    # left out)
    xb = x + b.to(torch.bfloat16)
    library_ms = _time_ms(lambda: torch.nn.functional.gelu(
        xb, approximate="tanh"))
    library_device_ms = _graph_ms(lambda: torch.nn.functional.gelu(
        xb, approximate="tanh"))
    bound_ms, bound_by = _bound(2 * N * Fd * 2 + Fd * 4, 12.0 * N * Fd,
                                FP32_FLOP_PER_S)
    variant = (f"2-D walk: {walk['cols']} vectors x {walk['rows']} rows a "
               f"block, grid {walk['grid'][0]} x {walk['grid'][1]}, "
               f"{walk['unroll']} loads in flight")
    print(f"K7 bias gelu bf16: kernel {ms:.4f} ms (device {device_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, gelu on x + b {library_ms:.4f} ms "
          f"(device {library_device_ms:.4f}), bound {bound_ms:.4f} ms "
          f"({bound_by}); {variant}")
    # K7 computes no product: products_ms is null
    return {"name": "fused_bias_act", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_bias_act.py:91",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32":
            errs[torch.float32], "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "products_ms": None, "variant": variant,
            "shape": f"N{N} F{Fd} bf16"}


def _train_counters():
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    return {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "fused_ce_fwd": ce.fused_ce_fwd, "fused_ce_bwd": ce.fused_ce_bwd,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "fused_bias_act": fba.bias_gelu_fwd}


def _check_ce_products(tag: str, before: collections.Counter, steps: int,
                       N: int, H: int, V: int) -> None:
    """The cross-entropy products since ``before`` are exactly ``steps``
    forwards and backwards at x [N, H] bf16 over V, every one through the
    wgmma route as the C entries reported it (K4's "stats" once a step,
    K5's "dl", "dx", "dw" once a slab), and the C launchers' plan
    (``ce_plan_c``) is ``ce_plan``'s at that shape."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    diff = dict(ce.PRODUCTS - before)
    slabs = -(-V // ce.SLAB)
    want = {("wgmma", "bfloat16", p): steps * (1 if p == "stats" else slabs)
            for p in ("stats", "dl", "dx", "dw")}
    if diff != want:
        raise AssertionError(f"{tag}: CE products {diff} != {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if ce.ce_plan_c(N, H, V) != ce.ce_plan(N, H, V, sms=sms):
        raise AssertionError(f"{tag}: ce_plan_c != ce_plan at N{N} H{H} "
                             f"V{V}")
    print(f"{tag}: CE products by (variant, dtype, product): {diff}")


TRAIN_CATEGORIES = (
    ("K4/K5 cross-entropy", ("ce_wg_kernel", "ce_fma_kernel",
                             "ce_stats_reduce")),
    ("K1/K2 flash attention", ("fwd_wg_kernel", "bwd_wg_kernel",
                               "fwd_fma_kernel", "bwd_fma_kernel")),
    ("K6/K7 norm epilogue, bias gelu", ("norm_epilogue_kernel",
                                        "bias_gelu_kernel")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
)


def _profile_train(step, params, opt, toks, labs, tag: str,
                   n: int = 2) -> None:
    """Device time of n flagship steps by kind of kernel, the device's
    busy share of their wall time (profiler cost included), and the
    AdamW update timed alone (zero gradients, the same arithmetic)."""
    from paddle_tpu_torch.parallel.train_step import adamw_update

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loss, params, opt = step(params, opt, toks, labs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(prof, {"wall_s": wall})
    cuda = torch.autograd.DeviceType.CUDA
    sums = {name: 0.0 for name, _ in TRAIN_CATEGORIES}
    rest = 0.0
    for e in prof.key_averages():
        if e.device_type != cuda or e.self_device_time_total <= 0:
            continue
        for name, keys in TRAIN_CATEGORIES:
            if any(k in e.key for k in keys):
                sums[name] += e.self_device_time_total
                break
        else:
            rest += e.self_device_time_total
    sums["elementwise, copies, reductions (incl. AdamW)"] = rest
    for name, us in sums.items():
        print(f"train profile ({tag}): {name}: {us / 1e3 / n:.2f} ms/step")
    gtree = _map_leaves(params, torch.zeros_like)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_update(params, gtree, opt, 1e-4, m_dtype="bfloat16",
                     v_dtype="bfloat16")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"train profile ({tag}): AdamW update alone "
          f"{min(times[1:]) * 1e3:.2f} "
          "ms (host clock, synchronized)")


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _template_counts(report) -> dict:
    counts: dict = {}
    for row in report.sites:
        key = (row["template"], row["applied"])
        counts[key] = counts.get(key, 0) + 1
    return counts


def run_train(dev, profile: bool = False, fused: bool = True,
              native: bool = True):
    """gpt3-350m at full width, the reference bench's flagship step:
    B 16, S 1024, bf16 moments, fp32 masters; best of 3 windows of 4
    steps after 3 warm-up steps. ``fused`` sets ``use_auto_fusion`` (the
    default, True, is the main path); ``native`` False sets
    ``flash_attention_native_layout`` off: the attention takes the
    head-major K17 (forward L, dq and dk/dv 2L launches a step) in place
    of K1/K2. Returns (launches of the timed windows, {step_ms, tok_s,
    mfu, peak_gib, loss0})."""
    import dataclasses

    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token, gpt_presets
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.train_step import make_train_step

    cfg = dataclasses.replace(gpt_presets("gpt3-350m"), unroll=True,
                              remat=False)
    batch, warmup, windows, win = 16, 3, 3, 4
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", fused)
    GLOBAL_FLAGS.set("flash_attention_native_layout", native)
    try:
        torch.cuda.reset_peak_memory_stats()
        step, params, opt = make_train_step(cfg, lr=1e-4, seed=0,
                                            m_dtype="bfloat16",
                                            v_dtype="bfloat16", device=dev)
        rng = np.random.RandomState(0)
        toks = step.put_batch(rng.randint(0, cfg.vocab_size,
                                          size=(batch, cfg.seq_len)))
        labs = step.put_batch(rng.randint(0, cfg.vocab_size,
                                          size=(batch, cfg.seq_len)))
        losses = []
        t0 = time.perf_counter()
        for _ in range(warmup):
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
            if len(losses) == 1:        # the first step traces the model
                t_first = time.perf_counter() - t0
        if profile:
            _profile_train(step, params, opt, toks, labs,
                           "fusion on" if fused else "fusion off")
            return {}, {}
        # the head-major kernels (K17) count too: 0 in the native layout
        counters = {**_train_counters(), "flash_fwd_hm": fa.flash_fwd_hm,
                    "flash_bwd_hm": fa.flash_bwd_hm}
        for fn in counters.values():
            fn.launches = 0
        ce_before = collections.Counter(ce.PRODUCTS)
        best = float("inf")
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(win):
                loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())     # syncs
            best = min(best, time.perf_counter() - t0)
        report = compiler.last_report() if fused else None
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
        GLOBAL_FLAGS.set("flash_attention_native_layout", True)
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = windows * win
    L = cfg.n_layers
    slabs = -(-cfg.vocab_size // ce.SLAB)
    flash = L * steps if native else 0
    want = {"flash_fwd": flash, "flash_bwd": flash,
            "flash_fwd_hm": L * steps - flash,
            "flash_bwd_hm": 2 * (L * steps - flash),
            "fused_ce_fwd": 2 * steps, "fused_ce_bwd": 3 * slabs * steps,
            "fused_norm_epilogue": (2 * L + 1) * steps if fused else 0,
            "fused_bias_act": L * steps if fused else 0}
    if launches != want:
        raise AssertionError(f"train launches {launches} != {want}")
    _check_ce_products("train", ce_before, steps, batch * cfg.seq_len,
                       cfg.hidden, cfg.vocab_size)
    if fused:
        counts = _template_counts(report)
        want_sites = {("layer_epilogue", True): 2 * L + 1,
                      ("bias_gelu", True): L}
        if counts != want_sites or report.errors:
            raise AssertionError(f"fusion report {counts} (errors "
                                 f"{report.errors}) != {want_sites}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step-1 loss {losses[0]} not near "
                             f"ln(V) = {math.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    step_s = best / win
    tok_s = batch * cfg.seq_len / step_s
    mfu = gpt_flops_per_token(cfg) * tok_s / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = ("fusion on" if fused else "fusion off") + \
        ("" if native else ", head-major layout")
    print(f"train gpt3-350m B{batch} S{cfg.seq_len} ({tag}): step "
          f"{step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
          f"(bf16 peak {BF16_FLOP_PER_S:.0e}), first step (trace "
          f"included) {t_first * 1e3:.0f} ms, losses "
          f"{[round(v, 4) for v in losses]}, launches {launches}, peak mem "
          f"{peak:.2f} GiB")
    if fused:
        print(f"train fusion report: program {report.program_hash}, "
              f"{report.n_applied}/{report.n_sites} sites applied: "
              + ", ".join(f"{c} {t}" for (t, _), c in counts.items()))
    return launches, {"step_ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
                      "peak_gib": peak, "loss0": losses[0]}


def _train_cpu_case(dev, tag: str, **cfg_kw) -> dict:
    """3 fp32 AdamW steps of a small GPT (H 256, 4 heads of 64, 2 layers,
    S 256, B 2) on the card and on the CPU from identical weights, fusion
    on for both; returns the card's launches."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.parallel.train_step import (adamw_init,
                                                      make_train_step)

    cfg = GPTConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                    seq_len=256, dtype=torch.float32,
                    param_dtype=torch.float32, **cfg_kw)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    labs = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    runs = {}
    counters = _split_counters()
    for fn in counters.values():
        fn.launches = 0
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        step, _, _ = make_train_step(cfg, lr=1e-4, device=device)
        params = {k: ({kk: vv.clone().to(device) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone().to(device))
                  for k, v in cpu_params.items()}
        opt = adamw_init(params)
        losses = []
        for _ in range(3):
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
        runs[name] = (losses, params)
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    launches = {k: fn.launches for k, fn in counters.items()}
    if not np.allclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"{tag}: losses differ: cuda {lg} vs cpu {lc}")
    worst = 0.0
    for k, v in pc.items():
        for kk, a in (v.items() if isinstance(v, dict) else [(k, v)]):
            b = pg[k][kk] if isinstance(v, dict) else pg[k]
            worst = max(worst, (a.detach() - b.detach().cpu()).abs().max()
                        .item())
    if not worst <= TRAIN_CPU_ATOL:
        raise AssertionError(f"{tag}: params differ by {worst} > "
                             f"{TRAIN_CPU_ATOL}")
    print(f"train cpu/cuda ({tag}, fusion on): losses {lg} vs {lc}, params "
          f"max diff {worst:.3e}, card launches {launches}")
    return launches


def _llama_cpu_case(dev) -> None:
    """llama_loss and its gradients of a small fp32 LLaMA (hidden 256, 2
    heads of 128, 1 kv head, 2 layers, S 256, B 2, remat on, fusion on)
    on the card (K11, K3, K6, K12) and on the CPU from identical weights:
    loss within rtol 1e-4, every gradient leaf by row within 1e-4."""
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               init_llama_params, llama_loss)

    cfg = LlamaConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_hidden=384, max_seq_len=256,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(9),
                                   "cpu")
    rng = np.random.RandomState(10)
    toks, labs = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               size=(2, 256)))
                  for _ in range(2))
    counters = _llama_counters()
    for fn in counters.values():
        fn.launches = 0
    res = {}
    for device in ("cpu", dev):
        params = {k: ({kk: vv.clone().to(device) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone().to(device))
                  for k, v in cpu_params.items()}
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = llama_loss(params, toks.to(device), labs.to(device), cfg)
        res[str(device)] = (loss.item(), torch.autograd.grad(loss, flat))
    launches = {k: fn.launches for k, fn in counters.items()}
    (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
    if not (launches["rope_flash_fwd"] and launches["flash_bwd_sep"]):
        raise AssertionError(f"llama cpu/cuda: K11 / K3 did not run: "
                             f"{launches}")
    if not np.isclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"llama cpu/cuda: loss {lg} vs {lc}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        worst = max(worst, _hold(f"llama cpu/cuda grad leaf {i}", a.cpu(),
                                 b, FP32_TOL))
    print(f"llama train cpu/cuda: loss {lg} vs {lc}, grads max abs diff "
          f"{worst:.3e}, card launches {launches}")


def check_train_cpu(dev) -> None:
    """The small fp32 GPT on the card and on the CPU from identical
    weights, fusion on: without remat (the fp32 K1/K2, K4/K5, K6 and K7
    kernels), under remat=True and "full", and with
    flash_attention_fused_dqkv off (K3 on the card); then a small fp32
    LLaMA's llama_loss gradients, card against CPU. Each case must launch
    every training kernel of its route: K1 once a layer a step under
    every remat setting, and K2 once a layer a step, or K3's two entries
    with the flag off, never both."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS

    flash = 2 * 3                        # the case's layers x steps
    for tag, kw, merged in (("remat False", dict(remat=False), True),
                            ("remat True", dict(remat=True), True),
                            ("remat full", dict(remat="full"), True),
                            ("fused_dqkv off", dict(remat=False), False)):
        GLOBAL_FLAGS.set("flash_attention_fused_dqkv", merged)
        try:
            ln = _train_cpu_case(dev, tag, **kw)
        finally:
            GLOBAL_FLAGS.set("flash_attention_fused_dqkv", True)
        want = {"flash_fwd": flash, "flash_bwd": flash if merged else 0,
                "flash_bwd_split": 0 if merged else 2 * flash}
        if any(ln[k] != n for k, n in want.items()) or \
                not all(ln[k] for k in ln if k not in want):
            raise AssertionError(f"{tag}: launches {ln}, want {want} and "
                                 "every other kernel at least once")
    _llama_cpu_case(dev)


# ---------------------------------------------------------------------------
# gpt3-1.3b training (sr-bf16, remat policies) and LLaMA's backward: K3
# ---------------------------------------------------------------------------

# bench.py's gpt3-1.3b configurations: (batch, seq, remat, steps a window)
GPT13B_RUNS = ((4, 1024, True, 4), (1, 4096, True, 3), (1, 8192, "full", 2))
GPT13B_KEYS = {1024: "gpt3_1p3b_train", 4096: "gpt3_1p3b_s4096",
               8192: "gpt3_1p3b_s8192"}


def _split_counters():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {**_train_counters(), "flash_bwd_split": fa.flash_bwd_split}


def _check_sr_state(params, opt) -> None:
    """sr-bf16: no master; >= 2-D leaves bf16, 1-D fp32; moments bf16
    (>= 2-D) and fp32 (1-D)."""
    if "master" in opt:
        raise AssertionError("sr-bf16 state holds a master copy")
    for tree, lo in ((params, torch.bfloat16), (opt["m"], torch.bfloat16),
                     (opt["v"], torch.bfloat16)):
        for leaf in _leaves(tree):
            want = lo if leaf.dim() >= 2 else torch.float32
            if leaf.dtype != want:
                raise AssertionError(f"sr-bf16 leaf {tuple(leaf.shape)} is "
                                     f"{leaf.dtype}, not {want}")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _gpt13b(dev, S: int, remat):
    from paddle_tpu_torch.models.gpt import gpt_presets
    from paddle_tpu_torch.parallel.train_step import make_train_step

    cfg = dataclasses.replace(gpt_presets("gpt3-1.3b"), seq_len=S,
                              remat=remat)
    step, params, opt = make_train_step(cfg, lr=1e-4, seed=0,
                                        m_dtype="bfloat16",
                                        v_dtype="bfloat16",
                                        weights="sr-bf16", device=dev)
    return cfg, step, params, opt


def _gpt13b_batch(step, cfg, B: int):
    rng = np.random.RandomState(0)
    return [step.put_batch(rng.randint(0, cfg.vocab_size,
                                       size=(B, cfg.seq_len)))
            for _ in range(2)]


def run_train_13b(dev) -> dict:
    """make_train_step(gpt3-1.3b) at full width (24 layers, hidden 2048,
    vocab 50304), bf16 moments, weights="sr-bf16", fusion on, random
    weights drawn on the card: bench.py's three configurations (B 4
    S 1024 remat=True; B 1 S 4096 remat=True; B 1 S 8192 remat="full"),
    3 warm-up steps and the best of 3 windows; then peak memory at S 4096
    under remat False, True and "full" on the same weights and batch (of
    the forward + backward, and of the whole step), and the AdamW update
    timed alone.
    Returns {"flash_bwd_split": launches in the timed windows}."""
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.train_step import _stochastic_round

    x = torch.full((1 << 22,), 1.0 + 1.5e-3, device=dev)
    sr = _stochastic_round(x, torch.bfloat16,
                           torch.Generator(device=dev).manual_seed(7)).float()
    vals = sorted(torch.unique(sr).tolist())
    if vals != [1.0, 1.0078125] or abs(sr.mean().item() - 1.0015) >= 5e-4:
        raise AssertionError(f"stochastic rounding on the card: values "
                             f"{vals}, mean {sr.mean().item()}")
    print(f"train 13b: stochastic rounding of 1.0015 on the card: values "
          f"{vals}, mean {sr.mean().item():.6f}")
    del x, sr
    keys, peaks, split_launches = {}, {}, 0
    for B, S, remat, win in GPT13B_RUNS:
        torch.cuda.reset_peak_memory_stats()
        cfg, step, params, opt = _gpt13b(dev, S, remat)
        _check_sr_state(params, opt)
        toks, labs = _gpt13b_batch(step, cfg, B)
        losses = []
        for _ in range(3):
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
        counters = _split_counters()
        for fn in counters.values():
            fn.launches = 0
        ce_before = collections.Counter(ce.PRODUCTS)
        best, windows = float("inf"), 3
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(win):
                loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())     # syncs
            best = min(best, time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        steps, L = windows * win, cfg.n_layers
        merged = fa.fused_dqkv_ok(S, cfg.head_dim, 2)
        slabs = -(-cfg.vocab_size // ce.SLAB)
        # K1 once a layer (both policies save o/lse); K6 and K7 run again
        # in the backward's recompute of every block (2L + 1 + 2L, 2L)
        want = {"flash_fwd": L * steps,
                "flash_bwd": L * steps if merged else 0,
                "flash_bwd_split": 0 if merged else 2 * L * steps,
                "fused_ce_fwd": 2 * steps,
                "fused_ce_bwd": 3 * slabs * steps,
                "fused_norm_epilogue": (4 * L + 1) * steps,
                "fused_bias_act": 2 * L * steps}
        if launches != want:
            raise AssertionError(f"train 13b S{S} launches {launches} != "
                                 f"{want}")
        _check_ce_products(f"train 13b S{S}", ce_before, steps, B * S,
                           cfg.hidden, cfg.vocab_size)
        split_launches += launches["flash_bwd_split"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite loss in {losses}")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            raise AssertionError(f"13b S{S} step-1 loss {losses[0]} not near "
                                 f"ln(V) = {math.log(cfg.vocab_size):.3f}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"13b S{S} loss did not fall: {losses}")
        _check_sr_state(params, opt)
        step_s = best / win
        tok_s = B * S / step_s
        mfu = gpt_flops_per_token(cfg) * tok_s / BF16_FLOP_PER_S
        peak = torch.cuda.max_memory_allocated() / 2**30
        key = GPT13B_KEYS[S]
        if S == 1024:
            keys.update({f"{key}_tokens_per_sec_per_chip": tok_s,
                         f"{key}_mfu": mfu, "gpt3_1p3b_step_ms":
                         step_s * 1e3, "gpt3_1p3b_loss": losses[-1]})
        else:
            keys.update({f"{key}_tokens_per_sec_per_chip": tok_s,
                         f"{key}_mfu": mfu, f"{key}_step_ms": step_s * 1e3})
        peaks[f"B{B} S{S} remat={remat}"] = peak
        print(f"train gpt3-1.3b B{B} S{S} remat={remat} sr-bf16: step "
              f"{step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
              f"(against {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s), backward "
              f"{'K2' if merged else 'K3'}, losses "
              f"{[round(v, 4) for v in losses]}, launches {launches}, peak "
              f"mem {peak:.2f} GiB")
        del step, params, opt, toks, labs, loss
        torch.cuda.empty_cache()
    # peak memory at S 4096 under the three remat settings, on the same
    # weights and batch: of the forward + backward (what remat changes),
    # and of the whole step (AdamW's fp32 temporaries included)
    from paddle_tpu_torch.models.gpt import loss_fn
    from paddle_tpu_torch.parallel.train_step import adamw_update

    mem, step_mem = {}, {}
    for remat in (False, True, "full"):
        cfg, step, params, opt = _gpt13b(dev, 4096, remat)
        toks, labs = _gpt13b_batch(step, cfg, 1)
        loss, params, opt = step(params, opt, toks, labs)   # traces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, params, opt = step(params, opt, toks, labs)
        torch.cuda.synchronize()
        step_mem[remat] = torch.cuda.max_memory_allocated() / 2**30
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss_fn(params, toks, labs, cfg), flat)
        torch.cuda.synchronize()
        mem[remat] = torch.cuda.max_memory_allocated() / 2**30
        del grads
        if remat == "full":
            gtree = _map_leaves(params, torch.zeros_like)
            gen = torch.Generator(device=dev).manual_seed(0)
            times = []
            with torch.no_grad():
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    adamw_update(params, gtree, opt, 1e-4,
                                 m_dtype="bfloat16", v_dtype="bfloat16",
                                 stochastic_round=True, sr_generator=gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            print(f"train gpt3-1.3b: AdamW update alone (sr-bf16, bf16 "
                  f"moments) {min(times) * 1e3:.2f} ms (host clock, "
                  "synchronized)")
            del gtree
        del step, params, opt, toks, labs, loss, flat
        torch.cuda.empty_cache()
    print(f"train gpt3-1.3b B1 S4096 peak memory: forward + backward, "
          f"remat False {mem[False]:.2f} GiB, True {mem[True]:.2f} GiB, "
          f"full {mem['full']:.2f} GiB; whole step {step_mem[False]:.2f} / "
          f"{step_mem[True]:.2f} / {step_mem['full']:.2f} GiB")
    if not mem[False] > mem[True] > mem["full"]:
        raise AssertionError(f"forward + backward peak memory not False > "
                             f"True > full: {mem}")
    keys["peak_gib"] = peaks
    print("train 13b bench.py keys (MFU against 989 TFLOP/s): "
          + json.dumps(keys))
    return {"flash_bwd_split": split_launches}


def _llama_counters():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    return {"rope_flash_fwd": fra.rope_flash_fwd,
            "flash_fwd_sep": fa.flash_fwd_sep,
            "flash_bwd_sep": fa.flash_bwd_sep, "flash_bwd": fa.flash_bwd,
            "flash_bwd_split": fa.flash_bwd_split,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "swiglu": fba.swiglu_fwd}


def _llama_want(L: int, fused: bool) -> tuple[dict, dict]:
    """Launches of one forward and of its backward: remat recomputes
    every block whole (the reference's jax.checkpoint), so the block's
    forward kernels run again in the backward, then K3 twice a layer."""
    fwd = dict.fromkeys(_llama_counters(), 0)
    if fused:
        fwd.update(rope_flash_fwd=L, fused_norm_epilogue=2 * L + 1,
                   swiglu=L)
        bwd = dict(fwd, fused_norm_epilogue=2 * L)
    else:
        fwd.update(flash_fwd_sep=L)
        bwd = dict(fwd)
    bwd["flash_bwd_sep"] = 2 * L
    return fwd, bwd


def run_llama_train(dev) -> dict:
    """Gradients of llama_loss at llama1b (vocab 32000, hidden 2048, 16
    layers, 16 heads, 4 kv heads, ffn 5504, bf16; random weights from
    seed 0 on the card), B 2, S 2048, remat=True, with the fusion
    compiler on (K11 + its backward through K3) and off (K1-sep + K3):
    launches of the forward and the backward counted apart, finite loss
    and gradients, each route's gradients held to fp32 ones taken with
    plain attention (no port kernel) within LLAMA_GRAD_TOL, the fused
    route no further from them than the unfused one; a bf16 control on
    the same plain path is held and printed beside them. Returns
    {"flash_bwd_sep": launches of one fused backward}."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               init_llama_params, llama_loss)

    cfg = LlamaConfig(**LLAMA1B, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    L, B, S = cfg.n_layers, 2, 2048
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    flat = _leaves(params)
    for p in flat:
        p.requires_grad_(True)
    rng = np.random.RandomState(0)
    toks, labs = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               size=(B, S))).to(dev)
                  for _ in range(2))
    counters = _llama_counters()
    grads, out = {}, {}
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    try:
        for fused in (True, False):
            GLOBAL_FLAGS.set("use_auto_fusion", fused)
            torch.autograd.grad(llama_loss(params, toks, labs, cfg), flat)
            torch.cuda.synchronize()         # the first call traces
            fwd_ms, bwd_ms = [], []
            for it in range(3):
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss = llama_loss(params, toks, labs, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fwd_n = {k: fn.launches for k, fn in counters.items()}
                g = torch.autograd.grad(loss, flat)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                bwd_n = {k: fn.launches - fwd_n[k]
                         for k, fn in counters.items()}
                fwd_ms.append((t1 - t0) * 1e3)
                bwd_ms.append((t2 - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = _llama_want(L, fused)
            if (fwd_n, bwd_n) != want:
                raise AssertionError(f"llama train fused={fused}: launches "
                                     f"fwd {fwd_n} bwd {bwd_n} != {want}")
            if not math.isfinite(loss.item()) or not all(
                    torch.isfinite(t).all().item() for t in g):
                raise AssertionError(f"llama train fused={fused}: "
                                     "non-finite loss or gradient")
            if abs(loss.item() - math.log(cfg.vocab_size)) > 0.5:
                raise AssertionError(f"llama loss {loss.item()} not near "
                                     f"ln(V)")
            grads[fused] = g
            out[fused] = bwd_n
            print(f"llama train llama1b B{B} S{S} bf16 remat (fusion "
                  f"{'on' if fused else 'off'}): loss {loss.item():.4f}, "
                  f"forward {min(fwd_ms):.2f} ms, backward "
                  f"{min(bwd_ms):.2f} ms, peak mem {peak:.2f} GiB, "
                  f"launches fwd {fwd_n} bwd {bwd_n}")
            del loss, g
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    # the two routes round differently (K6's sums, K12) and the bf16
    # differences compound through 16 layers' backward: each route is
    # held to fp32 gradients taken on block_apply's plain attention
    # (weights cast up, fusion off: no port kernel runs), within
    # LLAMA_GRAD_TOL by the mean over leaves and by the worst leaf, and
    # the fused one no further from them than FUSED_VS_FP32 x the
    # unfused one, as the decode phase holds its logits
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = _map_leaves(params, lambda t: t.detach().float()
                      .requires_grad_(True))
    loss32, g32 = _plain_attention_grads(p32, toks, labs, cfg32)
    _, grads["control"] = _plain_attention_grads(params, toks, labs, cfg)
    names = [f"{k}.{kk}" if isinstance(v, dict) else k
             for k, v in params.items()
             for kk in (v if isinstance(v, dict) else [None])]
    rel = {k: [] for k in grads}
    for i, ref in enumerate(g32):
        scale = ref.abs().mean().item()
        for k in grads:
            rel[k].append((grads[k][i].float() - ref).abs().mean().item()
                          / scale)
    agg = {k: sum(v) / len(v) for k, v in rel.items()}
    vs = max(_scaled_err(a, b, dim=0 if n == "head" else -1)[1]
             for n, a, b in zip(names, grads[True], grads[False]))
    for k, tag in ((True, "fused"), (False, "unfused"),
                   ("control", "bf16 plain attention")):
        worst = max(range(len(names)), key=lambda i: rel[k][i])
        print(f"llama train grads against fp32 plain attention (loss "
              f"{loss32.item():.4f}), {tag}: mean relative error over "
              f"{len(names)} leaves {agg[k]:.4e}, worst leaf {names[worst]} "
              f"{rel[k][worst]:.4e} (limits {LLAMA_GRAD_TOL[0]}, "
              f"{LLAMA_GRAD_TOL[1]})")
        if not (agg[k] <= LLAMA_GRAD_TOL[0] and
                rel[k][worst] <= LLAMA_GRAD_TOL[1]):
            raise AssertionError(f"llama grads ({tag}) too far from fp32: "
                                 f"mean {agg[k]}, {names[worst]} "
                                 f"{rel[k][worst]}")
    print(f"llama train grads: fused vs unfused max scaled {vs:.4e}")
    if not agg[True] <= FUSED_VS_FP32 * agg[False]:
        raise AssertionError(f"llama grads: the fused route is further "
                             f"from fp32 than the unfused one: {agg}")
    return {"flash_bwd_sep": out[True]["flash_bwd_sep"]}


def _plain_attention_grads(params, toks, labs, cfg):
    """(loss, gradients) of llama_loss with fusion off and block_apply's
    attention on its plain branch (``_sdpa``): asserts that no port
    kernel launched."""
    from unittest import mock

    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models import llama as lm

    counters = _llama_counters()
    for fn in counters.values():
        fn.launches = 0
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", False)
    try:
        with mock.patch.object(lm, "flash_supported", lambda *a: False):
            loss = lm.llama_loss(params, toks, labs, cfg)
            grads = torch.autograd.grad(loss, _leaves(params))
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if ran:
        raise AssertionError(f"plain-attention llama ran kernels: {ran}")
    return loss, grads


# ---------------------------------------------------------------------------
# LLaMA prefill + decode engine (LlamaForCausalLM): K10, K11, K12, K1-sep
# ---------------------------------------------------------------------------

LLAMA1B = dict(vocab_size=32000, hidden=2048, n_layers=16, n_heads=16,
               n_kv_heads=4, ffn_hidden=5504, max_seq_len=2048)
DECODE_PROMPT, DECODE_NEW = 512, 128
FUSED_VS_FP32 = 1.1              # fused / unfused mean logit error vs fp32
LLAMA_GRAD_TOL = (0.045, 0.054)  # llama1b bf16 gradients vs fp32, mean
                                 # relative error over leaves and worst
                                 # leaf: 1.5x the largest readings (3.0010e-2,
                                 # blocks.wk 3.5701e-2) against fp32
DECODE_LOGIT_TOL = 0.18          # bf16 engine vs fp32 logits, scaled: 1.5x
                                 # the largest reading (0.1230, unfused;
                                 # fused 0.1175) of 128 forced llama1b steps


def _decode_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    return {"decode_attention": da.decode_attention,
            "rope_flash_fwd": fra.rope_flash_fwd, "swiglu": fba.swiglu_fwd,
            "flash_fwd_sep": fa.flash_fwd_sep,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "quant_matmul": quant_matmul}


def _counted(fn, counters_of=_decode_counters):
    """(fn(), launches of a path's kernels during it): every count set to
    0 just before, read just after."""
    counters = counters_of()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def _allocations(fn):
    """(fn(), the caching allocator's allocations during it)."""
    key = "allocation.all.allocated"
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()[key]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()[key] - before


def _check_decode_plan(B, nKV, G, S, d, pos, dtype, quant) -> None:
    """K10's C launcher plans the launch as decode_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    want = da.decode_plan(B, nKV, G, d, pos, dtype, quant)
    got = da.decode_plan_c(B, nKV, G, S, d, pos, dtype, quant)
    if got != want:
        raise AssertionError(f"decode_plan_c {got} != decode_plan {want} "
                             f"at B{B} nKV{nKV} G{G} d{d} pos {pos} {dtype} "
                             f"quant {quant}")


def check_decode_attention(dev) -> dict:
    """K10 at the llama1b decode shapes: B 1, 8, 16, nKV 4, G 4, S 2048,
    d 128, bf16, pos 0 (the first chunk alone), 100 (a ragged chunk), 511
    and 639 (the prompt's end and the last step of a 128-token decode),
    2047 (the whole cache); once in fp32."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(11)
    nKV, G, S, d = 4, 4, 2048, 128
    scale = d ** -0.5
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = [(B, torch.bfloat16) for B in (1, 8, 16)] + [(2, torch.float32)]
    for B, dt in cases:
        q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(dt)
        ck = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(dt)
        cv = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(dt)
        for pos in (0, 100, 511, 639, 2047):
            _check_decode_plan(B, nKV, G, S, d, pos, dt, False)
            got, n_alloc = _allocations(
                lambda: da.decode_attention(q, ck, cv, pos, scale))
            if n_alloc != 1:
                raise AssertionError(f"K10 B{B} pos {pos}: {n_alloc} "
                                     "allocations a call, want the output's")
            ref = da.decode_attention_plain(q, ck, cv, pos, scale)
            again = da.decode_attention(q, ck, cv, pos, scale)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("K10 is not deterministic")
            tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
            worst[dt] = max(worst[dt], _hold(
                f"K10 {dt} B{B} pos {pos}", got, ref, tol))
    B, pos = 16, DECODE_PROMPT + DECODE_NEW - 1
    q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    ck = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16)
    fn = lambda: da.decode_attention(q, ck, cv, pos, scale)  # noqa: E731
    ms, device_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: da.decode_attention_plain(q, ck, cv, pos,
                                                          scale))
    # library yardstick: SDPA on the repeated cache cut at pos
    qh = q[:, :, None, :]
    kr = ck[:, :, :pos + 1].repeat_interleave(G, dim=1)
    vr = cv[:, :, :pos + 1].repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qh, kr, vr, scale=scale)  # noqa: E731
    library_ms, library_device_ms = _time_ms(lib), _graph_ms(lib)
    nbytes = 2 * B * nKV * (pos + 1) * d * 2 + 2 * q.numel() * 2
    bound_ms, bound_by = _bound(nbytes, 4.0 * B * nKV * G * (pos + 1) * d)
    print(f"K10 bf16 B{B} pos {pos}: kernel {ms:.4f} ms (device "
          f"{device_ms:.4f}), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms (device {library_device_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/decode_attention.py:74",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_fp32": worst[torch.float32], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": f"B{B} nKV{nKV} G{G} S{S} d{d} pos {pos} bf16"}


def check_decode_int8(dev) -> dict:
    """K10q at K10's shapes (B 16, nKV 4, G 4, S 2048, d 128), int8 caches
    with [B, nKV, S] fp32 scales, bf16 and fp32 q, at five positions:
    equal to K10 on the pre-dequantized cache (torch.equal) and within
    K10's tolerance of the plain version."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.quant import dequantize_int8

    gen = torch.Generator(device=dev).manual_seed(23)
    B, nKV, G, S, d = 16, 4, 4, 2048, 128
    scale = d ** -0.5
    kq, vq = (torch.randint(-127, 128, (B, nKV, S, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, nKV, S), generator=gen, device=dev) * 0.02
              + 0.01 for _ in range(2))
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(dt)
        kd = dequantize_int8(kq, ks[..., None], dt)
        vd = dequantize_int8(vq, vs[..., None], dt)
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        worst[dt] = 0.0
        for pos in (0, 100, 511, 639, 2047):
            _check_decode_plan(B, nKV, G, S, d, pos, dt, True)
            got, n_alloc = _allocations(lambda: da.decode_attention_int8(
                q, kq, vq, ks, vs, pos, scale))
            if n_alloc != 1:
                raise AssertionError(f"K10q pos {pos}: {n_alloc} "
                                     "allocations a call, want the output's")
            k10 = da.decode_attention(q, kd, vd, pos, scale)
            ref = da.decode_attention_plain(q, kq, vq, pos, scale, ks, vs)
            torch.cuda.synchronize()
            if not torch.equal(got, k10):
                raise AssertionError(f"K10q {dt} pos {pos}: differs from "
                                     "K10 on the pre-dequantized cache")
            worst[dt] = max(worst[dt], _hold(f"K10q {dt} pos {pos}", got,
                                             ref, tol))
    pos = DECODE_PROMPT + DECODE_NEW - 1
    fn = lambda: da.decode_attention_int8(  # noqa: E731
        q, kq, vq, ks, vs, pos, scale)
    ms, device_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: da.decode_attention_plain(
        q, kq, vq, pos, scale, ks, vs))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kr = kd[:, :, :pos + 1].repeat_interleave(G, dim=1)
    vr = vd[:, :, :pos + 1].repeat_interleave(G, dim=1)
    qh = q[:, :, None, :]
    lib = lambda: sdpa(qh, kr, vr, scale=scale)  # noqa: E731
    library_ms, library_device_ms = _time_ms(lib), _graph_ms(lib)
    nbytes = 2 * B * nKV * (pos + 1) * (d + 4) + 2 * q.numel() * 2
    bound_ms, bound_by = _bound(nbytes, 4.0 * B * nKV * G * (pos + 1) * d)
    print(f"K10q bf16 B{B} pos {pos}: equal to K10 on dequantized caches; "
          f"kernel {ms:.4f} ms (device {device_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa on the dequantized repeated cache "
          f"{library_ms:.4f} ms (device {library_device_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/decode_attention.py:74",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_fp32": worst[torch.float32], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": f"B{B} nKV{nKV} G{G} S{S} d{d} pos {pos} int8"}


def _rope_case(gen, dev, B, S, h, d, dt):
    from paddle_tpu_torch.models.llama import LlamaConfig, rope_angles

    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev).to(dt)
               for _ in range(3))
    cfg = LlamaConfig(hidden=h * d, n_heads=h)
    cos, sin = rope_angles(cfg, torch.arange(S, device=dev))
    return q, k, v, cos, sin


def check_rope_flash(dev) -> tuple[dict, dict]:
    """K11 at the llama1b prefill shapes ([1, 512, 16, 128] and [16, 512,
    16, 128] bf16, q rotated alone and with k) and small fp32 cases at
    head dims 128 and 256; and K1's separate-input mode at [1, 512, 16,
    128]. K11 must equal K1-separate on apply_rope'd inputs bit for bit:
    the same tile loop, so any difference is the in-tile rotation."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = [((1, 512, 16, 128), torch.bfloat16),
             ((16, 512, 16, 128), torch.bfloat16),
             ((2, 128, 2, 128), torch.float32),
             ((2, 128, 1, 256), torch.float32)]
    for shape, dt in cases:
        q, k, v, cos, sin = _rope_case(gen, dev, *shape, dt)
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        scale = shape[-1] ** -0.5
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        for rope_k in (False, True):
            got = fra.rope_flash_fwd(q, k, v, cos, sin, True, scale, True,
                                     rope_k)[0]
            ref = fra.rope_flash_plain(q, k, v, cos, sin, True, scale, True,
                                       rope_k)[0]
            qr = fra._apply_rope_ref(q, cb, sb)
            kr = fra._apply_rope_ref(k, cb, sb) if rope_k else k
            k1 = fa.flash_fwd_sep(qr, kr, v, True, scale)[0]
            torch.cuda.synchronize()
            tag = f"K11 {dt} {list(shape)} rope_k={rope_k}"
            if not torch.equal(got, k1):
                raise AssertionError(f"{tag}: not bit-equal to K1 on the "
                                     "apply_rope'd inputs (the rotation "
                                     "in the tile is off)")
            worst[dt] = max(worst[dt], _hold(tag + " (== K1 on rotated)",
                                             got, ref, tol))
    q, k, v, cos, sin = _rope_case(gen, dev, 1, 512, 16, 128, torch.bfloat16)
    scale = 128 ** -0.5
    got = fa.flash_fwd_sep(q, k, v, True, scale)[0]
    ref = fa.flash_sep_plain(q, k, v, True, scale)[0]
    torch.cuda.synchronize()
    err_sep = _hold("K1-separate bf16 [1, 512, 16, 128]", got, ref, BF16_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timings(B):
        q, k, v, cos, sin = _rope_case(gen, dev, B, 512, 16, 128,
                                       torch.bfloat16)
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (
            fra._apply_rope_ref(q, cb, sb), fra._apply_rope_ref(k, cb, sb),
            v))
        lib = _time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        lib_dev = _graph_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        pairs = B * 16 * 512 * 513 / 2
        bound = _bound(4 * q.numel() * 2, 4.0 * 128 * pairs)
        return q, k, v, cos, sin, lib, lib_dev, bound

    def rope_then_sdpa(q, k, v, cos, sin):
        """The composition K11 fuses, q rotated alone: apply_rope on q,
        then SDPA on head-major operands (k, v already rotated)."""
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        qh = fra._apply_rope_ref(q, cb, sb).transpose(1, 2)
        return sdpa(qh, k.transpose(1, 2), v.transpose(1, 2), is_causal=True)

    q, k, v, cos, sin, lib_rope, lib_rope_dev, b_rope = timings(16)
    k11 = lambda: fra.rope_flash_fwd(q, k, v, cos, sin, True, scale, True,
                                     False)
    ms_rope = _time_ms(k11)
    dev_rope = _graph_ms(k11)
    comp_ms = _time_ms(lambda: rope_then_sdpa(q, k, v, cos, sin))
    comp_dev = _graph_ms(lambda: rope_then_sdpa(q, k, v, cos, sin))
    plain_rope = _time_ms(lambda: fra.rope_flash_plain(
        q, k, v, cos, sin, True, scale, True, False), iters=5, warmup=1)
    # the same tile loop without the rotation: K1-sep on q rotated before
    qr = fra._apply_rope_ref(q, cos[None, :, None, :], sin[None, :, None, :])
    unrot_dev = _graph_ms(lambda: fa.flash_fwd_sep(qr, k, v, True, scale))
    print(f"K11 bf16 [16, 512, 16, 128] q only: kernel {ms_rope:.4f} ms "
          f"(device {dev_rope:.4f}), plain {plain_rope:.4f} ms, sdpa on "
          f"rotated q/k {lib_rope:.4f} ms (device {lib_rope_dev:.4f}), "
          f"apply_rope + sdpa {comp_ms:.4f} ms (device {comp_dev:.4f}), "
          f"K1-sep on the rotated q (the loop without the rotation) device "
          f"{unrot_dev:.4f} ms, bound {b_rope[0]:.4f} ms ({b_rope[1]})")
    q, k, v, cos, sin, lib_sep, lib_sep_dev, b_sep = timings(1)
    ms_sep = _time_ms(lambda: fa.flash_fwd_sep(q, k, v, True, scale))
    dev_sep = _graph_ms(lambda: fa.flash_fwd_sep(q, k, v, True, scale))
    plain_sep = _time_ms(lambda: fa.flash_sep_plain(q, k, v, True, scale),
                         iters=5, warmup=1)
    print(f"K1-separate bf16 [1, 512, 16, 128]: kernel {ms_sep:.4f} ms "
          f"(device {dev_sep:.4f}), plain {plain_sep:.4f} ms, sdpa "
          f"{lib_sep:.4f} ms (device {lib_sep_dev:.4f}), bound "
          f"{b_sep[0]:.4f} ms ({b_sep[1]})")
    return ({"name": "rope_flash_fwd", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/fused_rope_attention.cu",
             "replaces": "paddle_tpu/ops/pallas/fused_rope_attention.py:116",
             "max_abs_err": worst[torch.bfloat16],
             "max_abs_err_fp32": worst[torch.float32], "ms": ms_rope,
             "device_ms": dev_rope, "plain_ms": plain_rope,
             "bound_ms": b_rope[0], "bound_by": b_rope[1],
             "library_ms": lib_rope, "library_device_ms": lib_rope_dev,
             "rope_then_sdpa_ms": comp_ms, "unrotated_device_ms": unrot_dev,
             "shape": "B16 S512 h16 d128 causal, q rotated, bf16"},
            {"name": "flash_fwd_sep", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_attention.cu",
             "replaces": "paddle_tpu/ops/pallas/flash_attention.py:139",
             "max_abs_err": err_sep, "ms": ms_sep, "device_ms": dev_sep,
             "plain_ms": plain_sep, "bound_ms": b_sep[0],
             "bound_by": b_sep[1], "library_ms": lib_sep,
             "shape": "B1 S512 h16 d128 causal, separate q/k/v, bf16"})


def check_swiglu(dev) -> dict:
    """K12 at the llama1b prefill FFN shapes ([512, 5504] at B 1, [8192,
    5504] at B 16), llama3-8b's ([512, 14336]) in bf16, and a small fp32
    case."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (n, f), dt in (((512, 5504), torch.bfloat16),
                       ((8192, 5504), torch.bfloat16),
                       ((512, 14336), torch.bfloat16),
                       ((512, 256), torch.float32)):
        g = (2.0 * torch.randn((n, f), generator=gen, device=dev)).to(dt)
        u = torch.randn((n, f), generator=gen, device=dev).to(dt)
        y = fba.swiglu_fwd(g, u)
        ref = fba.swiglu_plain(g, u)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        errs[dt] = max(errs[dt], _hold(
            f"K12 {dt} [{n}, {f}] (bit-equal: {torch.equal(y, ref)})", y,
            ref, tol))
    g = (2.0 * torch.randn((8192, 5504), generator=gen, device=dev)).to(
        torch.bfloat16)
    u = torch.randn((8192, 5504), generator=gen, device=dev).to(
        torch.bfloat16)
    ms = _time_ms(lambda: fba.swiglu_fwd(g, u))
    plain_ms = _time_ms(lambda: fba.swiglu_plain(g, u))
    g32 = g.float()
    silu_ms = _time_ms(lambda: torch.nn.functional.silu(g32))
    N, Fd = g.shape
    bound_ms, bound_by = _bound(3 * N * Fd * 2, 6.0 * N * Fd,
                                FP32_FLOP_PER_S)
    print(f"K12 swiglu bf16 [{N}, {Fd}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no single library call (F.silu on the fp32 "
          f"gate alone {silu_ms:.4f} ms), bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"name": "swiglu", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_bias_act.py:97",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "silu_fp32_ms": silu_ms,
            "shape": f"N{N} F{Fd} bf16"}


def check_llama_norm_epilogue(dev) -> None:
    """K6 in the rms form at the llama1b prefill's shapes ([512, 2048] at
    B 1, [8192, 2048] at B 16, bf16 gains as the weights are): the
    residual form (ffn_norm and the next layer's attn_norm) and the
    norm-only form (layer 0's attn_norm, the final norm)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {torch.bfloat16: 0.0}
    H, bf = LLAMA1B["hidden"], torch.bfloat16
    for n in (DECODE_PROMPT, 16 * DECODE_PROMPT):
        for form, sub in (("residual", True), ("norm-only", False)):
            _norm_case(gen, dev, worst, f"rms {form} bf16 [{n}, {H}]", n, H,
                       bf, "rms", sub, False, False, gain_dtype=bf)


def _forced_logits(m, prompt: torch.Tensor, toks: np.ndarray):
    """The logits an engine picks each token of ``toks`` from when it is
    fed ``toks`` (teacher forcing): the prefill's, then one decode step
    per token but the last. fp32 [n, B, V]."""
    with torch.no_grad():
        cache = m._empty_cache(prompt.shape[0])
        logits, cache = m._prefill_impl(prompt, cache)
        out, T = [logits], prompt.shape[1]
        for s in range(toks.shape[1] - 1):
            tok = torch.from_numpy(toks[:, s]).to(prompt.device)
            logits, cache = m._decode_impl(cache, tok, T + s)
            out.append(logits)
    return torch.stack(out).float()


def _logits_at(m, prompt: torch.Tensor, toks: np.ndarray, j: int):
    """The logits the engine picked token j from."""
    return _forced_logits(m, prompt, toks[:, :j + 1])[-1]


def _streams_agree(tag, m_ref, prompt, ref, got) -> int:
    """Rows of ``got`` must equal ``ref``'s except from a token where
    ``m_ref``'s logits (recomputed there) of the two picks are within
    MARGIN of each other: a near-tie, which for a runner-up pick is the
    top-2 margin. Returns the number of such rows."""
    exceptions = 0
    for b in range(ref.shape[0]):
        diff = np.nonzero(ref[b] != got[b])[0]
        if not len(diff):
            continue
        j = int(diff[0])
        logits = _logits_at(m_ref, prompt, ref, j)[b].float()
        top = torch.topk(logits, 2)
        margin = (top.values[0] - top.values[1]).item()
        gap = (logits[int(ref[b, j])] - logits[int(got[b, j])]).item()
        print(f"{tag}: row {b} differs at token {j}: tokens {ref[b, j]} vs "
              f"{got[b, j]}, logit gap {gap:.3e} (limit {MARGIN:.3e}), "
              f"top-2 {top.indices.tolist()} margin {margin:.3e}")
        if not 0.0 <= gap < MARGIN:
            raise AssertionError(f"{tag}: row {b} differs at token {j} "
                                 f"with logit gap {gap}")
        exceptions += 1
    return exceptions


def _fusion_off_agrees(m, cfg, params, prompt, on: np.ndarray,
                       off: np.ndarray) -> str:
    """The unfused engine against the fused one (bf16), by teacher
    forcing: the fused engine's greedy stream ``on`` is fed to three
    engines — the fused one, the unfused one and an fp32 one (weights
    cast up, fusion off) — and the logits of every step are held, so a
    near-tie that parts the two greedy streams ends no comparison.
    - Each engine's picks from its forced logits are its own stream (the
      unfused one's up to where ``off`` parts from ``on``).
    - Each bf16 engine's logits are held to the fp32 engine's by
      _scaled_err along the vocab, within DECODE_LOGIT_TOL.
    - The fused engine is no further from fp32 than the unfused one:
      mean absolute error within FUSED_VS_FP32 of the unfused one's."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    was = GLOBAL_FLAGS.get("use_auto_fusion")
    logits = {}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = LlamaForCausalLM(cfg32, params=_map_leaves(params,
                                                     torch.Tensor.float),
                           max_batch=1, max_seq_len=m.max_seq,
                           device=prompt.device)
    try:
        for name, fused, eng in (("fused", True, m), ("unfused", False, m),
                                 ("fp32", False, m32)):
            GLOBAL_FLAGS.set("use_auto_fusion", fused)
            logits[name] = _forced_logits(eng, prompt, on)
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    del m32
    n = on.shape[1]
    parted = np.nonzero((on != off).any(axis=0))[0]
    j = int(parted[0]) if len(parted) else n
    picks = {k: v.argmax(-1).t().cpu().numpy() for k, v in logits.items()}
    if not (np.array_equal(picks["fused"], on)
            and np.array_equal(picks["unfused"][:, :j + 1],
                               off[:, :j + 1])):
        raise AssertionError("fusion off vs on: the forced logits do not "
                             "give the engines' own streams")
    ref = logits["fp32"]
    stats = {}
    for k in ("fused", "unfused"):
        err, scaled = _scaled_err(logits[k], ref)
        stats[k] = ((logits[k] - ref).abs().mean().item(), err, scaled)
    vs = _scaled_err(logits["fused"], logits["unfused"])
    print(f"fusion off vs on: {n} teacher-forced steps against fp32: mean "
          "/ max abs / max scaled logit error fused "
          "{:.4e} / {:.4e} / {:.4e}, unfused {:.4e} / {:.4e} / {:.4e}; "
          "fused vs unfused max abs {:.4e}, scaled {:.4e} (tol {:.3e}); "
          "fp32 picks equal the fused stream at {:.3f} of tokens".format(
              *stats["fused"], *stats["unfused"], *vs, DECODE_LOGIT_TOL,
              (picks["fp32"] == on).mean()))
    if not max(stats["fused"][2], stats["unfused"][2]) <= DECODE_LOGIT_TOL:
        raise AssertionError(f"decode logits against fp32: {stats}")
    if not stats["fused"][0] <= FUSED_VS_FP32 * stats["unfused"][0]:
        raise AssertionError(f"the fused engine is further from fp32 "
                             f"than the unfused one: {stats}")
    if j == n:
        return "greedy streams equal"
    return f"greedy streams equal up to token {j} of {n}"


def _timed_generate(m, prompt, k, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = m.generate(prompt, max_new_tokens=k, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _check_generate_launches(tag, L, new, ln, int8=False, fused=True):
    want = {"decode_attention": L * (new - 1),
            "rope_flash_fwd": L if fused else 0,
            "swiglu": L if fused else 0,
            "flash_fwd_sep": 0 if fused else L,
            "fused_norm_epilogue": 2 * L + 1 if fused else 0,
            "quant_matmul": (7 * L + 1) * new if int8 else 0}
    if ln != want:
        raise AssertionError(f"{tag}: launches {ln} != {want}")


def _check_fusion_report(L) -> str:
    from paddle_tpu_torch import compiler

    rep = compiler.last_report()
    counts = _template_counts(rep)
    want = {("rms_epilogue", True): 2 * L + 1, ("rope_attention", True): L,
            ("swiglu", True): L}
    if counts != want or rep.errors:
        raise AssertionError(f"prefill fusion report {counts} (errors "
                             f"{rep.errors}) != {want}")
    return (f"program {rep.program_hash}, {rep.n_applied}/{rep.n_sites} "
            "sites applied: " + ", ".join(f"{c} {t}" for (t, _), c
                                          in counts.items()))


def run_decode(dev) -> dict:
    """LlamaForCausalLM at llama1b, random bf16 weights drawn on the card
    from seed 0, the reference bench's decode protocol (bench.py
    _bench_decode): prompts of 512 tokens from RandomState(0), prefill ms
    (max_new_tokens=1) and decode tokens/s by prefill subtraction, min of
    2 each after a warm-up call of each, at B 1, 8 and 16, 128 new tokens,
    greedy; then a sampled generate at B 8, the weight-only int8 engine
    at B 8, the fusion-off engine at B 1 against the fused one (teacher
    forced, each held to an fp32 engine), a profiled decode window, and
    llama3-8b at B 1 (32 new tokens). Each run's launches are checked
    with its counts set to 0 just before it. Returns the main path's own
    counts: K10, K11 and K12 from the B 16 greedy generate, K1's
    separate-input mode from the fusion-off one."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               init_llama_params,
                                               llama_presets)

    cfg = LlamaConfig(**LLAMA1B)
    L, n = cfg.n_layers, DECODE_NEW
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.RandomState(0)
    counts = {}
    results, greedy_b1, greedy_b8, prompts, report = {}, None, None, {}, ""
    for B in (1, 8, 16):
        m = LlamaForCausalLM(cfg, params=params, max_batch=B,
                             max_seq_len=cfg.max_seq_len, device=dev)
        prompts[B] = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (B, DECODE_PROMPT))).to(dev)
        (_, toks), ln = _counted(lambda: _timed_generate(m, prompts[B], n))
        _check_generate_launches(f"decode B{B}", L, n, ln)
        if B == 16:
            counts.update((k, ln[k]) for k in ("decode_attention",
                                               "rope_flash_fwd", "swiglu"))
        report = _check_fusion_report(L)
        if toks.shape != (B, n) or not ((toks >= 0) & (toks < cfg.vocab_size)
                                        ).all():
            raise AssertionError(f"decode B{B}: tokens {toks.shape} out of "
                                 "range")
        _timed_generate(m, prompts[B], 1)
        t_pre = min(_timed_generate(m, prompts[B], 1)[0] for _ in range(2))
        runs = [_timed_generate(m, prompts[B], n) for _ in range(2)]
        for _, again in runs:
            if not np.array_equal(again, toks):
                raise AssertionError(f"decode B{B}: greedy stream changed "
                                     "between calls")
        dt = min(t for t, _ in runs) - t_pre
        results[B] = (t_pre * 1e3, B * (n - 1) / dt)
        print(f"decode llama1b B{B}: prefill {DECODE_PROMPT} tokens "
              f"{t_pre * 1e3:.2f} ms, decode {B * (n - 1) / dt:.1f} "
              f"tokens/s ({dt / (n - 1) * 1e3:.2f} ms/step), launches per "
              f"generate {ln}")
        if B == 1:
            greedy_b1 = (m, toks)
        if B == 8:
            greedy_b8 = toks
            (_, samp), ln = _counted(lambda: _timed_generate(
                m, prompts[8], n, temperature=0.8, top_p=0.9, seed=1))
            _check_generate_launches("sampled B8", L, n, ln)
            if samp.shape != (8, n) or np.array_equal(samp, toks):
                raise AssertionError("sampled B8: shape or stream wrong")
            print(f"decode llama1b B8 sampled (T 0.8, top_p 0.9): "
                  f"{(samp == toks).mean():.3f} of tokens equal the greedy "
                  "stream's")
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                wall, _ = _timed_generate(m, prompts[8], 32)
            _print_profile(prof, {"wall_s": wall})
        del m
        torch.cuda.empty_cache()
    print(f"decode fusion report: {report}")

    # weight-only int8 at B 8
    mq = LlamaForCausalLM(dataclasses.replace(cfg, weight_only_int8=True),
                          params=params, max_batch=8, device=dev)
    (_, qtoks), ln = _counted(lambda: _timed_generate(mq, prompts[8], n))
    _check_generate_launches("int8 B8", L, n, ln, int8=True)
    _timed_generate(mq, prompts[8], 1)
    tq = min(_timed_generate(mq, prompts[8], 1)[0] for _ in range(2))
    dq = min(_timed_generate(mq, prompts[8], n)[0] for _ in range(2)) - tq
    results["int8"] = (tq * 1e3, 8 * (n - 1) / dq)
    print(f"decode llama1b int8 B8: prefill {tq * 1e3:.2f} ms, decode "
          f"{8 * (n - 1) / dq:.1f} tokens/s, launches per generate {ln}; "
          f"{(qtoks == greedy_b8).mean():.3f} of greedy tokens equal the "
          "bf16 engine's (random weights: near-flat logits)")
    del mq
    torch.cuda.empty_cache()

    # fusion off at B 1: the prefill through K1-separate and plain
    # composition, held to the fused greedy stream
    m, toks = greedy_b1
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", False)
    try:
        (_, off), ln = _counted(lambda: _timed_generate(m, prompts[1], n))
        t_off = min(_timed_generate(m, prompts[1], 1)[0] for _ in range(2))
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    _check_generate_launches("fusion off B1", L, n, ln, fused=False)
    counts["flash_fwd_sep"] = ln["flash_fwd_sep"]
    agree = _fusion_off_agrees(m, cfg, params, prompts[1], toks, off)
    print(f"decode fusion off B1: prefill {t_off * 1e3:.2f} ms (fused "
          f"{results[1][0]:.2f}); {agree}")
    del m, greedy_b1
    del params
    torch.cuda.empty_cache()

    # llama3-8b at B 1
    cfg8 = llama_presets("llama3-8b")
    m8 = LlamaForCausalLM(cfg8, max_batch=1, max_seq_len=2048, device=dev)
    p8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg8.vocab_size, (1, DECODE_PROMPT))).to(dev)
    (_, t8), ln = _counted(lambda: _timed_generate(m8, p8, 32))
    _check_generate_launches("llama3-8b B1", cfg8.n_layers, 32, ln)
    _check_fusion_report(cfg8.n_layers)
    t_pre8 = min(_timed_generate(m8, p8, 1)[0] for _ in range(2))
    t_all8 = min(_timed_generate(m8, p8, 32)[0] for _ in range(2))
    print(f"decode llama3-8b B1: prefill {t_pre8 * 1e3:.2f} ms, decode "
          f"{31 / (t_all8 - t_pre8):.1f} tokens/s, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del m8
    torch.cuda.empty_cache()
    return counts


def check_decode_cpu(dev) -> None:
    """A small fp32 LLaMA (head dim 128, G 2) generating on the card and
    on the CPU from identical weights, fusion on for both: the card runs
    K6, K11, K12 and K10 in fp32; greedy streams equal except where the
    CPU's top-2 margin is under MARGIN."""
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               init_llama_params)

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(14),
                                   "cpu")
    prompt = np.random.RandomState(15).randint(0, 1024, (2, 128))
    out = {}
    m_cpu = LlamaForCausalLM(cfg, params=cpu_params, device="cpu")
    out["cpu"] = m_cpu.generate(prompt, max_new_tokens=24)
    gpu_params = _map_leaves(cpu_params, lambda t: t.to(dev))
    m_gpu = LlamaForCausalLM(cfg, params=gpu_params, device=dev)
    out["cuda"], ln = _counted(lambda: m_gpu.generate(prompt,
                                                      max_new_tokens=24))
    if not all(ln[k] for k in ("decode_attention", "rope_flash_fwd",
                               "swiglu", "fused_norm_epilogue")):
        raise AssertionError(f"a kernel did not run on the card: {ln}")
    exc = _streams_agree("decode cpu/cuda", m_cpu, torch.from_numpy(prompt),
                         out["cpu"], out["cuda"])
    print(f"decode cpu/cuda (fp32, fusion on): 2 greedy streams of 24 "
          f"tokens equal, {exc} near-tie exceptions, card launches {ln}")


def _serving_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul

    return {"ragged_paged_attention": rpa.ragged_paged_attention,
            "ragged_paged_attention_int8": rpa.ragged_paged_attention_int8,
            "lora_matmul": lora_matmul,
            "decode_attention": da.decode_attention,
            "decode_attention_int8": da.decode_attention_int8}


def _serving_counted(fn):
    return _counted(fn, _serving_counters)


class _LogitTap:
    """Records, for every token an engine emits, the top-8 logits of the
    row it was picked from: ``tokens[(rid, j)] = (values, ids)`` for
    token j of request rid. It wraps the serving module's
    ``_pick_tokens`` (each dispatch's logits, after any constraint mask)
    and the engine's step and harvest (which row gave which token)."""

    def __init__(self, eng):
        from paddle_tpu_torch.inference import serving

        self.eng, self.mod, self.tokens = eng, serving, {}
        self._pick, self._last, self._by_out = serving._pick_tokens, None, {}
        step, harvest = eng._unified_step_impl, eng._harvest

        def pick(logits, *a, **kw):
            top = torch.topk(logits, 8, dim=-1)
            self._last = (top.values.cpu(), top.indices.cpu())
            return self._pick(logits, *a, **kw)

        def step_impl(*a, **kw):
            out = step(*a, **kw)
            self._by_out[id(out)] = self._last
            return out

        def harvest_(inflight):
            out, snap = inflight
            vals, ids = self._by_out.pop(id(out))
            before = {idx: len(req.out_tokens)
                      for idx, _s, req, _k, _m, _d in snap}
            harvest(inflight)
            qb = eng.qb if eng.spec_k else 1
            for idx, _s, req, kind, m, _d in snap:
                for t in range(len(req.out_tokens) - before[idx]):
                    row = idx * qb + ((m - 1 if kind == "fin" else t)
                                      if eng.spec_k else 0)
                    self.tokens[(req.rid, before[idx] + t)] = (vals[row],
                                                               ids[row])

        self._pick_tap = pick
        eng._unified_step_impl, eng._harvest = step_impl, harvest_

    def __enter__(self):
        self.mod._pick_tokens = self._pick_tap
        return self

    def __exit__(self, *exc):
        self.mod._pick_tokens = self._pick
        del self.eng._unified_step_impl, self.eng._harvest


def _serving_streams_agree(tag, ref, got, tap) -> tuple[int, int]:
    """Greedy requests of ``got`` must emit ``ref``'s streams, except from
    a token where the logits ``ref``'s engine picked it from (``tap``)
    hold the two picks within MARGIN of each other (a near-tie). Returns
    (tokens equal up to the first difference, near-tie exceptions)."""
    same, exceptions = 0, 0
    for a, b in zip(ref, got):
        if a.temperature:
            continue
        diff = [j for j, (x, y) in enumerate(zip(a.out_tokens, b.out_tokens))
                if x != y]
        if len(a.out_tokens) != len(b.out_tokens):
            raise AssertionError(f"{tag}: request {a.rid} lengths differ")
        if not diff:
            same += len(a.out_tokens)
            continue
        j = diff[0]
        same += j
        vals, ids = tap.tokens[(a.rid, j)]

        def logit(tok):
            hit = (ids == tok).nonzero()
            return vals[hit[0, 0]].item() if len(hit) else -math.inf

        top, gap = vals[0].item(), logit(a.out_tokens[j]) - logit(
            b.out_tokens[j])
        print(f"{tag}: request {a.rid} differs at token {j}: "
              f"{a.out_tokens[j]} vs {b.out_tokens[j]}, logit gap {gap:.3e} "
              f"(limit {MARGIN:.3e})")
        if not (0.0 <= gap < MARGIN and logit(a.out_tokens[j]) == top):
            raise AssertionError(f"{tag}: request {a.rid} differs at token "
                                 f"{j} with logit gap {gap}")
        exceptions += 1
    return same, exceptions


def _drive(eng, reqs, tick: float = 0.0) -> int:
    """The engine's ``run`` loop, with the page ledger held to the pool
    after every step; returns the number of steps. ``tick`` > 0 runs the
    arrivals on a clock of ``tick`` seconds per step instead of the wall
    clock, so that two engines see the same schedule."""
    for r in sorted(reqs, key=lambda r: r.arrival):
        eng.submit(r)
    t0, n = time.perf_counter(), 0

    def now():
        return n * tick if tick else time.perf_counter() - t0

    while eng.step(now=now()):
        n += 1
        acc = eng.page_accounting()
        if acc["total"] != eng.n_pages - 1:
            raise AssertionError(f"ledger {acc} != {eng.n_pages - 1}")
        if eng._inflight is None and not any(eng.slots) and eng.queue:
            time.sleep(0.005)
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
            raise AssertionError(f"request {r.rid} did not complete")
    return eng.stats["unified_steps"]


class _OracleProposer:
    """Drafts a request's tokens from the non-speculative engine's streams
    of the same requests (found by prompt), with the second draft of
    every odd request off by one token: verification must accept the
    right drafts and roll the wrong ones back. On random weights the
    n-gram proposer seldom drafts (a random model's next token rarely
    occurred before in the history); these drafts exercise the verify
    rows whatever the weights."""

    def __init__(self, reqs, vocab: int):
        self.reqs, self.vocab = reqs, vocab

    def propose(self, history, k: int) -> list:
        for r in self.reqs:
            n = len(r.prompt)
            if len(history) > n and np.array_equal(history[:n], r.prompt):
                d = list(r.out_tokens[len(history) - n:][:k])
                if r.rid % 2 and len(d) > 1:
                    d[1] = (d[1] + 1) % self.vocab
                return d
        return []


def _printable_vocab(V: int) -> list:
    """A toy tokenizer for the schema: ids 1..94 the printable characters,
    every other id an empty piece (never legal), id 0 the pad token."""
    import string

    vocab = [""] * V
    for i, ch in enumerate(string.printable[:94]):
        vocab[i + 1] = ch
    return vocab


SERVING_ENGINE = dict(max_batch=8, page_size=128, max_seq=2048)


def _spec_requests(cls, vocab: int):
    """Eight requests whose prompts repeat a random 64-token pattern 2-8
    times, greedy and sampled, 16-32 new tokens."""
    rng = np.random.RandomState(7)
    out = []
    for i in range(8):
        pat = rng.randint(1, vocab, size=64).astype(np.int32)
        kw = dict(temperature=0.9, top_p=0.85, seed=200 + i) if i % 4 == 3 \
            else {}
        out.append(cls(rid=i, prompt=np.tile(pat, rng.randint(2, 9)),
                       max_new_tokens=int(rng.randint(16, 33)), **kw))
    return out


def _tenant_requests(cls, vocab: int, lora: bool):
    """Six low-priority requests of ``_requests`` at t = 0 (rids 1 and 4
    on adapter a1, 2 on a2 when ``lora``, rid 3 constrained to a schema),
    and a high-priority 900-token request at t = 0.5 s that finds the
    pool full and preempts."""
    reqs = _requests(cls, vocab)[:6]
    for r in reqs:
        r.arrival = 0.0
        if lora and r.rid in (1, 2, 4):
            r.adapter_id = "a2" if r.rid == 2 else "a1"
        if r.rid == 3:
            r.schema_id = "animal"
    hi = np.random.RandomState(8).randint(1, vocab, size=900).astype(
        np.int32)
    reqs.append(cls(rid=6, prompt=hi, max_new_tokens=24, priority=2,
                    arrival=0.5))
    return reqs


def _tenant_engine(cfg, params, dev, lora: bool, n_pages: int):
    from paddle_tpu_torch.inference.multitenant import (json_schema_dfa,
                                                        make_lora)
    from paddle_tpu_torch.inference.serving import ServingEngine

    eng = ServingEngine(cfg, params=params, device=dev, n_pages=n_pages,
                        lora=lora, priorities=True, constrained=True,
                        **SERVING_ENGINE)
    if lora:
        for name, seed in (("a1", 1), ("a2", 2)):
            eng.register_adapter(name, make_lora(cfg, 8, seed=seed))
    vocab = _printable_vocab(cfg.vocab_size)
    eng.register_schema("animal", json_schema_dfa(
        {"enum": ["cat", "car", "dog"]}, vocab).fresh)
    return eng, vocab


def run_serving(dev) -> dict:
    """The serving engine's int8 KV, speculative and multi-tenant paths
    at llama3-8b (32 layers, f 14336, vocab 128256, random bf16 weights
    from seed 0 on the card), then card against CPU on a small fp32
    config, and the public int8 decode entry. Returns the launches of
    each path's own kernel in its own run: K8q in (a), K13 in (c), K10q
    in (e)."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import init_llama_params, llama_presets

    cfg = llama_presets("llama3-8b")
    L = cfg.n_layers
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    counts = {}

    # (a) int8 KV pages against the bf16 engine
    runs = {}
    for kv_quant in (False, True):
        eng = ServingEngine(cfg, params=params, device=dev,
                            kv_quant=kv_quant, **SERVING_ENGINE)
        reqs = _requests(Request, cfg.vocab_size)
        stats, ln = _serving_counted(lambda: eng.run(reqs))
        steps = stats["unified_steps"]
        for r in reqs:
            if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
                raise AssertionError(f"kv_quant={kv_quant}: request "
                                     f"{r.rid} did not complete")
        acc = eng.page_accounting()
        if acc["total"] != eng.n_pages - 1:
            raise AssertionError(f"page ledger {acc}")
        want = (0, L * steps) if kv_quant else (L * steps, 0)
        got = (ln["ragged_paged_attention"],
               ln["ragged_paged_attention_int8"])
        if got != want:
            raise AssertionError(f"kv_quant={kv_quant}: K8 / K8q launches "
                                 f"{got} != {want}")
        # llama3-8b: 65552 (int8 k and v + the two fp32 scales of a page
        # over its 128 tokens) against 131072 in bf16
        bpt = eng.kv_bytes_per_token()
        item = torch.finfo(cfg.dtype).bits // 8
        per_layer = cfg.n_kv_heads * (2 * cfg.head_dim + 8 / eng.bs
                                      if kv_quant else 2 * item * cfg.head_dim)
        if bpt != L * per_layer:
            raise AssertionError(f"kv bytes per token {bpt} != "
                                 f"{L * per_layer}")
        runs[kv_quant] = reqs
        print(f"serving llama3-8b kv_quant={kv_quant}: {steps} steps, "
              f"{stats['wall_s'] / steps * 1e3:.1f} ms/step, "
              f"{stats['throughput_tok_s']:.1f} tok/s, ttft p50 "
              f"{stats['ttft_p50_s'] * 1e3:.1f} ms, {bpt:.0f} KV bytes per "
              f"token, launches K8 {got[0]} K8q {got[1]}")
        if kv_quant:
            counts["ragged_paged_attention_int8"] = got[1]
        del eng
    greedy = [(a.out_tokens, b.out_tokens) for a, b in zip(runs[False],
                                                          runs[True])
              if a.temperature == 0]
    same = sum(x == y for a, b in greedy for x, y in zip(a, b))
    print(f"serving int8 KV vs bf16 greedy agreement: first token "
          f"{sum(a[0] == b[0] for a, b in greedy)}/{len(greedy)}, all "
          f"tokens {same}/{sum(len(a) for a, _ in greedy)} (random weights:"
          " near-flat logits)")

    # (b) speculative decode against the non-speculative engine, with
    # the n-gram proposer, then with drafts known to be right or wrong
    eng = ServingEngine(cfg, params=params, device=dev, **SERVING_ENGINE)
    base = _spec_requests(Request, cfg.vocab_size)
    with _LogitTap(eng) as tap:
        base_st = eng.run(base)
    del eng
    for name in ("n-gram", "oracle"):
        eng = ServingEngine(cfg, params=params, device=dev, speculative_k=3,
                            **SERVING_ENGINE)
        if name == "oracle":
            eng._proposer = _OracleProposer(base, cfg.vocab_size)
        reqs = _spec_requests(Request, cfg.vocab_size)
        st = eng.run(reqs)
        del eng
        same, exc = _serving_streams_agree(f"serving spec {name}", base,
                                           reqs, tap)
        samp = sum(a.out_tokens == b.out_tokens
                   for a, b in zip(base, reqs) if a.temperature)
        if name == "oracle" and not (st["spec_accepted_tokens"] and
                                     st["waste_spec_rejected_slot_tokens"]):
            raise AssertionError(f"oracle drafts: {st}")
        print(f"serving spec k=3 ({name} drafts): {st['unified_steps']} "
              f"steps against {base_st['unified_steps']}, "
              f"{st['wall_s'] / st['unified_steps'] * 1e3:.1f} ms/step, "
              f"accept rate {st['spec_accept_rate']:.3f} "
              f"({st['spec_accepted_tokens']}/{st['spec_proposed_tokens']}, "
              f"{st['waste_spec_rejected_slot_tokens']} rejected); greedy "
              f"tokens equal {same}, {exc} near-tie exceptions; sampled "
              f"streams equal {samp}/2")

    # (c) LoRA + priorities + constrained decoding on a tight pool
    bs = SERVING_ENGINE["page_size"]
    need = sum(-(-(len(r.prompt) + r.max_new_tokens) // bs)
               for r in _tenant_requests(Request, cfg.vocab_size, True)[:6])
    n_pages = 1 + need + 2 + 2          # + one page per adapter, slack 2
    res = {}
    for lora in (False, True):
        eng, vocab = _tenant_engine(cfg, params, dev, lora, n_pages)
        reqs = _tenant_requests(Request, cfg.vocab_size, lora)
        lora_before = _lora_launch_counts()
        with _LogitTap(eng) as tap:
            steps, ln = _serving_counted(lambda: _drive(eng, reqs))
        res[lora] = (reqs, tap, eng.stats, ln, steps)
        if lora:
            if ln["lora_matmul"] != 2 * L * steps:
                raise AssertionError(f"K13 launches {ln['lora_matmul']} != "
                                     f"2 x {L} x {steps}")
            _check_lora_variants("serving multi-tenant", lora_before,
                                 2 * L * steps)
            counts["lora_matmul"] = ln["lora_matmul"]
            held = eng.adapters.n_pages_held()
        del eng
    reqs, _, st, ln, steps = res[True]
    if st["preemptions"] < 1 or not any(r.n_preempted for r in reqs):
        raise AssertionError(f"no preemption: {st['preemptions']}")
    text = "".join(vocab[t] for t in reqs[3].out_tokens)
    if text[:3] not in ("cat", "car", "dog") or any(reqs[3].out_tokens[3:]):
        raise AssertionError(f"constrained stream {reqs[3].out_tokens}")
    plain = [r for r in res[False][0] if r.rid not in (1, 2, 4)]
    tenant = [r for r in reqs if r.rid not in (1, 2, 4)]
    same, exc = _serving_streams_agree("serving lora", plain, tenant,
                                       res[False][1])
    print(f"serving multi-tenant: {steps} steps on {n_pages} pages, "
          f"preemptions {st['preemptions']} (victims "
          f"{[r.rid for r in reqs if r.n_preempted]}, all completed), "
          f"adapter pages {held}, constrained stream {text!r}, "
          f"no-adapter tokens equal to the LoRA-off engine's {same}, "
          f"{exc} near-tie exceptions; launches {ln}")
    del params, res
    torch.cuda.empty_cache()

    # (d) card against CPU, small fp32, every axis
    check_serving_cpu(dev)

    # (e) the public int8 decode entry: a 128-step decode over a dense
    # int8 cache at the llama1b decode shapes
    counts["decode_attention_int8"] = _int8_decode_entry(dev)
    return counts


def _int8_decode_entry(dev) -> int:
    """``decode_attention(..., k_scale=, v_scale=)``, the reference's only
    route to its int8 arm, at K10's decode shapes (B 16, nKV 4, G 4,
    d 128, S 2048) over positions 512..639 of a per-position int8 cache
    quantized from a bf16 one; every call must reach K10q."""
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention
    from paddle_tpu_torch.ops.quant import absmax_quantize_int8

    gen = torch.Generator(device=dev).manual_seed(24)
    B, nKV, G, S, d = 16, 4, 4, 2048, 128
    cache = [torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    (kq, ks), (vq, vs) = (absmax_quantize_int8(c, axis=-1) for c in cache)
    ks, vs = ks[..., 0], vs[..., 0]
    q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(
        torch.bfloat16)

    def loop():
        return [decode_attention(q, kq, vq, pos, d ** -0.5, k_scale=ks,
                                 v_scale=vs)
                for pos in range(DECODE_PROMPT, DECODE_PROMPT + DECODE_NEW)]

    outs, ln = _serving_counted(loop)
    if ln["decode_attention_int8"] != DECODE_NEW or ln["decode_attention"]:
        raise AssertionError(f"int8 decode entry launches {ln}")
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("int8 decode entry: non-finite output")
    print(f"int8 decode entry: {DECODE_NEW} calls at B{B}, launches {ln}")
    return ln["decode_attention_int8"]


def check_serving_cpu(dev) -> None:
    """A small fp32 engine (head dim 128, G 2, page 16) on the card and on
    the CPU from identical weights, int8 KV pages on, twice: with LoRA,
    priorities and constrained decoding on a tight pool, and with
    speculation (constrained decoding refuses it). Greedy streams equal
    except where the CPU engine's logits hold the two picks within
    MARGIN; ledgers equal; K8q, and K13 with LoRA, launched on the card."""
    from paddle_tpu_torch.inference.multitenant import (json_schema_dfa,
                                                        make_lora)
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(25),
                                   "cpu")
    cuda_params = _map_leaves(cpu_params, lambda t: t.to(dev))
    vocab = _printable_vocab(cfg.vocab_size)

    def requests(tenant: bool):
        rng = np.random.RandomState(26)
        pat = rng.randint(1, 1024, size=12).astype(np.int32)
        reqs = []
        for i in range(6):
            prompt = (np.tile(pat, rng.randint(2, 6)) if i % 2 else
                      rng.randint(1, 1024, size=rng.randint(10, 90)).astype(
                          np.int32))
            kw = {}
            if tenant:
                kw = dict(priority=int(i == 5), arrival=0.4 * (i == 5),
                          adapter_id=("a1", None, "a2")[i % 3],
                          schema_id="animal" if i == 2 else None)
            reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=12,
                                **kw))
        return reqs

    for tag, kw in (("lora+priorities+constrained",
                     dict(lora=True, priorities=True, constrained=True,
                          n_pages=24)),
                    ("speculative", dict(speculative_k=3))):
        res = {}
        for name, params, device in (("cpu", cpu_params, "cpu"),
                                     ("cuda", cuda_params, dev)):
            eng = ServingEngine(cfg, params=params, max_batch=3,
                                page_size=16, max_seq=512, prefill_budget=64,
                                kv_quant=True, device=device, **kw)
            if "lora" in kw:
                for a, seed in (("a1", 1), ("a2", 2)):
                    eng.register_adapter(a, make_lora(cfg, 8, seed=seed,
                                                      scale=0.3))
                eng.register_schema("animal", json_schema_dfa(
                    {"enum": ["cat", "car", "dog"]}, vocab).fresh)
            reqs = requests("lora" in kw)
            lora_before = _lora_launch_counts()
            with _LogitTap(eng) as tap:
                if name == "cuda":
                    _, ln = _serving_counted(lambda: _drive(eng, reqs, 0.05))
                else:
                    _drive(eng, reqs, 0.05)
            if name == "cuda" and "lora" in kw:
                _check_lora_variants(f"serving cpu/cuda {tag}", lora_before,
                                     ln["lora_matmul"])
            res[name] = (reqs, tap, eng.page_accounting(), dict(eng.stats))
        want = ["ragged_paged_attention_int8"] + (
            ["lora_matmul"] if "lora" in kw else [])
        if not all(ln[k] for k in want) or ln["ragged_paged_attention"]:
            raise AssertionError(f"serving cpu/cuda {tag}: launches {ln}")
        same, exc = _serving_streams_agree(f"serving cpu/cuda {tag}",
                                           res["cpu"][0], res["cuda"][0],
                                           res["cpu"][1])
        if res["cpu"][2] != res["cuda"][2]:
            raise AssertionError(f"ledgers differ: {res['cpu'][2]} vs "
                                 f"{res['cuda'][2]}")
        st = res["cuda"][3]
        print(f"serving cpu/cuda (fp32, int8 KV, {tag}): {same} greedy "
              f"tokens equal, {exc} near-tie exceptions, preemptions "
              f"{st['preemptions']}, accepted drafts "
              f"{st['spec_accepted_tokens']}, card launches {ln}")


# llama2-7b's attention width (models/llama.py presets): 32 heads of 128,
# 32 layers; the paged cache at bf16, page 128, 2048 tokens a sequence
PAGED = dict(L=32, B=8, nh=32, d=128, bs=128, max_seq=2048, prompt=1024,
             steps=64)


def _paged_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"paged_decode_attention_mxu": da.paged_decode_attention_mxu,
            "paged_decode_attention_kernel": da.paged_decode_attention_kernel,
            "paged_decode_attention_dma": da.paged_decode_attention_dma,
            "flash_fwd_sep": fa.flash_fwd_sep}


def _paged_case(gen, dev, dt, B, nkv, G, d, bs, mb, lens, d_major):
    """q, pages (d-major k with ``d_major``), a shuffled table and
    ``lens`` (clipped to the table) on ``dev``."""
    P = B * mb + 5
    q = torch.randn((B, nkv * G, d), generator=gen, device=dev).to(dt)
    k = torch.randn((P, nkv, d, bs) if d_major else (P, nkv, bs, d),
                    generator=gen, device=dev).to(dt)
    v = torch.randn((P, nkv, bs, d), generator=gen, device=dev).to(dt)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * mb]
    table = perm.reshape(B, mb).to(torch.int32)
    lens = torch.tensor([min(n, mb * bs) for n in lens], dtype=torch.int32,
                        device=dev)
    return q, k, v, table, lens


def _paged_timing(fn, plain, q, k, v, table, lens, d_major):
    """(kernel ms, its device ms, plain ms, SDPA ms on pre-gathered pages,
    its device ms, bound): device times from CUDA graphs of 20 calls; the
    bound counts each valid token's k and v, q and o."""
    B, nq, d = q.shape
    nkv, bs = v.shape[1], v.shape[2]
    mb = table.shape[1]
    scale = d ** -0.5
    args = (q, k, v, table, lens, scale)
    ms, device_ms = _time_ms(lambda: fn(*args)), _graph_ms(lambda: fn(*args))
    plain_ms = _time_ms(lambda: plain(*args), iters=5, warmup=1)
    t = table.long()
    kg = k[t].transpose(3, 4) if d_major else k[t]   # [B, mb, nkv, bs, d]
    kg, vg = (x.transpose(1, 2).reshape(B, nkv, mb * bs, d)
              .repeat_interleave(nq // nkv, dim=1).contiguous()
              for x in (kg, v[t]))
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q[:, :, None, :]
    lib = lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale)  # noqa
    lib_ms, lib_device_ms = _time_ms(lib), _graph_ms(lib)
    es = q.element_size()
    n_tok = int(lens.sum().item())
    nbytes = 2 * n_tok * nkv * d * es + 2 * q.numel() * es
    return (ms, device_ms, plain_ms, lib_ms, lib_device_ms,
            _bound(nbytes, 4.0 * n_tok * nq * d))


def _check_mxu_plan(d, bs, G, dtype) -> None:
    """K15's C launcher plans its ring as paged_mxu_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = torch.empty((), dtype=dtype).element_size()
    want, got = da.paged_mxu_plan(d, bs, G, es), \
        da.paged_mxu_plan_c(d, bs, G, es)
    if got != want:
        raise AssertionError(f"paged_mxu_plan_c {got} != paged_mxu_plan "
                             f"{want} at d{d} bs{bs} G{G} {dtype}")


def _check_dma_plan(d, bs, dtype) -> None:
    """K16's C launcher plans its rings as paged_dma_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = torch.empty((), dtype=dtype).element_size()
    want, got = da.paged_dma_plan(d, bs, es), da.paged_dma_plan_c(d, bs, es)
    if got != want:
        raise AssertionError(f"paged_dma_plan_c {got} != paged_dma_plan "
                             f"{want} at d{d} bs{bs} {dtype}")


def _dma_ring_edges(gen, dev) -> int:
    """K16 (the warp-specialised kernel) bit-equal to K14 at its rings'
    edges, d 64 / 128 / 256, pages of 16 / 64 / 128, bf16 and fp32:
    lengths 1, 0 (every page), ending on a tile, inside the second tile,
    on the k ring's last stage, a page and one, a full table; its C plan
    paged_dma_plan's. Returns the cases held."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    held = 0
    for dt in (torch.bfloat16, torch.float32):
        for d in (64, 128, 256):
            for bs in (16, 64, 128):
                _check_dma_plan(d, bs, dt)
                tile, ks = da.paged_dma_plan(d, bs, dt.itemsize)[:2]
                lens = [1, 0, tile, tile + 3, tile * ks, bs + 1, 4 * bs]
                q, k, v, table, sl = _paged_case(gen, dev, dt, len(lens), 4,
                                                 1, d, bs, 4, lens, False)
                args = (q, k, v, table, sl, d ** -0.5)
                if not torch.equal(da.paged_decode_attention_dma(*args),
                                   da.paged_decode_attention_kernel(*args)):
                    raise AssertionError(f"K16 != K14 at d{d} bs{bs} {dt} "
                                         f"lens {lens}")
                held += 1
    return held


def check_paged(dev) -> tuple[dict, dict, dict]:
    """K15, K14 and K16 against their plain versions: ragged lengths (1,
    mid-page, a full table, 0) on a shuffled table, bf16 and fp32, at
    llama2-7b's width (32 heads of 128, page 128, 16 blocks; K15 also at
    llama3-8b's GQA, 8 kv heads of 4 q heads; K14/K16 at 8 heads in fp32,
    where the reference's gate refuses 32); K16 bit-equal to K14 there
    and at its rings' edges (``_dma_ring_edges``), its C plan
    ``paged_dma_plan``'s. Timed at the paged phase's last decode step (B
    8, 1088 tokens a sequence, bf16), eager and on the device (CUDA
    graphs), beside SDPA on pre-gathered pages."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(21)
    lens = [1, 700, 2048, 0, 129, 1088]
    worst = {k: 0.0 for k in ("mxu", "tok")}
    for dt in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        for nkv, G in ((32, 1), (8, 4)):
            q, kt, v, table, sl = _paged_case(gen, dev, dt, len(lens), nkv,
                                              G, 128, 128, 16, lens, True)
            _check_mxu_plan(128, 128, G, dt)
            got = da.paged_decode_attention_mxu(q, kt, v, table, sl,
                                                128 ** -0.5)
            ref = da.paged_decode_mxu_plain(q, kt, v, table, sl,
                                            128 ** -0.5)
            worst["mxu"] = max(worst["mxu"], _hold(
                f"K15 {dt} nkv{nkv} G{G} lens {lens}", got, ref, tol))
        # in fp32 the reference's 12 MiB gate takes 8 heads, not 32
        nh = 32 if dt == torch.bfloat16 else 8
        q, k, v, table, sl = _paged_case(gen, dev, dt, len(lens), nh, 1, 128,
                                         128, 16, lens, False)
        _check_dma_plan(128, 128, dt)
        k14 = da.paged_decode_attention_kernel(q, k, v, table, sl,
                                               128 ** -0.5)
        k16 = da.paged_decode_attention_dma(q, k, v, table, sl, 128 ** -0.5)
        ref = da.paged_decode_plain(q, k, v, table, sl, 128 ** -0.5)
        torch.cuda.synchronize()
        if not torch.equal(k14, k16):
            raise AssertionError(f"K16 != K14 ({dt})")
        worst["tok"] = max(worst["tok"], _hold(
            f"K14 (== K16) {dt} nh{nh} lens {lens}", k14, ref, tol))
    print(f"K16 == K14 at {_dma_ring_edges(gen, dev)} ring-edge cases")
    B, nh, d, bs = PAGED["B"], PAGED["nh"], PAGED["d"], PAGED["bs"]
    mb = PAGED["max_seq"] // bs
    n = PAGED["prompt"] + PAGED["steps"]
    recs = []
    src = "paddle_tpu_torch/csrc/paged_decode_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/decode_attention.py"
    for name, line, fn, plain, d_major, err in (
            ("paged_decode_attention_mxu", 327, da.paged_decode_attention_mxu,
             da.paged_decode_mxu_plain, True, worst["mxu"]),
            ("paged_decode_attention_kernel", 156,
             da.paged_decode_attention_kernel, da.paged_decode_plain, False,
             worst["tok"]),
            ("paged_decode_attention_dma", 198,
             da.paged_decode_attention_dma, da.paged_decode_plain, False,
             worst["tok"])):
        inputs = _paged_case(gen, dev, torch.bfloat16, B, nh, 1, d, bs, mb,
                             [n] * B, d_major)
        ms, dev_ms, plain_ms, lib_ms, lib_dev_ms, bound = _paged_timing(
            fn, plain, *inputs, d_major)
        shape = f"B{B} nh{nh} d{d} bs{bs} mb{mb} {n} tokens, bf16"
        print(f"{name} {shape}: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa on pre-gathered pages "
              f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        recs.append({"name": name, "route": "cuda", "source": src,
                     "replaces": f"{ref_py}:{line}", "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "shape": shape})
        del inputs
    inputs = _paged_case(gen, dev, torch.bfloat16, B, 8, 4, d, bs, mb,
                         [n] * B, True)
    ms, dev_ms, plain_ms, lib_ms, lib_dev_ms, bound = _paged_timing(
        da.paged_decode_attention_mxu, da.paged_decode_mxu_plain, *inputs,
        True)
    print(f"K15 GQA (llama3-8b: nkv 8, G 4) B{B} {n} tokens bf16: kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"sdpa on pre-gathered repeated pages {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}), bound {bound[0]:.4f} ms ({bound[1]})")
    torch.cuda.empty_cache()
    return tuple(recs)


def _paged_layout_pass(dev, layout: str, gen) -> tuple[dict, list, list]:
    """block_multihead_attention over PAGED["L"] layers with ``layout``
    pages: one prefill, then PAGED["steps"] decode steps. Layer 0 of
    every 16th step and every layer of the last step are held against
    the plain version of the kernel the route took. Returns (launches of
    the decode loop, the caches, the last step's q per layer)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    L, B, nh, d, bs = (PAGED[k] for k in ("L", "B", "nh", "d", "bs"))
    S, steps = PAGED["prompt"], PAGED["steps"]
    bf = torch.bfloat16
    route, kernel, plain = (("mxu", "paged_decode_attention_mxu",
                             da.paged_decode_mxu_plain)
                            if layout == "d_major" else
                            ("kernel", "paged_decode_attention_kernel",
                             da.paged_decode_plain))
    mb = PAGED["max_seq"] // bs
    caches = [ft.PagedKVCache(B * mb, nh, bs, d, B, PAGED["max_seq"],
                              dtype=bf, k_layout=layout, device=dev)
              for _ in range(L)]

    def prefill():
        """Each layer's prompt qkv drawn, then its call timed alone;
        returns (layer 0's qkv and output, the calls' seconds)."""
        first, secs = None, 0.0
        for c in caches:
            qkv = torch.randn((B, S, 3, nh, d), generator=gen,
                              device=dev).to(bf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ft.block_multihead_attention(qkv, c)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            first = first or (qkv, o)
        return first, secs

    before = ft.ROUTES["flash"]
    ((qkv0, o0), secs), ln = _counted(prefill, _paged_counters)
    prefill_ms = secs * 1e3
    if ln["flash_fwd_sep"] != L or ft.ROUTES["flash"] - before != L:
        raise AssertionError(f"paged {layout} prefill: K1-sep launched "
                             f"{ln['flash_fwd_sep']} times, want {L}")
    # layer 0's prefill attention against the plain flash (pages written)
    ref = fa.flash_sep_plain(qkv0[:, :, 0], qkv0[:, :, 1], qkv0[:, :, 2],
                             True, d ** -0.5)[0]
    _hold(f"paged {layout} prefill layer 0 (K1-sep)", o0, ref, BF16_TOL)
    del qkv0, o0, ref
    torch.cuda.empty_cache()
    scale = d ** -0.5
    step_s, worst = [], 0.0
    counters = _paged_counters()
    for c in counters.values():
        c.launches = 0
    before = ft.ROUTES[route]
    for step in range(steps):
        qkvs = [torch.randn((B, 1, 3, nh, d), generator=gen,
                            device=dev).to(bf) for _ in range(L)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ft.block_multihead_attention(qkv, c)
                for qkv, c in zip(qkvs, caches)]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        held = range(L) if step == steps - 1 else \
            (range(1) if step % 16 == 0 else ())
        for i in held:             # the plain versions launch nothing
            c = caches[i]
            ref = plain(qkvs[i][:, 0, 0], c.k_pages, c.v_pages,
                        c.block_table, c.seq_lens, scale)
            err = _scaled_err(outs[i][:, 0], ref)[1]
            if not err <= BF16_TOL:
                raise AssertionError(f"paged {layout} step {step} layer {i}"
                                     f": scaled error {err} > {BF16_TOL}")
            worst = max(worst, err)
    last_q = [qkv[:, 0, 0].contiguous() for qkv in qkvs]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = L * steps
    if layout == "d_major":
        _check_mxu_plan(d, bs, 1, bf)
    if launches[kernel] != want or ft.ROUTES[route] - before != want:
        raise AssertionError(f"paged {layout}: {kernel} launched "
                             f"{launches[kernel]} times (route {route} "
                             f"{ft.ROUTES[route] - before}), want {want}")
    print(f"paged llama2-7b {layout}: prefill {prefill_ms:.2f} ms (B{B} S{S}"
          f", {L} layers, K1-sep {ln['flash_fwd_sep']}), decode "
          f"{1e3 * sum(step_s) / steps:.3f} ms a step (best "
          f"{1e3 * min(step_s):.3f}, {L} layers), {kernel} {launches[kernel]}"
          f" launches over {steps} steps; layer 0 every 16th step and all "
          f"{L} layers of the last step held to the plain version: worst "
          f"scaled error {worst:.3e} (tol {BF16_TOL:.3e})")
    return launches, caches, last_q


def _hold_first_cpu_prefill(ft, qkv, fresh_cache, got, tag: str) -> None:
    """Hold the process's first CPU prefill of the case, on a fresh cache,
    to the card's output ``got`` at FP32_TOL, as the compared one is: the
    case's CPU reference once read 2.4e-4 on the first CPU prefill of a
    process that had run the card phases (ROADMAP Queue 3, open). Where
    its bits differ from a second call's, both calls' errors against a
    float64 evaluation of the same attention are printed first."""
    first = ft.block_multihead_attention(qkv, fresh_cache())
    second = ft.block_multihead_attention(qkv, fresh_cache())
    if not torch.equal(first, second):
        q, k, v = (qkv[:, :, i].double() for i in range(3))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        mask = torch.ones(s.shape[-1], s.shape[-1], dtype=torch.bool).tril()
        p = torch.softmax(torch.where(mask, s, float("-inf")), -1)
        ref = torch.einsum("bhqk,bkhd->bqhd", p, v)
        print(f"{tag}: first CPU prefill != second; scaled error against "
              f"float64 {_scaled_err(first, ref)[1]:.3e} (first), "
              f"{_scaled_err(second, ref)[1]:.3e} (second)")
    _hold(tag + " (first CPU call)", got, first, FP32_TOL)


def _paged_cpu_case(dev) -> None:
    """A small fp32 paged cache on the card and on the CPU from the same
    inputs, both layouts: prefill (K1-sep), 3 decode steps (K15 or K14)
    and K16 on the token-major pages, held within FP32_TOL."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator().manual_seed(23)
    B, nh, d, bs, S = 2, 8, 128, 128, 128

    def cache(layout, device):
        return ft.PagedKVCache(B * 3, nh, bs, d, B, 3 * bs,
                               dtype=torch.float32, k_layout=layout,
                               device=device)

    for layout in ("d_major", "token_major"):
        caches = [cache(layout, x) for x in (dev, "cpu")]
        for T in (S, 1, 1, 1):
            qkv = torch.randn((B, T, 3, nh, d), generator=gen)
            got = ft.block_multihead_attention(qkv.to(dev), caches[0]).cpu()
            tag = f"paged fp32 card vs CPU {layout} T{T}"
            if T > 1:   # the prefill
                _hold_first_cpu_prefill(ft, qkv, lambda: cache(layout, "cpu"),
                                        got, tag)
            want = ft.block_multihead_attention(qkv, caches[1])
            _hold(tag, got, want, FP32_TOL)
        if layout == "token_major":
            q = torch.randn((B, nh, d), generator=gen)
            c, cc = caches
            got = da.paged_decode_attention_dma(
                q.to(dev), c.k_pages, c.v_pages, c.block_table, c.seq_lens,
                d ** -0.5)
            want = da.paged_decode_attention_dma(
                q, cc.k_pages, cc.v_pages, cc.block_table, cc.seq_lens,
                d ** -0.5)
            _hold("paged fp32 card vs CPU K16", got.cpu(), want, FP32_TOL)


def run_paged(dev) -> dict:
    """The incubate paged decode at llama2-7b's attention width: 32
    PagedKVCaches (one a layer; bf16, page 128, 2048 tokens, B 8), a
    1024-token prefill through block_multihead_attention (K1-sep 32
    times) and 64 decode steps with d-major pages (K15 32 times a step),
    then the same with token-major pages (K14 32 times a step); K16 (the
    warp-specialised kernel, its own rings) once a layer on the
    token-major caches, each layer bit-equal to K14; one GQA pass at
    llama3-8b's width (32 q heads, 8 kv heads) through
    paged_decode_attention (K15's native GQA); a small fp32 case, card
    against CPU. Returns the launches of K15 and K14 (decode loops) and
    K16 (its pass)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    ln, caches, _ = _paged_layout_pass(dev, "d_major", gen)
    launches = {"paged_decode_attention_mxu":
                ln["paged_decode_attention_mxu"]}
    del caches
    torch.cuda.empty_cache()
    ln, caches, last_q = _paged_layout_pass(dev, "token_major", gen)
    launches["paged_decode_attention_kernel"] = \
        ln["paged_decode_attention_kernel"]
    print(f"paged: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB (32 layers x 128 pages x 2 x 1 MiB a layout)")
    scale = PAGED["d"] ** -0.5

    def dma_pass():
        return [da.paged_decode_attention_dma(q, c.k_pages, c.v_pages,
                                              c.block_table, c.seq_lens,
                                              scale)
                for q, c in zip(last_q, caches)]

    k16, ln = _counted(dma_pass, _paged_counters)
    launches["paged_decode_attention_dma"] = ln["paged_decode_attention_dma"]
    for i, (q, c) in enumerate(zip(last_q, caches)):
        k14 = da.paged_decode_attention_kernel(q, c.k_pages, c.v_pages,
                                               c.block_table, c.seq_lens,
                                               scale)
        if not torch.equal(k14, k16[i]):
            raise AssertionError(f"paged: K16 != K14 at layer {i}")
    if launches["paged_decode_attention_dma"] != PAGED["L"]:
        raise AssertionError(f"paged: K16 launched {ln}")
    _check_dma_plan(PAGED["d"], PAGED["bs"], torch.bfloat16)
    print(f"paged: K16 on the {PAGED['L']} token-major caches, bit-equal to "
          f"K14 ({launches['paged_decode_attention_dma']} launches)")
    del caches, last_q, k16
    torch.cuda.empty_cache()
    # GQA at llama3-8b's width: 8 kv heads, 32 q heads, d-major pages
    B, bs, d, nkv, nq = PAGED["B"], PAGED["bs"], PAGED["d"], 8, 32
    mb = PAGED["max_seq"] // bs
    c = ft.PagedKVCache(B * mb, nkv, bs, d, B, PAGED["max_seq"],
                        dtype=torch.bfloat16, device=dev)
    k, v = (torch.randn((B, PAGED["prompt"], nkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    c.write_prefill(k, v)
    k, v = (torch.randn((B, 1, nkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    c.write_decode(k, v)
    q = torch.randn((B, 1, nq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    before = ft.ROUTES["mxu"]
    _check_mxu_plan(d, bs, nq // nkv, torch.bfloat16)
    got = ft.paged_decode_attention(q, c.k_pages, c.v_pages, c.block_table,
                                    c.seq_lens, k_layout="d_major")
    if ft.ROUTES["mxu"] != before + 1:
        raise AssertionError("paged GQA: K15 did not take the call")
    ref = da.paged_decode_mxu_plain(q[:, 0], c.k_pages, c.v_pages,
                                    c.block_table, c.seq_lens, scale)
    _hold("paged GQA llama3-8b (K15, nkv 8, G 4)", got[:, 0], ref, BF16_TOL)
    del c, k, v
    torch.cuda.empty_cache()
    _paged_cpu_case(dev)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; 'profile' and 'train_profile' (never by default) "
                    "run the bf16 engine and two flagship training steps "
                    "(fusion on, then off) under torch.profiler")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.models.llama import llama_presets, \
        init_llama_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
          "for matmul and cuDNN")
    _build.build_all()
    print(f"built {sorted(_build.build_all())} in "
          f"{_build.last_build_seconds:.1f} s")
    kernels = {}
    t0 = time.perf_counter()
    flash_before = _flash_launch_counts()
    rpa_before = _rpa_launch_counts()

    def done(phase: str) -> None:
        nonlocal t0, flash_before, rpa_before
        now = time.perf_counter()
        if phase in FLASH_WGMMA_PHASES:
            _check_flash_variants(phase, flash_before)
        if phase in RPA_WGMMA_PHASES:
            _check_rpa_variants(phase, rpa_before)
        flash_before = _flash_launch_counts()
        rpa_before = _rpa_launch_counts()
        print(f"phase {phase}: {now - t0:.1f} s")
        t0 = now

    if "kernels" in phases:
        kernels["ragged_paged_attention"] = check_rpa(dev)
        kernels["quant_matmul"] = check_qmm(dev)
        torch.cuda.empty_cache()
        done("kernels")
    launches = {}
    if {"engine", "int8", "profile"} & set(phases):
        cfg = llama_presets("llama3-8b")
        params = init_llama_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        fp_reqs = None
        if "engine" in phases:
            fp_reqs, ln = run_engine(cfg, params, dev, False)
            launches["ragged_paged_attention"] = ln["ragged_paged_attention"]
        if "profile" in phases:
            run_engine(cfg, params, dev, False, profile=True)
        if "int8" in phases:
            q_reqs, ln = run_engine(cfg, params, dev, True)
            launches["quant_matmul"] = ln["quant_matmul"]
            if fp_reqs is not None:
                greedy = [(a.out_tokens, b.out_tokens)
                          for a, b in zip(fp_reqs, q_reqs)
                          if a.temperature == 0]
                first = sum(a[0] == b[0] for a, b in greedy)
                same = sum(x == y for a, b in greedy for x, y in zip(a, b))
                tot = sum(len(a) for a, _ in greedy)
                print(f"int8 vs bf16 greedy agreement: first token "
                      f"{first}/{len(greedy)}, all tokens {same}/{tot} "
                      "(random weights: near-flat logits)")
        del params
        torch.cuda.empty_cache()
        done("engine/int8")
    if "cpu" in phases:
        check_cuda_vs_cpu(dev)
        done("cpu")
    if "train_kernels" in phases:
        kernels["flash_fwd"], kernels["flash_bwd"] = check_flash(dev)
        torch.cuda.empty_cache()
        kernels["flash_bwd_split"], kernels["flash_bwd_sep"] = \
            check_flash_split(dev)
        torch.cuda.empty_cache()
        kernels["flash_fwd_hm"], kernels["flash_bwd_hm"] = \
            check_flash_head_major(dev)
        torch.cuda.empty_cache()
        kernels["fused_ce_fwd"], kernels["fused_ce_bwd"] = check_ce(dev)
        torch.cuda.empty_cache()
        kernels["fused_norm_epilogue"] = check_norm_epilogue(dev)
        kernels["fused_bias_act"] = check_bias_gelu(dev)
        torch.cuda.empty_cache()
        done("train_kernels")
    if "train" in phases:
        ln, on = run_train(dev)
        launches.update(ln)
        torch.cuda.empty_cache()
        _, off = run_train(dev, fused=False)
        torch.cuda.empty_cache()
        print("train fusion on vs off: step "
              f"{on['step_ms']:.2f} vs {off['step_ms']:.2f} ms, peak mem "
              f"{on['peak_gib']:.2f} vs {off['peak_gib']:.2f} GiB")
        ln, hm = run_train(dev, native=False)
        torch.cuda.empty_cache()
        for name in ("flash_fwd_hm", "flash_bwd_hm"):
            launches[name] = ln[name]
        if not abs(hm["loss0"] - on["loss0"]) <= 1e-3 * abs(on["loss0"]):
            raise AssertionError(f"train head-major: first loss "
                                 f"{hm['loss0']} vs native {on['loss0']}")
        print("train native vs head-major layout (K1/K2 vs K17): step "
              f"{on['step_ms']:.2f} vs {hm['step_ms']:.2f} ms, peak mem "
              f"{on['peak_gib']:.2f} vs {hm['peak_gib']:.2f} GiB, first "
              f"loss {on['loss0']:.6f} vs {hm['loss0']:.6f}")
        done("train")
    if "train_profile" in phases:
        for fused in (True, False):
            run_train(dev, profile=True, fused=fused)
            torch.cuda.empty_cache()
        done("train_profile")
    if "train_cpu" in phases:
        check_train_cpu(dev)
        done("train_cpu")
    if "train_13b" in phases:
        launches.update(run_train_13b(dev))
        done("train_13b")
    if "llama_train" in phases:
        launches.update(run_llama_train(dev))
        torch.cuda.empty_cache()
        done("llama_train")
    if "decode_kernels" in phases:
        kernels["decode_attention"] = check_decode_attention(dev)
        kernels["rope_flash_fwd"], kernels["flash_fwd_sep"] = \
            check_rope_flash(dev)
        kernels["swiglu"] = check_swiglu(dev)
        check_llama_norm_epilogue(dev)
        torch.cuda.empty_cache()
        done("decode_kernels")
    if "decode" in phases:
        launches.update(run_decode(dev))
        done("decode")
    if "decode_cpu" in phases:
        check_decode_cpu(dev)
        done("decode_cpu")
    if "serving_kernels" in phases:
        kernels["ragged_paged_attention_int8"] = check_rpa_int8(dev)
        kernels["lora_matmul"] = check_lora(dev)
        kernels["decode_attention_int8"] = check_decode_int8(dev)
        torch.cuda.empty_cache()
        done("serving_kernels")
    if "serving" in phases:
        launches.update(run_serving(dev))
        done("serving")
    if "paged_kernels" in phases:
        (kernels["paged_decode_attention_mxu"],
         kernels["paged_decode_attention_kernel"],
         kernels["paged_decode_attention_dma"]) = check_paged(dev)
        done("paged_kernels")
    if "paged" in phases:
        launches.update(run_paged(dev))
        done("paged")
    if set(phases) != set(PHASES):
        print(f"phases {phases} only: no result line")
        return 0
    recs = []
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
        recs.append(rec)
    print(json.dumps({"kernels": recs}))
    # count: the cards this script drove, one
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
