"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card

Phases, each failing loudly (any failure exits nonzero):

1. ``kernels``: build every CUDA kernel from ``paddle_tpu_torch/csrc/``,
   hold each against its plain PyTorch version at the shapes the serving
   main path gives it (llama3-8b), and time kernel, plain version and the
   nearest single PyTorch library call.
2. ``engine``: ``ServingEngine(llama_presets("llama3-8b"))`` at full
   width with random bf16 weights drawn on the card from a seed, serving
   eight requests (half share a 256-token prefix, greedy and sampled);
   the attention kernel's launch count must equal layers x steps.
3. ``int8``: the same traffic through the weight-only int8 engine; the
   int8 matmul kernel's launch count must equal (7 x layers + 1) x steps.
4. ``cpu``: a small fp32 config (head dim 128) on the card and on the
   CPU with identical weights; greedy streams must be equal except where
   the CPU's top-2 logit margin is under 1e-4.

Prints the card's name and power limit, one JSON line ``{"kernels": ...}``
and, last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

PHASES = ("kernels", "engine", "int8", "cpu")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
RPA_BF16_ATOL = 2e-2             # bf16 output; plain rounds p/l to bf16
RPA_FP32_ATOL = 1e-4             # fp32 inputs, TF32 off, sum order only
QMM_ATOL = 1e-3                  # fp32 accumulators, sum order only
MARGIN = 1e-4                    # CPU top-2 logit margin of a tie


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


def _bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_rpa(dev) -> dict:
    """K8 at the llama3-8b attention shapes: a mixed batch of decode rows,
    page-straddling prefill chunks, a partial chunk and idle sink rows."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    C, qb, nH, nKV, d, bs, mb, P = 32, 16, 32, 8, 128, 128, 16, 129
    gen = torch.Generator(device=dev).manual_seed(1)
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
    rows_t = torch.from_numpy(rows).to(dev)
    pos_t = torch.from_numpy(pos0).to(dev)
    nv_t = torch.from_numpy(nval).to(dev)
    scale = 1.0 / math.sqrt(d)
    errs = {}
    for dt, tol in ((torch.float32, RPA_FP32_ATOL),
                    (torch.bfloat16, RPA_BF16_ATOL)):
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(dt)
        kp = torch.randn((P, nKV, d, bs), generator=gen, device=dev).to(dt)
        vp = torch.randn((P, nKV, bs, d), generator=gen, device=dev).to(dt)
        got = rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t, nv_t,
                                         scale)
        ref = rpa.ragged_paged_attention_plain(q, kp, vp, rows_t, pos_t,
                                               nv_t, scale)
        torch.cuda.synchronize()
        valid = (torch.arange(qb, device=dev)[None, :] < nv_t[:, None])
        err = (got.float() - ref.float()).abs()[valid].max().item()
        print(f"rpa {dt}: max_abs_err {err:.3e} (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"rpa {dt}: max_abs_err {err} > {tol}")
        errs[dt] = err
    ms = _time_ms(lambda: rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t,
                                                     nv_t, scale))
    plain_ms = _time_ms(lambda: rpa.ragged_paged_attention_plain(
        q, kp, vp, rows_t, pos_t, nv_t, scale))
    # library yardstick: SDPA over the pre-gathered pages (GQA expanded)
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
    library_ms = _time_ms(lambda: sdpa(qh, kg, vg, attn_mask=mask,
                                       scale=scale))
    # what these inputs need: q and o once, every page a chunk reaches
    # once (pages shared between chunks counted once), and the dots of
    # the valid query rows over their causal keys
    pages = set()
    flops = 0.0
    for c in range(C):
        last = pos0[c] + nval[c] - 1
        pages.update(int(p) for p in rows[c, :last // bs + 1])
        for i in range(nval[c]):
            flops += 4.0 * nH * d * (pos0[c] + i + 1)
    nbytes = (2 * q.numel() * 2 + len(pages) * 2 * nKV * bs * d * 2
              + (rows.size + 2 * C) * 4)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"rpa bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:85",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32":
            errs[torch.float32], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"C{C} qb{qb} nH{nH} nKV{nKV} d{d} bs{bs} mb{mb}"}


QMM_SHAPES = (  # (M, K, N): the layer matmuls at C*qb = 512, the head at C
    (512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
    (512, 14336, 4096), (32, 4096, 128256))


def check_qmm(dev) -> dict:
    """K9 at every matmul shape of the int8 engine step; the entry kept
    for the kernels line is the FFN up-projection, the largest."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qmm
    from paddle_tpu_torch.ops.quant import absmax_quantize_int8

    gen = torch.Generator(device=dev).manual_seed(2)
    main = None
    for M, K, N in QMM_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        wq, s = absmax_quantize_int8(w, axis=-2, scale_dtype=torch.bfloat16)
        got = qmm.quant_matmul(x, wq, s)
        ref = qmm.quant_matmul_plain(x, wq, s)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= QMM_ATOL:
            raise AssertionError(f"qmm {M}x{K}x{N}: max_abs_err {err}")
        ms = _time_ms(lambda: qmm.quant_matmul(x, wq, s))
        plain_ms = _time_ms(lambda: qmm.quant_matmul_plain(x, wq, s))
        wb = w.contiguous()
        library_ms = _time_ms(lambda: torch.matmul(x, wb))
        nbytes = M * K * 2 + K * N + N * 2 + M * N * 4
        bound_ms, bound_by = _bound(nbytes, 2.0 * M * K * N)
        print(f"qmm M{M} K{K} N{N}: max_abs_err {err:.3e} (atol "
              f"{QMM_ATOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bf16 matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        rec = {"name": "quant_matmul", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
               "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:53",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "shape": f"M{M} K{K} N{N}"}
        if N == 14336:
            main = rec
        del x, w, wq, s, wb, got, ref
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
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    quant_matmul.launches = 0
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
                "quant_matmul": quant_matmul.launches}
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
    if launches["quant_matmul"] != want_qmm:
        raise AssertionError(f"int8 matmul launches {launches} != "
                             f"{want_qmm}")
    tag = "int8" if weight_only_int8 else "bf16"
    print(f"engine {tag}{' (profiled)' if profile else ''}: {len(reqs)} "
          f"requests, {steps} steps, "
          f"{stats['wall_s'] / steps * 1e3:.1f} ms/step, "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; 'profile' (never by default) runs the bf16 engine "
                    "under torch.profiler")
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
    if "kernels" in phases:
        kernels["ragged_paged_attention"] = check_rpa(dev)
        kernels["quant_matmul"] = check_qmm(dev)
        torch.cuda.empty_cache()
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
    if "cpu" in phases:
        check_cuda_vs_cpu(dev)
    if set(phases) != set(PHASES):
        print(f"phases {phases} only: no result line")
        return 0
    recs = []
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
        recs.append(rec)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
