"""Time the unified ragged paged attention kernels of the port found in
the working directory: K8 (bf16 pages) and K8q (int8 pages with fp32
[P, nKV] scales), each beside SDPA on the pre-gathered (for K8q
dequantized) pages with the engine's mask.

The llama3-8b engine step's attention (C 32 chunks of qb 16, nH 32, nKV 8,
d 128, pages of 128 tokens, mb 16, 129 pages), in three mixes:

- ``step``: ``chip_smoke.py``'s ``_rpa_rows`` (decode rows, page-straddling
  prefill chunks, partial chunks, idle sink rows);
- ``decode``: 32 chunks of n_valid 1 at positions spread over 0-2047;
- ``prefill``: 32 chunks of 16 rows at positions spread over 0-2032.

Each is read three times eager (CUDA events around 20 calls) and three
times on the device alone (20 calls captured in a CUDA graph and
replayed), beside the bound (distinct pages' k and v, q and o at 3.35
TB/s, or the valid rows' dots at 989 TFLOP/s); then the host time of one
K8 wrapper call is printed (the best of seven loops of 400 calls).

``serving`` (second argument ``serving`` or ``all``): the llama3-8b
``ServingEngine`` (random bf16 weights from seed 0, max_batch 8, page
128, max_seq 2048) on ``chip_smoke.py``'s eight requests, bf16 and int8
KV pages: the median host time of ``step()`` over the run (after a
first, warm-up run), and the device's busy share of a profiled run (the
kernels' device time over its wall time, the profiler's cost included).

Only entries that every version of the port has are used, so two
checkouts, a change and its parent, can be timed in turn on one card::

    cd <checkout> && python3 <path to this file> <tag> [kernels|serving|all]

Each reading is printed on a line of its own that starts with <tag>.
The script checks every kernel's output against its plain version
(within 2e-2 on the valid rows, chip_smoke's RPA_BF16_ATOL) before it
times it, and prints a digest of each output on the fixed seeded
inputs, so that two checkouts' bits can be compared.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

C, QB, NH, NKV, D, BS, MB, P = 32, 16, 32, 8, 128, 128, 16, 129
ATOL = 2e-2
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def _mix(name: str):
    """(rows, pos0, n_valid) of one mix, numpy int32."""
    rng = np.random.RandomState(1)
    rows = np.zeros((C, MB), np.int32)
    pos0 = np.zeros((C,), np.int32)
    nval = np.ones((C,), np.int32)
    if name == "step":                  # chip_smoke.py's _rpa_rows
        for c in range(24):
            rows[c] = rng.permutation(np.arange(1, P))[:MB]
            if c < 8:
                pos0[c], nval[c] = rng.randint(0, MB * BS), 1
            elif c < 20:
                pos0[c] = 120 + 128 * (c - 8) % 1900
                nval[c] = QB
            else:
                pos0[c], nval[c] = rng.randint(0, 1500), rng.randint(2, QB)
        return rows, pos0, nval
    for c in range(C):
        rows[c] = rng.permutation(np.arange(1, P))[:MB]
    if name == "decode":
        pos0[:] = np.linspace(0, MB * BS - 1, C).astype(np.int32)
    else:
        pos0[:] = np.linspace(0, MB * BS - QB, C).astype(np.int32)
        nval[:] = QB
    return rows, pos0, nval


def _bound_ms(rows, pos0, nval, page_bytes: int) -> float:
    pages, flops = set(), 0.0
    for c in range(C):
        last = int(pos0[c] + nval[c] - 1)
        pages.update(int(p) for p in rows[c, :last // BS + 1])
        for i in range(int(nval[c])):
            flops += 4.0 * NH * D * (int(pos0[c]) + i + 1)
    nbytes = (2 * C * QB * NH * D * 2 + len(pages) * 2 * NKV * page_bytes
              + rows.size * 4 + 2 * C * 4)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3


def _sdpa(q, kp, vp, rows_t, pos_t, nv_t, scale):
    """SDPA over the pre-gathered pages (GQA expanded), engine's mask."""
    dev = q.device
    idx = rows_t.long()
    kg = kp[idx].permute(0, 2, 1, 4, 3).reshape(C, NKV, MB * BS, D)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(C, NKV, MB * BS, D)
    kg = kg.repeat_interleave(NH // NKV, dim=1)
    vg = vg.repeat_interleave(NH // NKV, dim=1)
    qh = q.transpose(1, 2)
    qpos = pos_t[:, None] + torch.minimum(
        torch.arange(QB, device=dev)[None, :], nv_t[:, None] - 1)
    mask = (torch.arange(MB * BS, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale)


def _requests(cls, vocab: int):
    """chip_smoke.py's eight requests: four at t = 0 and four at t = 0.3
    s, half sharing a 256-token prefix, prompts 40-600 tokens, greedy and
    sampled, 16-32 new tokens."""
    rng = np.random.RandomState(0)
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


def serving(tag: str) -> None:
    """The llama3-8b serving step, bf16 and int8 KV: median ms a step()
    and the device's busy share (see the module docstring)."""
    import time

    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import init_llama_params, \
        llama_presets

    dev = torch.device("cuda")
    cfg = llama_presets("llama3-8b")
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for kv_quant in (False, True):
        eng = ServingEngine(cfg, params=params, max_batch=8, page_size=128,
                            max_seq=2048, kv_quant=kv_quant, device=dev)
        eng.run(_requests(Request, cfg.vocab_size))      # warm-up
        step, times = eng.step, []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = step(*args, **kw)
            times.append(time.perf_counter() - t0)
            return out

        eng.step = timed
        stats = eng.run(_requests(Request, cfg.vocab_size))
        torch.cuda.synchronize()
        eng.step = step
        with torch.profiler.profile(activities=acts) as prof:
            pst = eng.run(_requests(Request, cfg.vocab_size))
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == cuda)
        print(f"{tag} serving llama3-8b kv {'int8' if kv_quant else 'bf16'}:"
              f" {stats['unified_steps']} steps, step() median "
              f"{1e3 * float(np.median(times)):.2f} ms, "
              f"{stats['wall_s'] / stats['unified_steps'] * 1e3:.2f} ms a "
              f"step of wall, device busy {100 * busy / (pst['wall_s'] * 1e6):.1f}% "
              f"(profiled run)", flush=True)
        del eng
        torch.cuda.empty_cache()


def main(tag: str, what: str = "all") -> None:
    sys.path.insert(0, os.getcwd())
    if what in ("kernels", "all"):
        kernels(tag)
    if what in ("serving", "all"):
        serving(tag)


def kernels(tag: str) -> None:
    from paddle_tpu_torch.obs.flash_timing import _graph_ms, _host_us, \
        _time_ms
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.quant import dequantize_int8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{tag} card {smi[0] if smi else 'unknown'}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    scale = D ** -0.5
    q = torch.randn((C, QB, NH, D), generator=gen, device=dev).to(bf)
    kp = torch.randn((P, NKV, D, BS), generator=gen, device=dev).to(bf)
    vp = torch.randn((P, NKV, BS, D), generator=gen, device=dev).to(bf)
    kq, vq = (torch.randint(-127, 128, x.shape, generator=gen, device=dev,
                            dtype=torch.int8) for x in (kp, vp))
    ks, vs = (torch.rand((P, NKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2))
    kd = dequantize_int8(kq, ks[:, :, None, None], bf)
    vd = dequantize_int8(vq, vs[:, :, None, None], bf)
    for mix in ("step", "decode", "prefill"):
        rows, pos0, nval = _mix(mix)
        ints = [torch.from_numpy(a).to(dev) for a in (rows, pos0, nval)]
        valid = torch.arange(QB, device=dev)[None, :] < ints[2][:, None]
        for name, k, v, sc, kr, vr, page_bytes in (
                ("K8", kp, vp, {}, kp, vp, BS * D * 2),
                ("K8q", kq, vq, {"k_scales": ks, "v_scales": vs}, kd, vd,
                 BS * D + 4)):
            fn = (lambda k=k, v=v, sc=sc: rpa.ragged_paged_attention(
                q, k, v, *ints, scale, **sc))
            got = fn()
            ref = rpa.ragged_paged_attention_plain(q, kr, vr, *ints, scale)
            err = (got.float() - ref.float()).abs()[valid].max().item()
            if not err <= ATOL:
                raise AssertionError(f"{name} {mix}: max_abs_err {err}")
            digest = hashlib.sha256(got.view(torch.int16).cpu().numpy()
                                    .tobytes()).hexdigest()[:16]
            print(f"{tag} {name} {mix} output digest {digest}, max_abs_err "
                  f"{err:.3e}, bound ms "
                  f"{_bound_ms(rows, pos0, nval, page_bytes):.4f}",
                  flush=True)
            for what, f in (("kernel", fn),
                            ("sdpa", _sdpa(q, kr, vr, *ints, scale))):
                eager = " ".join(f"{_time_ms(f):.4f}" for _ in range(3))
                graph = " ".join(f"{_graph_ms(f):.4f}" for _ in range(3))
                print(f"{tag} {name} {mix} {what}: eager ms {eager}, device "
                      f"ms {graph}", flush=True)
    ints = [torch.from_numpy(a).to(dev) for a in _mix("step")]
    print(f"{tag} host us a call: K8 wrapper, step mix "
          f"{_host_us(lambda: rpa.ragged_paged_attention(q, kp, vp, *ints, scale)):.2f}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port",
         sys.argv[2] if len(sys.argv) > 2 else "all")
