"""Time the grouped LoRA delta (K13) and the DMA route of the token-major
paged decode (K16) of the port found in the working directory, each
beside its yardstick.

- K13 at the llama3-8b multi-tenant step's shapes: x [32, 16, 4096]
  bf16, rank 8, 5 adapter slots (slot 0 the zero identity), N 4096 (the
  q delta) and N 1024 (the v delta); beside two fp32 ``torch.bmm`` on
  the pre-gathered A and B.
- K16 and K14 at llama2-7b's paged decode (B 8, 32 heads of 128, page
  128, 16 blocks, 1088 tokens a sequence, bf16); beside SDPA on the
  pre-gathered pages.

Each is read three times eager (CUDA events around 20 calls) and three
times on the device alone (20 calls captured in a CUDA graph and
replayed), beside the bound (each input byte read once and each output
byte written once at 3.35 TB/s); then the host time of one K13 wrapper
call is printed (the best of seven loops of 400 calls). Only entries
that every version of the port has are used, so two checkouts, a change
and its parent, can be timed in turn on one card::

    cd <checkout> && python3 <path to this file> <tag>

Each reading is printed on a line of its own that starts with <tag>.
The script checks every kernel's output against its plain version
(K13 within 1e-5 of each row's scale, K16 and K14 within 3 bf16 ulps)
and K16 bit-equal to K14 before it times them, and prints digests of
K16's outputs on fixed seeded inputs (the timed case, ragged lengths
with 0, 1 and a full table, and the reference's fp32 gate shape of 8
heads and pages of 16), so that two checkouts' bits can be compared.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
LORA_TOL = 1e-5
BF16_TOL = 3 * 2 ** -7


def _scaled_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got - ref).abs() / torch.maximum(ref.abs(), rms)
            .clamp_min(1e-30)).max().item()


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _report(tag, name, fns) -> None:
    from paddle_tpu_torch.obs.flash_timing import _graph_ms, _time_ms

    for what, fn in fns:
        eager = " ".join(f"{_time_ms(fn):.4f}" for _ in range(3))
        graph = " ".join(f"{_graph_ms(fn):.4f}" for _ in range(3))
        print(f"{tag} {name} {what}: eager ms {eager}, device ms {graph}",
              flush=True)


def lora(tag, dev, gen) -> None:
    from paddle_tpu_torch.obs.flash_timing import _host_us
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    C, qb, H, r, S = 32, 16, 4096, 8, 5
    bf = torch.bfloat16
    x = torch.randn((C, qb, H), generator=gen, device=dev).to(bf)
    ids = torch.from_numpy(np.random.RandomState(22).randint(
        0, S, size=C).astype(np.int32)).to(dev)
    ids[:3] = torch.tensor([0, 1, 4], dtype=torch.int32, device=dev)
    for N in (4096, 1024):
        a = (torch.randn((S, H, r), generator=gen, device=dev) * 0.05).to(bf)
        b = (torch.randn((S, r, N), generator=gen, device=dev) * 0.05).to(bf)
        a[0], b[0] = 0, 0
        got = lm.lora_matmul(x, a, b, ids)
        err = _scaled_err(got, lm.lora_matmul_plain(x, a, b, ids))
        if not err <= LORA_TOL or not (got[ids == 0] == 0).all():
            raise AssertionError(f"K13 N{N}: scaled error {err}")
        used = len(set(ids.tolist()))
        nbytes = (x.numel() * 2 + used * (H * r + r * N) * 2 + C * 4
                  + C * qb * N * 4)
        print(f"{tag} K13 N{N} output digest {_digest(got)}, scaled error "
              f"{err:.3e}, bound ms {nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
              flush=True)
        xf = x.float()
        ag, bg = a[ids.long()].float(), b[ids.long()].float()
        _report(tag, f"K13 C{C} qb{qb} H{H} r{r} N{N}", (
            ("kernel", lambda: lm.lora_matmul(x, a, b, ids)),
            ("two bmm", lambda: torch.bmm(torch.bmm(xf, ag), bg))))
        if N == 4096:
            host = _host_us(lambda: lm.lora_matmul(x, a, b, ids))
        del ag, bg, xf
    print(f"{tag} host us a call: K13 wrapper N4096 {host:.2f}", flush=True)


def _pages(gen, dev, dt, B, nh, d, bs, mb):
    P = B * mb + 5
    q = torch.randn((B, nh, d), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((P, nh, bs, d), generator=gen, device=dev).to(dt)
            for _ in range(2))
    table = torch.randperm(P, generator=gen, device=dev)[:B * mb] \
        .reshape(B, mb).to(torch.int32)
    return q, k, v, table


def paged(tag, dev, gen) -> None:
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, nh, d, bs, mb, n = 8, 32, 128, 128, 16, 1088
    scale = d ** -0.5
    q, k, v, table = _pages(gen, dev, torch.bfloat16, B, nh, d, bs, mb)
    lens = torch.full((B,), n, dtype=torch.int32, device=dev)
    rag = torch.tensor([1, 700, 2048, 0, 129, 1088, 127, 1024],
                       dtype=torch.int32, device=dev)
    outs = []
    for sl in (lens, rag):
        args = (q, k, v, table, sl, scale)
        k16 = da.paged_decode_attention_dma(*args)
        k14 = da.paged_decode_attention_kernel(*args)
        err = _scaled_err(k16, da.paged_decode_plain(*args))
        if not torch.equal(k16, k14) or not err <= BF16_TOL:
            raise AssertionError(f"K16: equal to K14 "
                                 f"{torch.equal(k16, k14)}, error {err}")
        outs.append(k16)
    # the reference's fp32 gate shape: 8 heads, pages of 16
    q32, k32, v32, t32 = _pages(gen, dev, torch.float32, 8, 8, d, 16, 64)
    rag32 = torch.tensor([0, 1, 15, 16, 17, 500, 1023, 1024],
                         dtype=torch.int32, device=dev)
    args32 = (q32, k32, v32, t32, rag32, scale)
    k16 = da.paged_decode_attention_dma(*args32)
    if not torch.equal(k16, da.paged_decode_attention_kernel(*args32)):
        raise AssertionError("K16 fp32 nh8 bs16: not equal to K14")
    outs.append(k16)
    print(f"{tag} K16 output digest {_digest(*outs)} (bf16 1088 tokens, "
          "bf16 ragged, fp32 nh8 bs16 ragged)", flush=True)
    nbytes = 2 * n * B * nh * d * 2 + 2 * q.numel() * 2
    print(f"{tag} K16 bound ms {nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
          flush=True)
    args = (q, k, v, table, lens, scale)
    t = table.long()
    kg, vg = (x[t].transpose(1, 2).reshape(B, nh, mb * bs, d).contiguous()
              for x in (k, v))
    mask = (torch.arange(mb * bs, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    _report(tag, f"paged B{B} nh{nh} d{d} bs{bs} {n} tokens", (
        ("K16", lambda: da.paged_decode_attention_dma(*args)),
        ("K14", lambda: da.paged_decode_attention_kernel(*args)),
        ("sdpa", lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale))))


def main(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{tag} card {smi[0] if smi else 'unknown'}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    lora(tag, dev, gen)
    paged(tag, dev, gen)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port")
