"""Time the decode attention kernels of the port found in the working
directory: K10 and K10q (dense GQA decode) and K15 (d-major paged
decode), each beside its SDPA yardstick.

- K10 at llama1b's decode shapes (nKV 4, G 4, S 2048, d 128, bf16) at B
  1, 8 and 16 and cache positions 639 and 2047; SDPA on the repeated
  cache cut at pos.
- K10q at the same shapes with int8 caches and fp32 per-position
  scales; SDPA on the dequantized repeated cache.
- K15 at llama2-7b's paged decode (B 8, 32 heads of 128, page 128,
  1088 tokens a sequence, bf16) and at llama3-8b's GQA (8 kv heads of 4
  q heads); SDPA on the pre-gathered (repeated) pages.

Each is read three times eager (CUDA events around 20 calls) and three
times on the device alone (20 calls captured in a CUDA graph and
replayed), then the host time of one K10 wrapper call is printed (the
best of seven loops of 400 calls). Only entries that every version of
the port with K15 has are used, so two checkouts, a change and its
parent, can be timed in turn on one card::

    cd <checkout> && python3 <path to this file> <tag>

Each reading is printed on a line of its own that starts with <tag>.
The script checks every kernel's output against its plain version
(scaled error within 3 bf16 ulps) before it times it, and for K15
prints a digest of its outputs on fixed seeded inputs, so that two
checkouts' bits can be compared.
"""

from __future__ import annotations

import hashlib
import os
import sys

import torch

BF16_TOL = 3 * 2 ** -7


def _scaled_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got - ref).abs() / torch.maximum(ref.abs(), rms)).max().item()


def _report(tag, name, fns) -> None:
    from paddle_tpu_torch.obs.flash_timing import _graph_ms, _time_ms

    for what, fn in fns:
        eager = " ".join(f"{_time_ms(fn):.4f}" for _ in range(3))
        graph = " ".join(f"{_graph_ms(fn):.4f}" for _ in range(3))
        print(f"{tag} {name} {what}: eager ms {eager}, device ms {graph}",
              flush=True)


def _dense(tag, dev, gen) -> None:
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.quant import dequantize_int8

    sdpa = torch.nn.functional.scaled_dot_product_attention
    nKV, G, S, d = 4, 4, 2048, 128
    scale = d ** -0.5
    bf = torch.bfloat16
    for B in (1, 8, 16):
        q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(bf)
        ck, cv = (torch.randn((B, nKV, S, d), generator=gen,
                              device=dev).to(bf) for _ in range(2))
        kq, vq = (torch.randint(-127, 128, (B, nKV, S, d), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((B, nKV, S), generator=gen, device=dev) * 0.02
                  + 0.01 for _ in range(2))
        kd, vd = (dequantize_int8(x, s[..., None], bf)
                  for x, s in ((kq, ks), (vq, vs)))
        qh = q[:, :, None, :]
        for pos in (639, 2047):
            for name, k, v, kw in (("K10", ck, cv, {}),
                                   ("K10q", kq, vq, {"k_scale": ks,
                                                     "v_scale": vs})):
                got = da.decode_attention(q, k, v, pos, scale, **kw)
                ref = da.decode_attention_plain(q, k, v, pos, scale,
                                                kw.get("k_scale"),
                                                kw.get("v_scale"))
                err = _scaled_err(got, ref)
                if not err <= BF16_TOL:
                    raise AssertionError(f"{name} B{B} pos {pos}: {err}")
                kr, vr = ((ck, cv) if name == "K10" else (kd, vd))
                kr = kr[:, :, :pos + 1].repeat_interleave(G, dim=1)
                vr = vr[:, :, :pos + 1].repeat_interleave(G, dim=1)
                _report(tag, f"{name} B{B} pos {pos}", (
                    ("kernel", lambda: da.decode_attention(
                        q, k, v, pos, scale, **kw)),
                    ("sdpa", lambda: sdpa(qh, kr, vr, scale=scale))))
                del kr, vr
    from paddle_tpu_torch.obs.flash_timing import _host_us

    q = q[:1].contiguous()
    ck, cv = ck[:1].contiguous(), cv[:1].contiguous()
    print(f"{tag} host us a call: K10 wrapper B1 pos 639 "
          f"{_host_us(lambda: da.decode_attention(q, ck, cv, 639, scale)):.2f}",
          flush=True)


def _paged(tag, dev, gen) -> None:
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, d, bs, mb, n = 8, 128, 128, 16, 1088
    scale = d ** -0.5
    for nkv, G in ((32, 1), (8, 4)):
        P = B * mb + 5
        q = torch.randn((B, nkv * G, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kt = torch.randn((P, nkv, d, bs), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((P, nkv, bs, d), generator=gen, device=dev).to(
            torch.bfloat16)
        table = torch.randperm(P, generator=gen, device=dev)[:B * mb] \
            .reshape(B, mb).to(torch.int32)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        args = (q, kt, v, table, lens, scale)
        got = da.paged_decode_attention_mxu(*args)
        err = _scaled_err(got, da.paged_decode_mxu_plain(*args))
        if not err <= BF16_TOL:
            raise AssertionError(f"K15 nkv{nkv} G{G}: {err}")
        # bits on ragged lengths, a length 0 and a full table among them
        rag = torch.tensor([1, 700, 2048, 0, 129, 1088, 127, 1024],
                           dtype=torch.int32, device=dev)
        bits = da.paged_decode_attention_mxu(q, kt, v, table, rag, scale)
        digest = hashlib.sha256(torch.cat([got, bits]).view(torch.int16)
                                .cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"{tag} K15 nkv{nkv} G{G} output digest {digest}", flush=True)
        t = table.long()
        kg = kt[t].transpose(3, 4)
        kg, vg = (x.transpose(1, 2).reshape(B, nkv, mb * bs, d)
                  .repeat_interleave(G, dim=1).contiguous()
                  for x in (kg, v[t]))
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qh = q[:, :, None, :]
        _report(tag, f"K15 B{B} nkv{nkv} G{G} d{d} bs{bs} {n} tokens", (
            ("kernel", lambda: da.paged_decode_attention_mxu(*args)),
            ("sdpa", lambda: sdpa(qh, kg, vg, attn_mask=mask,
                                  scale=scale))))
        del kg, vg, kt, v


def main(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    _dense(tag, dev, gen)
    _paged(tag, dev, gen)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port")
