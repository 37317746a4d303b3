"""Time the cross-entropy kernels and the bias + gelu kernel of the port
found in the working directory, each beside its yardstick.

- K4 (``fused_ce_fwd``) and K5 (``fused_ce_bwd``) at gpt3-350m's loss
  shape (N 16384, H 1024, V 50304, bf16) and at gpt3-1.3b's B 4 S 1024
  (N 4096, H 2048); beside them the bf16 cuBLAS products they compute:
  ``x @ w^T`` for K4, and for K5 each vocab slab's three, ``x @
  w_slab^T``, ``dl @ w_slab`` and ``dl^T @ x`` (slabs of 8192 columns,
  the last ragged).
- K7 (``bias_gelu_fwd``) at gpt3-350m's FFN [16384, 4096] bf16 with an
  fp32 bias; beside it ``F.gelu`` (tanh) on a pre-biased x.

Each is read three times eager (CUDA events around a run of calls) and
three times on the device alone (the calls captured in a CUDA graph and
replayed). Only entries that every version of the port with K4, K5 and
K7 has are used, so two checkouts, a change and its parent, can be timed
in turn on one card::

    cd <checkout> && python3 <path to this file> <tag>

Each reading is printed on a line of its own that starts with <tag>,
after the card's name and power limit. Digests of K7's output and of
K5's (dx, dhead) on fixed seeded inputs are printed too, K5's for two
calls, so that two checkouts' bits can be compared and K5's run-to-run
equality read.
"""

from __future__ import annotations

import hashlib
import math
import os
import subprocess
import sys

import torch

SHAPES = ((16384, 1024, 50304), (4096, 2048, 50304))
SLAB = 8192


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _report(tag, what, fn, iters) -> None:
    from paddle_tpu_torch.obs.flash_timing import _graph_ms, _time_ms

    eager = " ".join(f"{_time_ms(fn, iters=iters):.4f}" for _ in range(3))
    graph = " ".join(f"{_graph_ms(fn, iters=iters):.4f}" for _ in range(3))
    print(f"{tag} {what}: eager ms {eager}, device ms {graph}", flush=True)


def _ce(tag, dev) -> None:
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    for N, H, V in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(6)
        x = torch.randn((N, H), generator=gen, device=dev).to(torch.bfloat16)
        wte = (torch.randn((V, H), generator=gen, device=dev)
               * (3.0 / math.sqrt(H))).to(torch.bfloat16)
        lab = torch.randint(0, V, (N,), generator=gen, device=dev)
        g = torch.full((N,), 1.0 / N, device=dev)
        head = wte.t()
        _, lse = ce.fused_ce_fwd(x, head, lab)
        dx, dh = ce.fused_ce_bwd(x, head, lab, lse, g)
        dx2, dh2 = ce.fused_ce_bwd(x, head, lab, lse, g)
        print(f"{tag} K5 N{N} H{H} V{V} digests: {_digest(dx, dh)} "
              f"{_digest(dx2, dh2)}", flush=True)
        del dx, dh, dx2, dh2
        shape = f"N{N} H{H} V{V}"
        _report(tag, f"K4 {shape}", lambda: ce.fused_ce_fwd(x, head, lab), 5)
        _report(tag, f"K4 products (x @ w^T) {shape}", lambda: x @ wte.t(),
                5)
        _report(tag, f"K5 {shape}",
                lambda: ce.fused_ce_bwd(x, head, lab, lse, g), 3)
        slabs = [wte[v0:v0 + SLAB] for v0 in range(0, V, SLAB)]
        dls = [torch.randn((N, ws.shape[0]), generator=gen, device=dev).to(
            torch.bfloat16) * 1e-4 for ws in slabs]

        def products():
            for ws, dl in zip(slabs, dls):
                x @ ws.t()
                dl @ ws
                dl.t() @ x

        _report(tag, f"K5 products (3 a slab) {shape}", products, 3)
        del x, wte, head, lab, g, lse, slabs, dls
        torch.cuda.empty_cache()


def _bias_gelu(tag, dev) -> None:
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev).manual_seed(10)
    x = (2.0 * torch.randn((16384, 4096), generator=gen,
                           device=dev)).to(torch.bfloat16)
    b = 0.5 * torch.randn((4096,), generator=gen, device=dev)
    print(f"{tag} K7 [16384, 4096] digest: "
          f"{_digest(fba.bias_gelu_fwd(x, b))}", flush=True)
    _report(tag, "K7 [16384, 4096] bf16", lambda: fba.bias_gelu_fwd(x, b), 20)
    xb = x + b.to(torch.bfloat16)
    _report(tag, "F.gelu on x + b [16384, 4096] bf16",
            lambda: torch.nn.functional.gelu(xb, approximate="tanh"), 20)


def main(tag: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the timings need the card")
    sys.path.insert(0, os.getcwd())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{tag} card: {card.strip()}", flush=True)
    dev = torch.device("cuda")
    _bias_gelu(tag, dev)
    _ce(tag, dev)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port")
