"""Time the flash forward of the port found in the working directory.

K1-sep (``flash_fwd_sep``), K11 (``rope_flash_fwd``, q rotated) and
SDPA on the same head-major operands at llama1b's prefill shapes (B 1
and 16, S 512, h 16, d 128, bf16): three eager readings each (CUDA
events around 20 calls), three on the device alone (20 calls captured
in a CUDA graph and replayed) and three eager ones again after those
captures, then the host time of one K1-sep
wrapper call and of one ``torch.cuda.current_stream`` query (the best of
seven loops of 400 calls; the launch queue never fills, the device being
faster). Only entries that every version of the port with K11 has are
used, so two checkouts, a change and its parent, can be timed in turn on
one card::

    cd <checkout> && python3 <path to this file> <tag>

Each reading is printed on a line of its own that starts with <tag>.
"""

from __future__ import annotations

import os
import sys
import time

import torch

ITERS = 20


def _time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
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


def _graph_ms(fn, iters: int = ITERS) -> float:
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


def _host_us(fn, n: int = 400) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def main(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.models.llama import LlamaConfig, rope_angles
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    S, h, d, scale = 512, 16, 128, 128 ** -0.5
    cos, sin = rope_angles(LlamaConfig(hidden=h * d, n_heads=h),
                           torch.arange(S, device=dev))
    for B in (1, 16):
        q, k, v = (torch.randn((B, S, h, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fns = (("K1-sep", lambda: fa.flash_fwd_sep(q, k, v, True, scale)),
               ("K11", lambda: fra.rope_flash_fwd(q, k, v, cos, sin, True,
                                                  scale, True, False)),
               ("SDPA", lambda: sdpa(qh, kh, vh, is_causal=True)))
        for name, fn in fns:
            eager = " ".join(f"{_time_ms(fn):.4f}" for _ in range(3))
            graph = " ".join(f"{_graph_ms(fn):.4f}" for _ in range(3))
            again = " ".join(f"{_time_ms(fn):.4f}" for _ in range(3))
            print(f"{tag} {name} B{B} S{S} h{h} d{d}: eager ms {eager}, "
                  f"device ms {graph}, eager after the captures {again}",
                  flush=True)
        if B == 1:
            wrapper = _host_us(fns[0][1])
            stream = _host_us(lambda: torch.cuda.current_stream(dev))
            print(f"{tag} host us a call: K1-sep wrapper {wrapper:.2f}, "
                  f"torch.cuda.current_stream {stream:.2f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port")
