"""Time variants of K13's source (``csrc/lora_matmul.cu``) against the
source itself, in turns on one card, at the llama3-8b multi-tenant
step's shapes (x [32, 16, 4096] bf16, rank 8, 5 slots; N 4096 and 1024).

Each variant is the source with a few constants or lines replaced
(``VARIANTS``); every one is built by ``nvcc`` (the flags of
``ops/kernels/_build.py``, plus ``-Xptxas -v``) into a library of its own
under ``paddle_tpu_torch/build/mutants/`` and called through ``ctypes``
with the source's C signature. Variants whose name starts with ``x_``
compute something else (a step removed) and are timed only, to see what
bounds the kernel; the others are held to the plain version (1e-5 of
each row's scale) before they are timed. For each (N, variant) the
device time of one call (20 calls in a CUDA graph) is printed for every
round, the rounds taking the variants in turn, forward then backward::

    python3 paddle_tpu_torch/obs/bgmv_mutants.py [name,name,...]

Each variant's registers and spills (ptxas) and plan (``lora_plan_c``)
are printed first.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

STORE = "          *reinterpret_cast<float4*>("
WAIT = "    mbar_wait_cluster(&ready[buf], (g >> 1) & 1);"
PUSH = "      if (tid < kRowGroup * R / 4) {"
SYNC = "  cluster_arrive_relaxed();  // waited for before the first push"
BLOCKS = "constexpr int kBlocksPerSm = 3;"
MMA = ("  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && "
       "R >= 8;")
MMA_LOOP = ("        for (int kk = warp * kw; kk < (warp + 1) * kw; "
            "kk += 16) {")

# name: {text in the source: its replacement}
VARIANTS = {
    "source": {},
    "blocks2": {BLOCKS: "constexpr int kBlocksPerSm = 2;"},
    "x_empty": {SYNC: SYNC + "\n  if (qb > 0) return;"},
    "x_no_store": {STORE: "          if (qb < 0) *reinterpret_cast<float4*>("},
    "fma_shrink": {MMA: "  constexpr bool kMma = false;"},
    "x_no_shrink": {MMA_LOOP: MMA_LOOP.replace("kk < (warp + 1) * kw",
                                               "kk < 0")},
    "x_no_exchange": {WAIT: "", PUSH: "      if (qb < 0) {"},
}
LORA_TOL = 1e-5


def _build(names):
    from paddle_tpu_torch.ops.kernels import _build as build

    src = (build.CSRC_DIR / "lora_matmul.cu").read_text()
    out = build.BUILD_DIR / "mutants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "hopper.cuh").write_bytes((build.CSRC_DIR / "hopper.cuh")
                                     .read_bytes())
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name].items():
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"lora_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"lora_{name}.so"), str(out / f"lora_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        k = re.findall(r"Compiling entry function '\S*lora_wg_kernelI(\S+?)"
                       r"Li(\d+)EE\S*'.*?(\d+) bytes spill stores.*?Used "
                       r"(\d+) registers", log, re.S)
        print(f"{name}: kernels (type, r, spill bytes, registers) "
              + ", ".join(f"({t[:4]}, {r}, {sp}, {n})" for t, r, sp, n in k),
              flush=True)
        lib = ctypes.CDLL(str(out / f"lora_{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lora_matmul.argtypes = [P] * 5 + [I] * 6 + [P, P]
        lib.lora_plan_c.argtypes = [I] * 4 + [P]
        libs[name] = lib
    return libs


def main(names) -> None:
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.obs.bgmv_dma_timing import _scaled_err
    from paddle_tpu_torch.obs.flash_timing import _graph_ms
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    libs = _build(names)
    C, qb, H, r, S = 32, 16, 4096, 8, 5
    for name, lib in libs.items():
        plans = []
        for N in (4096, 1024):
            plan = (ctypes.c_int * 8)()
            lib.lora_plan_c(H, N, r, 2, ctypes.addressof(plan))
            plans.append(list(plan))
        print(f"{name}: plans N 4096 / 1024 {plans}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    x = torch.randn((C, qb, H), generator=gen, device=dev).to(bf)
    ids = torch.from_numpy(np.random.RandomState(22).randint(
        0, S, size=C).astype(np.int32)).to(dev)
    stacks = {}
    for N in (4096, 1024):
        a = (torch.randn((S, H, r), generator=gen, device=dev) * 0.05).to(bf)
        b = (torch.randn((S, r, N), generator=gen, device=dev) * 0.05).to(bf)
        a[0], b[0] = 0, 0
        stacks[N] = (a, b, lm.lora_matmul_plain(x, a, b, ids))

    def call(lib, a, b, out):
        variant = ctypes.c_int(-1)
        err = lib.lora_matmul(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
            out.data_ptr(), C, qb, H, r, out.shape[2], 1,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(variant))
        if err or variant.value != 0:
            raise RuntimeError(f"CUDA error {err}, variant {variant.value}")

    times = {}
    order = list(libs.items())
    for rnd in range(4):
        for N, (a, b, ref) in stacks.items():
            for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                out = torch.empty((C, qb, N), device=dev)
                call(lib, a, b, out)
                err = _scaled_err(out, ref)
                if not name.startswith("x_") and not err <= LORA_TOL:
                    raise AssertionError(f"{name} N{N}: {err}")
                times.setdefault((N, name), []).append(
                    _graph_ms(lambda: call(lib, a, b, out)))
    for (N, name), ms in times.items():
        print(f"K13 N{N} {name}: device ms "
              + " ".join(f"{t:.4f}" for t in ms), flush=True)


if __name__ == "__main__":
    main(sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS))
