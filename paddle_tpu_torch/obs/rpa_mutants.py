"""Time variants of K8 / K8q's source (``csrc/ragged_paged_attention.cu``)
against the source itself, in turns on one card, on the three mixes of
``obs/rpa_timing.py``.

Each variant is the source with a few constants or lines replaced
(``VARIANTS``); every one is built by ``nvcc`` (the flags of
``ops/kernels/_build.py``, plus ``-Xptxas -v``) into a library of its own
under ``paddle_tpu_torch/build/mutants/`` and called through ``ctypes``
with the source's C signature. Variants whose name starts with ``x_``
compute something else (a product or the softmax's exps removed) and
are timed only, to see what bounds the kernel; the others are held to
the plain version (2e-2 on the valid rows) before they are timed. For
each (mix, K8 or K8q, variant) the device time of one call (20 calls in
a CUDA graph) is printed for every round, the rounds taking the variants
in turn, forward then backward::

    python3 paddle_tpu_torch/obs/rpa_mutants.py [name,name,...]

Each wgmma kernel's registers and spills (ptxas) and each variant's plan
(``rpa_plan_c``) are printed first.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

SOFTMAX_EXP = "      const float p = expf(sc[i] - ((i & 2) ? mn_hi : mn_lo));"
PV = ("      wgmma_rs<D, 1>(o, pa[kk], sw128_mn_desc(vt + kk * 2048, "
      "kVChunk));")
S = ("      wgmma_rs<kTileKeys, 1>(sc, qa[kd],\n"
     "                             sw128_mn_desc(kt + kd * 2048, kVChunk), "
     "kd > 0);")
NO_S = "      for (int z = 0; z < kTileKeys / 2; ++z) sc[z] = 0.f;"
I2F = """    w[2 * i] = bf16x2_rn(__fmul_rn(i8_to_f(in[i], 0), s),
                         __fmul_rn(i8_to_f(in[i], 1), s));
    w[2 * i + 1] = bf16x2_rn(__fmul_rn(i8_to_f(in[i], 2), s),
                             __fmul_rn(i8_to_f(in[i], 3), s));"""
I2F_SLOW = """    const int8_t* b = reinterpret_cast<const int8_t*>(&raw) + 4 * i;
    w[2 * i] = pack2(bf16_bits(__fmul_rn((float)b[0], s)),
                     bf16_bits(__fmul_rn((float)b[1], s)));
    w[2 * i + 1] = pack2(bf16_bits(__fmul_rn((float)b[2], s)),
                         bf16_bits(__fmul_rn((float)b[3], s)));"""
SPLIT = "constexpr int kSplitKeys = 1024;"
BLOCKS = "constexpr int kBlocksPerSm = 3;"

# name: {text in the source: its replacement}
VARIANTS = {
    "source": {},
    "split256_2sm": {SPLIT: "constexpr int kSplitKeys = 256;",
                     BLOCKS: "constexpr int kBlocksPerSm = 2;"},
    "split512": {SPLIT: "constexpr int kSplitKeys = 512;"},
    "split2048": {SPLIT: "constexpr int kSplitKeys = 2048;"},
    "stages3_2sm": {BLOCKS: "constexpr int kBlocksPerSm = 2;"},
    "i2f_dequant": {I2F: I2F_SLOW},
    "x_no_exp": {SOFTMAX_EXP: SOFTMAX_EXP.replace("expf(", "(")},
    "x_no_products": {PV: "      (void)0;", S: NO_S},
}


def _build(names):
    from paddle_tpu_torch.ops.kernels import _build as build

    src = (build.CSRC_DIR / "ragged_paged_attention.cu").read_text()
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
        (out / f"{name}.cu").write_text(text)
        flags = [f for f in build.NVCC_FLAGS]
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        wg = re.findall(r"Compiling entry function '\S*rpa_wg_kernelILi(\d+)"
                        r"ELb(\d)\S*'.*?(\d+) bytes spill stores.*?Used "
                        r"(\d+) registers", log, re.S)
        print(f"{name}: wgmma kernels (d, int8, registers, spill bytes) "
              + ", ".join(f"({d}, {q}, {r}, {sp})" for d, q, sp, r in wg),
              flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rpa_forward.argtypes = [P] * 7 + [I] * 8 + [ctypes.c_float, I,
                                                        P, P]
        lib.rpa_forward_int8.argtypes = [P] * 9 + [I] * 8 + [
            ctypes.c_float, I, P, P]
        lib.rpa_plan_c.argtypes = [I] * 7 + [P]
        libs[name] = lib
    return libs


def main(names) -> None:
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.obs import rpa_timing as rt
    from paddle_tpu_torch.obs.flash_timing import _graph_ms
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.quant import dequantize_int8

    libs = _build(names)
    C, QB, NH, NKV, D, BS, MB, P = (rt.C, rt.QB, rt.NH, rt.NKV, rt.D, rt.BS,
                                    rt.MB, rt.P)
    for name, lib in libs.items():
        plan = (ctypes.c_int * 9)()
        lib.rpa_plan_c(MB, BS, D, NH // NKV, QB, 1, 0,
                       ctypes.addressof(plan))
        print(f"{name}: plan {list(plan)}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    q = torch.randn((C, QB, NH, D), generator=gen, device=dev).to(bf)
    kp = torch.randn((P, NKV, D, BS), generator=gen, device=dev).to(bf)
    vp = torch.randn((P, NKV, BS, D), generator=gen, device=dev).to(bf)
    kq, vq = (torch.randint(-127, 128, x.shape, generator=gen, device=dev,
                            dtype=torch.int8) for x in (kp, vp))
    ks, vs = (torch.rand((P, NKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2))
    kd = dequantize_int8(kq, ks[:, :, None, None], bf)
    vd = dequantize_int8(vq, vs[:, :, None, None], bf)
    scale = D ** -0.5

    def call(lib, quant, ints, out):
        variant = ctypes.c_int(-1)
        st = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in ints]
        if quant:
            err = lib.rpa_forward_int8(
                q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), *ptrs, out.data_ptr(), C, QB, NH, NKV, D, BS,
                MB, P, scale, 1, st, ctypes.byref(variant))
        else:
            err = lib.rpa_forward(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *ptrs,
                out.data_ptr(), C, QB, NH, NKV, D, BS, MB, P, scale, 1, st,
                ctypes.byref(variant))
        if err or variant.value != 2:
            raise RuntimeError(f"CUDA error {err}, variant {variant.value}")

    times = {}
    order = list(libs.items())
    for rnd in range(4):
        for mix in ("step", "decode", "prefill"):
            ints = [torch.from_numpy(a).to(dev) for a in rt._mix(mix)]
            valid = torch.arange(QB, device=dev)[None, :] < ints[2][:, None]
            for quant in (False, True):
                ref = rpa.ragged_paged_attention_plain(
                    q, kd if quant else kp, vd if quant else vp, *ints,
                    scale)
                for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                    out = torch.empty_like(q)
                    call(lib, quant, ints, out)
                    err = (out.float() - ref.float()).abs()[valid].max()
                    if not name.startswith("x_") and not err <= rt.ATOL:
                        raise AssertionError(f"{name} {mix}: {err.item()}")
                    times.setdefault((mix, quant, name), []).append(
                        _graph_ms(lambda: call(lib, quant, ints, out)))
    for (mix, quant, name), ms in times.items():
        print(f"{mix} {'K8q' if quant else 'K8'} {name}: device ms "
              + " ".join(f"{t:.4f}" for t in ms), flush=True)


if __name__ == "__main__":
    main(sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS))
