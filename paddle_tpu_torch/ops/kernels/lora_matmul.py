"""Grouped per-row LoRA delta (K13, grouped BGMV): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/lora_matmul.py (kernel ``_lora_kernel``,
plain version ``_lora_xla``). Row c of a packed activation batch x
[C, qb, H] belongs to a request whose adapter sits in slot ``ids[c]`` of
the stacks a_stack [S, H, r] and b_stack [S, r, N]:

    out[c] = (x[c] @ A[ids[c]]) @ B[ids[c]]        # fp32 [qb, N]

both products in fp32. Slot 0 is the all-zero identity, so a row without
an adapter gets an exact +0.0.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
always launches ``csrc/lora_matmul.cu`` (``ids`` must lie in [0, S); the
kernel does not check them) or raises. The kernel takes the reference's
gate (qb % 8, H % 128, N % 128) with r in ``SUPPORTED_RANKS``: a cluster
of blocks serves a packed row, each block a slice of H for the shrink
(on the tensor cores for bf16 at r 8 and 16, fp32 sums of exact
products; FMAs otherwise) and a slice of N for the expand, the partial
shrinks summed across the cluster in rank order (``lora_plan``). The C entry reports the kernel it
launched; ``LAUNCHES_BY_PLAN`` counts launches by (variant, dtype, H, N,
r), so a run can hold every launch to ``lora_plan`` and the C launcher's
plan (``lora_plan_c``) at every shape it launched.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

__all__ = ["lora_matmul", "lora_matmul_plain", "lora_plan", "lora_plan_c",
           "SUPPORTED_RANKS", "LAUNCHES_BY_PLAN"]

SUPPORTED_RANKS = (4, 8, 16)
ROW_GROUP = 16               # kRowGroup: rows of x a pass, two a warp
QB_MULTIPLE = 8              # the reference's gate on qb
MAX_CLUSTER = 8              # kMaxCluster: a portable cluster
MAX_STAGES = 4               # kMaxStages
BLOCKS_PER_SM = 3            # kBlocksPerSm: the step's 256 blocks at once
BAR_BYTES = 128              # the block's mbarriers
B_STAGE_BYTES = 16384        # kBStageBytes: B's slice in shared memory
X_PAD = 8                    # kXPad: x rows 16 bytes further apart
SM_SMEM_BYTES = 233472       # shared memory of an H100 SM
BLOCK_SMEM_RESERVED = 1024   # held back by the card for every block
WARPS = 8                    # kWarps: the computing warps
THREADS = WARPS * 32 + 32    # kThreads: and a producer warp
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = ("float32", "bfloat16")
_VARIANTS = ("cluster",)     # the C entry's *variant codes
# launches on CUDA tensors by (variant as the C entry reported it, dtype,
# H, N, r)
LAUNCHES_BY_PLAN: collections.Counter = collections.Counter()
_fns: dict = {}


def lora_matmul_plain(x, a_stack, b_stack, ids) -> torch.Tensor:
    """Gather each row's adapter pair, then the two fp32 products in the
    reference's order."""
    a = a_stack[ids.long()]                          # [C, H, r]
    b = b_stack[ids.long()]                          # [C, r, N]
    t = torch.einsum("cqh,chr->cqr", x.float(), a.float())
    return torch.einsum("cqr,crn->cqn", t, b.float())


def lora_plan(H: int, N: int, r: int, itemsize: int) -> dict:
    """K13's launch, as ``csrc/lora_matmul.cu::lora_plan`` makes it: a
    cluster of ``cluster`` blocks a packed row (the most, a power of two
    up to 8, that divides H / 128); block k takes the k-th ``h_slice`` of
    H for the shrink and the k-th ``n_slice`` of N for the expand; its H
    slice is copied in chunks of ``h_chunk`` (the largest of 512, 256, 128
    that divides the slice and leaves room for two stages) beside the
    chunk's rows of A, 16 rows of x a stage (rows ``X_PAD`` elements
    apart beyond the chunk), in a ring of ``stages`` (2 to 4, as many as
    leave ``BLOCKS_PER_SM`` blocks room on an SM beside the barriers, B's
    slice where ``b_stage`` (at most 16 KB), the partials of every rank,
    double-buffered, t and the warps' sums); ``threads`` a block and
    ``smem`` shared bytes. Raises outside the gate (H % 128, N % 128,
    r in ``SUPPORTED_RANKS``). qb and C do not enter it: a row's bits do
    not depend on the call that carries it."""
    if (H <= 0 or N <= 0 or H % 128 or N % 128 or r not in SUPPORTED_RANKS
            or itemsize not in (2, 4)):
        raise ValueError(f"H {H}, N {N}, r {r}, itemsize {itemsize}: K13 "
                         "takes H % 128 == 0, N % 128 == 0, r in "
                         f"{SUPPORTED_RANKS}, float32 or bfloat16")
    cluster = MAX_CLUSTER
    while (H // 128) % cluster:
        cluster //= 2
    h_slice, n_slice = H // cluster, N // cluster
    b_bytes = r * n_slice * itemsize
    b_stage = int(b_bytes <= B_STAGE_BYTES)
    fixed = (BAR_BYTES + b_stage * b_bytes
             + 4 * (2 * MAX_CLUSTER + 1 + WARPS) * ROW_GROUP * r)
    room = SM_SMEM_BYTES // BLOCKS_PER_SM - BLOCK_SMEM_RESERVED
    for h_chunk in (512, 256, 128):
        stage = (ROW_GROUP * (h_chunk + X_PAD) + h_chunk * r) * itemsize
        if h_slice % h_chunk == 0 and fixed + 2 * stage <= room:
            stages = min(MAX_STAGES, (room - fixed) // stage)
            return {"cluster": cluster, "h_slice": h_slice,
                    "n_slice": n_slice, "h_chunk": h_chunk, "stages": stages,
                    "b_stage": b_stage, "threads": THREADS,
                    "smem": fixed + stages * stage}
    raise ValueError(f"H {H}, N {N}, r {r}: no two-stage K13 ring fits")


_gate = functools.lru_cache(maxsize=None)(lora_plan)


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("lora_matmul"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([I] * 4 + [P] if name == "lora_plan_c"
                       else [P] * 5 + [I] * 6 + [P, P])
        fn.restype = I
        _fns[name] = fn
    return fn


def lora_plan_c(H: int, N: int, r: int, itemsize: int) -> dict:
    """The plan K13's C launcher follows (``lora_plan_c`` in the
    library), to hold ``lora_plan`` to it on the card."""
    out = (ctypes.c_int * 8)()
    _build.check(_fn("lora_plan_c")(H, N, r, itemsize,
                                    ctypes.addressof(out)), "lora_plan_c")
    return dict(zip(("cluster", "h_slice", "n_slice", "h_chunk", "stages",
                     "b_stage", "threads", "smem"), out))


_variant = ctypes.c_int(-1)
_variant_ref = ctypes.byref(_variant)


def _launch(x, a_stack, b_stack, ids) -> torch.Tensor:
    """The CUDA arm: the operand checks, one ctypes call, nothing
    allocated but the output; counts the launch under the variant the C
    entry reported."""
    dev, dt = x.device, x.dtype
    C, qb, H = x.shape
    S, r, N = b_stack.shape
    code = _DTYPE_CODE.get(dt)
    if code is None or a_stack.dtype != dt or b_stack.dtype != dt:
        raise TypeError(f"x {dt}, stacks {a_stack.dtype} / "
                        f"{b_stack.dtype}: the kernel takes float32 or "
                        "bfloat16, all alike")
    if a_stack.shape != (S, H, r) or qb % QB_MULTIPLE:
        raise ValueError(f"stacks {tuple(a_stack.shape)} / "
                         f"{tuple(b_stack.shape)} for x {tuple(x.shape)}: "
                         "want [S, H, r] and [S, r, N], qb % 8 == 0")
    _gate(H, N, r, 4 - 2 * code)                 # raises outside the gate
    if ids.dtype != torch.int32 or ids.shape != (C,):
        raise ValueError(f"ids must be int32 ({C},), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    ptrs = (x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr())
    if (a_stack.device != dev or b_stack.device != dev or ids.device != dev
            or not (x.is_contiguous() and a_stack.is_contiguous()
                    and b_stack.is_contiguous() and ids.is_contiguous())
            or (ptrs[0] | ptrs[1] | ptrs[2]) % 16):
        raise ValueError(f"all operands must be contiguous and on {dev}, "
                         "x and the stacks 16-byte aligned")
    out = torch.empty((C, qb, N), dtype=torch.float32, device=dev)
    err = _fn("lora_matmul")(
        *ptrs, ids.data_ptr(), out.data_ptr(), C, qb, H, r, N, code,
        torch.cuda.current_stream(dev).cuda_stream, _variant_ref)
    if err:
        _build.check(err, "lora_matmul")
    LAUNCHES_BY_PLAN[(_VARIANTS[_variant.value], _DTYPE_NAME[code], H, N,
                      r)] += 1
    return out


def lora_matmul(x, a_stack, b_stack, ids) -> torch.Tensor:
    """K13: fp32 [C, qb, N] (see the module docstring). Counts its CUDA
    launches in ``lora_matmul.launches`` and in ``LAUNCHES_BY_PLAN``."""
    if x.device.type == "cpu":
        return lora_matmul_plain(x, a_stack, b_stack, ids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, a_stack, b_stack, ids)
    lora_matmul.launches += 1
    return out


lora_matmul.launches = 0
