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
kernel does not check them) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lora_matmul", "lora_matmul_plain", "SUPPORTED_RANKS"]

SUPPORTED_RANKS = (4, 8, 16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def lora_matmul_plain(x, a_stack, b_stack, ids) -> torch.Tensor:
    """Gather each row's adapter pair, then the two fp32 products in the
    reference's order."""
    a = a_stack[ids.long()]                          # [C, H, r]
    b = b_stack[ids.long()]                          # [C, r, N]
    t = torch.einsum("cqh,chr->cqr", x.float(), a.float())
    return torch.einsum("cqr,crn->cqn", t, b.float())


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.library("lora_matmul").lora_matmul
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 6 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def lora_matmul(x, a_stack, b_stack, ids) -> torch.Tensor:
    """K13: fp32 [C, qb, N] (see the module docstring). Counts its CUDA
    launches in ``lora_matmul.launches``."""
    if x.device.type == "cpu":
        return lora_matmul_plain(x, a_stack, b_stack, ids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    C, qb, H = x.shape
    S, r, N = b_stack.shape
    if x.dtype not in _DTYPE_CODE or a_stack.dtype != x.dtype or \
            b_stack.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, stacks {a_stack.dtype} / "
                        f"{b_stack.dtype}: the kernel takes float32 or "
                        "bfloat16, all alike")
    if tuple(a_stack.shape) != (S, H, r) or r not in SUPPORTED_RANKS:
        raise ValueError(f"stacks {tuple(a_stack.shape)} / "
                         f"{tuple(b_stack.shape)} for x {tuple(x.shape)}: "
                         f"want [S, H, r] and [S, r, N], r in "
                         f"{SUPPORTED_RANKS}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (C,):
        raise ValueError(f"ids must be int32 ({C},), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    for t in (x, a_stack, b_stack, ids):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"all operands must be contiguous and on "
                             f"{x.device}")
    out = torch.empty((C, qb, N), dtype=torch.float32, device=x.device)
    err = _kernel_fn()(
        x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
        ids.data_ptr(), out.data_ptr(), C, qb, H, r, N,
        _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lora_matmul")
    lora_matmul.launches += 1
    return out


lora_matmul.launches = 0
