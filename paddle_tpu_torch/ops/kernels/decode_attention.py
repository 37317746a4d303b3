"""One-token GQA attention over a dense KV cache (K10): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/decode_attention.py, kernel
``_decode_kernel`` (the fp cache arm of ``decode_attention``): q [B, nH, d]
(the step's token), cache_k / cache_v [B, nKV, S, d] in the engine's
kv-head-major layout, ``pos`` the last valid cache index; o [B, nH, d].
The G = nH / nKV query heads of a kv head are served together (no
repeated cache) and positions past ``pos`` are never read.

K10q is the kernel's int8 arm (``quant=True``): int8 caches with fp32
per-position scales ``k_scale`` / ``v_scale`` [B, nKV, S], dequantized as
``ops/quant.py::dequantize_int8`` does (fp32 multiply, cast to q's dtype)
where the chunk is staged. As in the reference, no engine calls it: it is
reached through ``decode_attention(..., k_scale=, v_scale=)``.

On a CPU tensor the wrappers run the plain version, the masked dense
expression of the reference's ``_decode_block`` fallback (on the
dequantized cache for int8); on a CUDA tensor they launch
``csrc/decode_attention.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import dequantize_int8
from . import _build

__all__ = ["decode_attention", "decode_attention_int8",
           "decode_attention_plain", "decode_attention_supported", "BLOCK_S"]

BLOCK_S = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def decode_attention_supported(cache_shape, head_dim: int,
                               num_heads: int | None = None) -> bool:
    """The reference's gate, term for term, so that the port takes the
    same route: d in (64, 128, 256); with ``num_heads``, nH a multiple of
    nKV with G >= 2 (MHA takes the dense expression); S one block (a
    128-multiple up to 512) or a whole number of 512-blocks."""
    _, nKV, S, d = cache_shape
    if d not in (64, 128, 256):
        return False
    if num_heads is not None:
        if num_heads % nKV or num_heads // nKV < 2:
            return False
    return (S % 128 == 0) if S <= BLOCK_S else (S % BLOCK_S == 0)


def decode_attention_plain(q, cache_k, cache_v, pos: int, sm_scale: float,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The masked dense expression: every cache row scored, rows past
    ``pos`` filled with -1e30, softmax in fp32, p cast to q's dtype. An
    int8 cache is dequantized first with its per-position scales."""
    if k_scale is not None:
        cache_k = dequantize_int8(cache_k, k_scale[..., None], q.dtype)
        cache_v = dequantize_int8(cache_v, v_scale[..., None], q.dtype)
    B, nKV, S, d = cache_k.shape
    G = q.shape[1] // nKV
    kf = cache_k.repeat_interleave(G, dim=1).to(q.dtype)   # [B, nH, S, d]
    vf = cache_v.repeat_interleave(G, dim=1).to(q.dtype)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kf.float()) * sm_scale
    mask = torch.arange(S, device=q.device) <= pos
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", p.float(), vf.float()).to(q.dtype)


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("decode_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name in ("decode_attention", "decode_attention_int8"):
            n_ptr = 5 if name == "decode_attention" else 7
            fn.argtypes = [P] * n_ptr + [I] * 6 + [ctypes.c_float, I, P]
            fn.restype = I
        else:
            fn.argtypes = [I] * 5
            fn.restype = ctypes.c_longlong
        _fns[name] = fn
    return fn


def _check(q, cache_k, cache_v, pos: int, cache_dtype) -> None:
    if q.dtype not in _DTYPE_CODE or cache_k.dtype != cache_dtype or \
            cache_v.dtype != cache_dtype:
        raise TypeError(f"q {q.dtype} / cache {cache_k.dtype}, "
                        f"{cache_v.dtype}: the kernel takes a float32 or "
                        f"bfloat16 q and {cache_dtype} caches")
    B, nKV, S, d = cache_k.shape
    if (q.dim() != 3 or q.shape[0] != B or q.shape[2] != d
            or q.shape[1] % nKV or cache_v.shape != cache_k.shape):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache_k.shape)} "
                         f"/ {tuple(cache_v.shape)}: want [B, nKV*G, d] and "
                         "two [B, nKV, S, d]")
    G = q.shape[1] // nKV
    if d not in (64, 128, 256) or not 1 <= G <= 16 or not 0 <= pos < S:
        raise ValueError(f"d {d}, G {G}, pos {pos} of S {S}: the kernel "
                         "takes d in (64, 128, 256), G <= 16, 0 <= pos < S")
    for t in (q, cache_k, cache_v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q and the caches must be contiguous and on "
                             f"{q.device}")


def _launch(name, q, cache_k, cache_v, scales, pos: int,
            sm_scale: float) -> torch.Tensor:
    B, nKV, S, d = cache_k.shape
    G = q.shape[1] // nKV
    n = _kernel_fn("decode_attention_scratch")(B, nKV, G, d, pos)
    part = torch.empty((n,), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    err = _kernel_fn(name)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        *(t.data_ptr() for t in scales), part.data_ptr(), o.data_ptr(), B,
        nKV, G, S, d, pos, float(sm_scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    return o


def decode_attention_int8(q, cache_k, cache_v, k_scale, v_scale, pos,
                          sm_scale: float) -> torch.Tensor:
    """K10q: int8 caches with fp32 per-position scales [B, nKV, S].
    Counts its CUDA launches in ``decode_attention_int8.launches``."""
    pos = int(pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos, sm_scale,
                                      k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, cache_k, cache_v, pos, torch.int8)
    want = tuple(cache_k.shape[:3])
    for t in (k_scale, v_scale):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"scales must be contiguous float32 {want} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    o = _launch("decode_attention_int8", q, cache_k, cache_v,
                (k_scale, v_scale), pos, sm_scale)
    decode_attention_int8.launches += 1
    return o


def decode_attention(q, cache_k, cache_v, pos, sm_scale: float,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """K10: o [B, nH, d]. ``pos`` is an int (or a 0-d tensor, read once).
    int8 caches go to ``decode_attention_int8`` and need both scales.
    Counts its own (fp cache) CUDA launches in
    ``decode_attention.launches``."""
    if cache_k.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("decode_attention: int8 caches require "
                             "k_scale and v_scale ([B, nKV, S] fp32)")
        return decode_attention_int8(q, cache_k, cache_v, k_scale, v_scale,
                                     pos, sm_scale)
    pos = int(pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, cache_k, cache_v, pos, q.dtype)
    o = _launch("decode_attention", q, cache_k, cache_v, (), pos, sm_scale)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
decode_attention_int8.launches = 0
