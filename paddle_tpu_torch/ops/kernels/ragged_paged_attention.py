"""Unified ragged paged attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of paddle_tpu/ops/pallas/ragged_paged_attention.py (kernel
``_rpa_kernel``, plain version ``_ragged_paged_xla``), d-major k pages.

- q [C, qb, nH, d]: C chunks of qb query tokens; chunk c holds tokens at
  positions [pos0[c], pos0[c] + n_valid[c]) of one request, rows
  i >= n_valid[c] are padding.
- k_pages [P, nKV, d, bs] (d-major), v_pages [P, nKV, bs, d]; the chunk's
  own k/v are already written (write-before-attend).
- rows [C, max_blocks], pos0 [C], n_valid [C] int32.

- k_scales / v_scales [P, nKV] fp32: int8 pages (``serving_kv_quant``,
  K8q, the reference kernel's ``quant=True``) need both; each page tile
  is dequantized as ``ops/quant.py::dequantize_int8`` does (fp32 multiply
  by its page's scale, cast to q's dtype) before the dots.

Query row i attends keys kpos <= pos0 + min(i, n_valid - 1), so padding
rows repeat the last valid row. Returns o [C, qb, nH, d] in q's dtype.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch ``csrc/ragged_paged_attention.cu`` (``rpa_forward`` for fp pages,
``rpa_forward_int8`` for int8 pages) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import dequantize_int8
from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_int8",
           "ragged_paged_attention_plain", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0, n_valid,
                                 sm_scale: float, k_scales=None,
                                 v_scales=None) -> torch.Tensor:
    """Gather each chunk's pages (dequantizing int8 pages with their
    gathered scales) and run one masked softmax over the flattened
    context; scores in fp32, max-subtracted exp, output
    acc / max(l, 1e-30), as the reference's gather arm."""
    C, qb, nH, d = q.shape
    nkv = k_pages.shape[1]
    G = nH // nkv
    mb = rows.shape[1]
    bs = k_pages.shape[3]
    idx = rows.long()
    kg, vg = k_pages[idx], v_pages[idx]
    if k_scales is not None:
        kg = dequantize_int8(kg, k_scales[idx][..., None, None], q.dtype)
        vg = dequantize_int8(vg, v_scales[idx][..., None, None], q.dtype)
    kg = kg.transpose(3, 4)                         # [C, mb, nkv, bs, d]
    kg = kg.transpose(1, 2).reshape(C, nkv, mb * bs, d)
    vg = vg.transpose(1, 2).reshape(C, nkv, mb * bs, d)
    qg = q.reshape(C, qb, nkv, G, d)
    s = torch.einsum("cqhgd,chsd->chgqs", qg.float(), kg.float()) * sm_scale
    off = torch.arange(qb, dtype=torch.int32, device=q.device)
    qpos = pos0[:, None] + torch.minimum(off[None, :], n_valid[:, None] - 1)
    kpos = torch.arange(mb * bs, dtype=torch.int32, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [C, qb, S]
    s = s + torch.where(mask, 0.0, -1e30)[:, None, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("chgqs,chsd->cqhgd", (p / l).to(vg.dtype), vg)
    return o.reshape(C, qb, nH, d).to(q.dtype)


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("ragged_paged_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        n_ptr = 7 if name == "rpa_forward" else 9
        fn.argtypes = [P] * n_ptr + [I] * 7 + [ctypes.c_float, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid,
                page_dtype) -> None:
    C, qb, nH, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"pages {k_pages.dtype} / {v_pages.dtype}: this "
                        f"kernel takes {page_dtype} pages")
    P, nkv, kd, bs = k_pages.shape
    if v_pages.shape != (P, nkv, bs, d) or kd != d:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {q.shape}")
    if nH % nkv:
        raise ValueError(f"{nH} query heads not a multiple of {nkv} kv heads")
    if d not in SUPPORTED_HEAD_DIMS or bs % 16:
        raise ValueError(f"head dim {d} / page size {bs}: the kernel takes "
                         f"d in {SUPPORTED_HEAD_DIMS} and bs % 16 == 0")
    for name, t, shape in (("rows", rows, (C, rows.shape[-1])),
                           ("pos0", pos0, (C,)), ("n_valid", n_valid, (C,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (q, k_pages, v_pages, rows, pos0, n_valid):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{q.device}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the kernel reads pages as 16-byte vectors: page "
                         "arrays must be 16-byte aligned")


def _launch(name, q, k_pages, v_pages, scales, rows, pos0, n_valid,
            sm_scale) -> torch.Tensor:
    C, qb, nH, d = q.shape
    out = torch.empty_like(q)
    err = _kernel_fn(name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() for t in scales), rows.data_ptr(), pos0.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), C, qb, nH, k_pages.shape[1], d,
        k_pages.shape[3], rows.shape[1], float(sm_scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    return out


def ragged_paged_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                rows, pos0, n_valid,
                                sm_scale: float) -> torch.Tensor:
    """K8q: the unified attention over int8 pages with their [P, nKV]
    fp32 scale planes. Counts its CUDA launches in
    ``ragged_paged_attention_int8.launches``."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0,
                                            n_valid, sm_scale, k_scales,
                                            v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid, torch.int8)
    want = (k_pages.shape[0], k_pages.shape[1])
    for t in (k_scales, v_scales):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"scale planes must be contiguous float32 "
                             f"{want} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    out = _launch("rpa_forward_int8", q, k_pages, v_pages,
                  (k_scales, v_scales), rows, pos0, n_valid, sm_scale)
    ragged_paged_attention_int8.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, rows, pos0, n_valid,
                           sm_scale: float, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """The unified attention of one engine step (see module docstring):
    int8 pages go to ``ragged_paged_attention_int8``, which needs both
    scale planes. Counts its own (fp page) CUDA launches in
    ``ragged_paged_attention.launches``."""
    if k_pages.dtype == torch.int8:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 KV pages need k_scales and v_scales "
                             "([P, nKV] fp32 per-page scale planes)")
        return ragged_paged_attention_int8(q, k_pages, v_pages, k_scales,
                                           v_scales, rows, pos0, n_valid,
                                           sm_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, rows, pos0,
                                            n_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, rows, pos0, n_valid, q.dtype)
    out = _launch("rpa_forward", q, k_pages, v_pages, (), rows, pos0,
                  n_valid, sm_scale)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention_int8.launches = 0
