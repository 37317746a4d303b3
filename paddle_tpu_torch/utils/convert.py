"""Carry a reference parameter tree into the port."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "paged_cache_from_jax"]

_NP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "int32": torch.int32}


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        # numpy has no native bfloat16: move the raw bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16).copy()).view(
            torch.bfloat16)
    else:
        # np.array keeps a 0-d leaf (the AdamW step) 0-d, where
        # np.ascontiguousarray would make it [1]
        t = torch.from_numpy(np.array(a, order="C"))
        if name not in _NP_TO_TORCH:
            raise TypeError(f"unsupported leaf dtype {name}")
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device, dtype=None):
    """Turn a parameter tree with numpy leaves (the JAX package's
    parameters after ``np.asarray`` on each leaf) into the port's tree of
    tensors on ``device``. Dicts stay dicts, ``(int8, scale)`` tuples stay
    tuples; ``dtype``, when given, casts floating leaves."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def opt_state_from_jax(state, device):
    """Carry an AdamW state of the reference (numpy leaves) into the port
    with its tree, dtypes and shapes: ``m``, ``v`` (int8 moments as
    ``{"qm", "qs"}`` dicts), the 0-d step ``t`` and, in master mode, the
    fp32 ``master`` tree (absent with ``weights="sr-bf16"``)."""
    return {k: params_from_jax(v, device) for k, v in state.items()}


def paged_cache_from_jax(cache, device):
    """The port's ``PagedKVCache`` holding a reference cache's state: its
    pages (either k layout), block table and ``seq_lens``, read as numpy,
    on ``device``; so that both packages decode from the same state."""
    from ..incubate.nn.functional.fused_transformer import PagedKVCache

    out = PagedKVCache.__new__(PagedKVCache)
    out.block_size = int(cache.block_size)
    out.k_layout = cache.k_layout
    out.max_blocks = int(cache.max_blocks)
    out.k_pages = _leaf(cache.k_pages, device, None)
    out.v_pages = _leaf(cache.v_pages, device, None)
    out.block_table = _leaf(np.asarray(cache.block_table, np.int32), device,
                            None)
    out.seq_lens = _leaf(np.asarray(cache.seq_lens, np.int32), device, None)
    return out
