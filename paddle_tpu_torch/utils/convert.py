"""Carry a reference parameter tree into the port."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "paged_cache_from_jax",
           "layer_state_from_jax", "optimizer_state_from_jax",
           "layer_shards_from_global", "layer_global_state"]

_NP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "int32": torch.int32, "int64": torch.int64,
                "float64": torch.float64, "bool": torch.bool}


def _leaf(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
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


def params_from_jax(tree, device, dtype=None, mesh=None, cfg=None):
    """Turn a parameter tree with numpy leaves (the JAX package's
    parameters after ``np.asarray`` on each leaf) into the port's tree of
    tensors on ``device``. Dicts stay dicts, ``(int8, scale)`` tuples stay
    tuples; ``dtype``, when given, casts floating leaves. With a ``mesh``
    of more than one rank and the GPT's ``cfg``, each leaf becomes this
    rank's DTensor block under the sharded step's specs
    (``parallel/train_step.py::shard_gpt_params``; the fused qkv columns
    in the port's order)."""
    if mesh is not None and mesh.size > 1:
        from ..parallel.train_step import shard_gpt_params

        return shard_gpt_params(params_from_jax(tree, device, dtype), cfg,
                                mesh)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def opt_state_from_jax(state, device, mesh=None, cfg=None,
                       zero1: bool = True):
    """Carry an AdamW state of the reference (numpy leaves) into the port
    with its tree, dtypes and shapes: ``m``, ``v`` (int8 moments as
    ``{"qm", "qs"}`` dicts), the 0-d step ``t`` and, in master mode, the
    fp32 ``master`` tree (absent with ``weights="sr-bf16"``). With a
    ``mesh`` of more than one rank, each leaf becomes this rank's block
    where the reference places it (``shard_opt_state``; ``zero1`` as the
    step was built)."""
    out = {k: params_from_jax(v, device) for k, v in state.items()}
    if mesh is not None and mesh.size > 1:
        from ..parallel.train_step import shard_opt_state

        out = shard_opt_state(out, cfg, mesh, zero1)
    return out


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


def layer_state_from_jax(state_dict, device) -> dict:
    """A reference ``Layer.state_dict()`` (its Tensors, or numpy arrays)
    as a state dict of the port's Tensors on ``device``, ready for the
    port's ``Layer.set_state_dict``: same structured names, same dtypes
    (bf16 bits carried as they are). Every entry goes across as it is:
    conv weights in their layouts (``[out, in / groups, *k]``; ``[in,
    out / groups, *k]`` transposed), the RNNs' ``weight_ih_l{k}`` ...
    ``bias_hh_l{k}_reverse``, BatchNorm's ``_mean`` / ``_variance``
    buffers; the two packages share them all."""
    from ..core.tensor import Tensor

    return {k: Tensor(_leaf(np.asarray(getattr(v, "_data", v)), device,
                            None))
            for k, v in state_dict.items()}


def optimizer_state_from_jax(state_dict, optimizer, device=None,
                             names=None) -> dict:
    """A reference ``Optimizer.state_dict()`` as the port optimizer's.

    The reference keys its per-parameter entries by parameter name, and
    the two packages name parameters from separate counters. With
    ``names``, the reference optimizer's ``_parameter_names`` in its
    parameter order, entry ``names[i]`` goes to the port optimizer's
    i-th parameter; a name that appears twice (the reference's deep
    copies keep the original's name, so their moments share one entry)
    raises. Without ``names`` the entries pair by position, which needs
    exactly one entry a parameter. The step count and the scheduler's
    state carry as they are."""
    named = state_dict.get("state", {})
    params = optimizer._parameter_list
    if names is not None:
        names = list(names)
        dup = sorted({n for n in names if names.count(n) > 1})
        if dup:
            raise ValueError(f"reference parameter names appear more than "
                             f"once, so their states cannot be told apart: "
                             f"{dup}")
        if len(names) != len(params):
            raise ValueError(f"{len(names)} reference parameter names for "
                             f"{len(params)} parameters")
        pairs = [(p, named[n]) for p, n in zip(params, names) if n in named]
    else:
        if len(named) != len(params):
            raise ValueError(f"{len(named)} reference parameter states for "
                             f"{len(params)} parameters: cannot pair them "
                             f"by position (pass the reference's "
                             f"_parameter_names as names=)")
        pairs = list(zip(params, named.values()))
    out = {"step_count": int(state_dict.get("step_count", 0)), "state": {}}
    index = {id(p): i for i, p in enumerate(params)}
    for p, slots in pairs:
        dev = device if device is not None else p._data.device
        out["state"][p.name or f"param_{index[id(p)]}"] = {
            k: _leaf(np.asarray(v), dev, None) for k, v in slots.items()}
    if "LR_Scheduler" in state_dict:
        out["LR_Scheduler"] = dict(state_dict["LR_Scheduler"])
    return out


def _split_params(layer) -> dict:
    """{structured name: (split axis, its group)} of ``layer``'s
    ``is_distributed`` parameters (the fleet's mp Layers record both)."""
    out = {}
    for lname, sub in layer.named_sublayers(include_self=True):
        group = getattr(sub, "_group", None)
        for pname, p in sub._parameters.items():
            if p is not None and getattr(p, "is_distributed", False):
                key = f"{lname}.{pname}" if lname else pname
                out[key] = (p.split_axis, group)
    return out


def layer_shards_from_global(state_dict, layer, device) -> dict:
    """A global state dict (the reference's, numpy arrays or Tensors)
    as this rank's state dict of ``layer`` (the port's mp Layers): each
    ``is_distributed`` parameter's block along its ``split_axis`` for
    this rank of its group, every other entry whole; ready for
    ``layer.set_state_dict``."""
    from ..core.tensor import Tensor

    split = _split_params(layer)
    out = {}
    for k, v in state_dict.items():
        a = np.asarray(getattr(v, "_data", v))
        if k in split:
            axis, group = split[k]
            a = np.split(a, group.nranks, axis=axis)[group.rank]
        out[k] = Tensor(_leaf(np.ascontiguousarray(a), device, None))
    return out


def layer_global_state(layer) -> dict:
    """The inverse of ``layer_shards_from_global``: ``layer``'s state
    dict as numpy arrays, each split parameter's blocks gathered from
    its group along its axis (every rank of the group must call it)."""
    from ..distributed.collective import all_gather

    split = _split_params(layer)
    out = {}
    for k, v in layer.state_dict().items():
        t = v._data.detach()
        if k in split:
            axis, group = split[k]
            whole = all_gather(t.movedim(axis, 0).contiguous(),
                               group=group).wait()
            t = whole.movedim(0, axis)
        out[k] = t.cpu().numpy() if t.dtype != torch.bfloat16 else \
            t.float().cpu().numpy()
    return out
