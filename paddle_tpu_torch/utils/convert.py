"""Carry a reference parameter tree into the port."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "paged_cache_from_jax",
           "layer_state_from_jax", "optimizer_state_from_jax",
           "layer_shards_from_global", "layer_global_state",
           "pipeline_shards_from_global", "pipeline_global_state",
           "moe_shards_from_global", "moe_global_state",
           "incubate_optimizer_state_from_jax", "asp_masks_from_jax"]

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


def _checked_names(names, params) -> list:
    """``names`` as a list, one a parameter and none twice (the
    reference's deep copies keep the original's name, so their states
    could not be told apart)."""
    names = list(names)
    dup = sorted({n for n in names if names.count(n) > 1})
    if dup:
        raise ValueError(f"reference parameter names appear more than "
                         f"once, so their states cannot be told apart: "
                         f"{dup}")
    if len(names) != len(params):
        raise ValueError(f"{len(names)} reference parameter names for "
                         f"{len(params)} parameters")
    return names


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
        names = _checked_names(names, params)
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


def _canonical(key: str, aliases: dict) -> str:
    for local, first in aliases.items():
        if key == local or key.startswith(local + "."):
            return first + key[len(local):]
    return key


def pipeline_shards_from_global(state_dict, layer, device) -> dict:
    """The reference's global ``PipelineLayer`` state as this rank's
    state dict of ``layer`` (its stage's entries, each mp-split
    parameter's block for this rank's mp coordinate; a shared layer's
    entries on a later owner stage read from its first owner's name);
    ready for ``layer.set_state_dict``."""
    aliases = layer.shared_aliases()
    mine = {k: state_dict[_canonical(k, aliases)]
            for k in layer.state_dict()}
    return layer_shards_from_global(mine, layer, device)


def pipeline_global_state(layer) -> dict:
    """The inverse of ``pipeline_shards_from_global``: the global state
    (numpy), every stage's entries with the mp blocks gathered, on every
    rank (every rank of the pp and mp groups must call it)."""
    from ..distributed.collective import all_gather_object

    aliases = layer.shared_aliases()
    mine = {k: v for k, v in layer_global_state(layer).items()
            if _canonical(k, aliases) == k}
    if layer.get_num_stages() == 1:
        return mine
    parts = []
    all_gather_object(parts, mine,
                      group=layer._hcg.get_pipe_parallel_group())
    out = {}
    for part in parts:
        out.update(part)
    return out


def _expert_key(key: str, offset: int):
    head, _, rest = key.partition(".")
    if head != "experts":
        return key
    i, _, tail = rest.partition(".")
    return f"experts.{int(i) + offset}.{tail}"


def moe_shards_from_global(state_dict, layer, device) -> dict:
    """The reference's ``MoELayer`` state (every expert) as this rank's
    state dict of ``layer``: its experts (E / W a rank, rank r holding
    r E / W onwards) and the replicated gate."""
    from ..core.tensor import Tensor

    off = (layer.group.rank if layer.group is not None else 0) * \
        layer.num_expert
    out = {}
    for k in layer.state_dict():
        v = state_dict[_expert_key(k, off)]
        v = getattr(v, "_data", v)
        out[k] = Tensor(_leaf(v if isinstance(v, torch.Tensor)
                              else np.asarray(v), device, None))
    return out


def moe_global_state(layer) -> dict:
    """The inverse of ``moe_shards_from_global``: every rank's experts
    under the reference's names and the gate (numpy), on every rank of
    the moe group (each must call it)."""
    from ..distributed.collective import all_gather_object

    def arrays(off):
        return {_expert_key(k, off): (v._data.detach().float()
                                      if v._data.dtype == torch.bfloat16
                                      else v._data.detach()).cpu().numpy()
                for k, v in layer.state_dict().items()}

    if layer.group is None:
        return arrays(0)
    parts = []
    all_gather_object(parts, arrays(layer.group.rank * layer.num_expert),
                      group=layer.group)
    out = {}
    for part in parts:
        out.update(part)
    return out


def _pair_by_name(ref_params, params, names):
    """[(port parameter, reference parameter)]: by ``names`` (the
    reference's parameter names in the port's parameter order) or, without
    them, by position; refuses what ``optimizer_state_from_jax`` refuses."""
    if names is None:
        if len(ref_params) != len(params):
            raise ValueError(f"{len(ref_params)} reference parameters for "
                             f"{len(params)}: cannot pair them by position "
                             f"(pass the reference's _parameter_names as "
                             f"names=)")
        return list(zip(params, ref_params))
    ref_names = _checked_names([p.name for p in ref_params], ref_params)
    by_name = dict(zip(ref_names, ref_params))
    return [(p, by_name[n]) for p, n in zip(params, _checked_names(names,
                                                                   params))]


def incubate_optimizer_state_from_jax(ref_opt, port_opt, names=None,
                                      device=None) -> None:
    """Carry the state an incubate optimizer keeps per parameter from the
    reference's into the port's, in place: a ``LookAhead``'s slow weights
    and window count, or a ``ModelAverage``'s sums and count (and any
    backup an ``apply()`` left). Parameters pair by name with ``names``
    (the reference's ``_parameter_names`` in the port's parameter order),
    else by position; colliding names are refused. The inner optimizer's
    moments carry through ``optimizer_state_from_jax``."""
    pairs = _pair_by_name(ref_opt._parameter_list, port_opt._parameter_list,
                          names)

    def carry(table):
        out = {}
        for p, r in pairs:
            if id(r) in table:
                dev = device if device is not None else p._data.device
                out[id(p)] = _leaf(np.asarray(getattr(table[id(r)], "_data",
                                                      table[id(r)])),
                                   dev, None)
        return out

    if hasattr(ref_opt, "_slow"):
        port_opt._slow = carry(ref_opt._slow)
        port_opt._k_count = int(ref_opt._k_count)
    elif hasattr(ref_opt, "_sum"):
        port_opt._sum = carry(ref_opt._sum)
        port_opt._backup = carry(ref_opt._backup)
        port_opt._cnt = int(ref_opt._cnt)
    else:
        raise TypeError(f"no per-parameter incubate state on "
                        f"{type(ref_opt).__name__}")


def asp_masks_from_jax(masks, layer, device=None) -> dict:
    """Register the reference's ASP masks on the port's ``layer``: ``masks``
    is what the reference's ``prune_model`` returned ({sublayer name:
    mask}, the model itself under its class name), the port's layer has
    the same structure, and each mask goes to the same-named sublayer's
    ``weight`` on its device, where a decorated optimizer re-applies it.
    An unknown name is refused. Returns the port's {name: mask}."""
    from ..core.tensor import Tensor
    from ..incubate.asp import _register_mask

    subs = dict(layer.named_sublayers(include_self=True))
    out = {}
    for name, m in masks.items():
        sub = subs.get(name)
        if sub is None and name == type(layer).__name__:
            sub = layer
        w = getattr(sub, "weight", None)
        if w is None:
            raise KeyError(f"no sublayer {name!r} with a weight in "
                           f"{type(layer).__name__}")
        dev = device if device is not None else w._data.device
        t = Tensor(_leaf(np.asarray(getattr(m, "_data", m)), dev,
                         None).to(w._data.dtype), stop_gradient=True)
        _register_mask(w, t)
        out[name] = t
    return out
