"""The GPT training step: forward, backward and AdamW (port of
paddle_tpu/parallel/train_step.py). ``make_train_step`` is the one-device
step; ``make_sharded_train_step`` takes the reference's mesh and
arguments, and on a mesh whose every axis is 1 it is that step.

The reference wraps its whole step in ``compiler.auto_fuse``; here the
forward is fused inside ``models/gpt.py::model_apply`` (``fused_call``)
and nothing more. That covers what the step-level pass can find: the
backward is autograd's (the fused entries carry their own composed
backwards, as the reference's custom_vjps do) and AdamW is a loop of
in-place updates with no catalog chain in it. tests/test_torch_compiler.py
holds the port's per-template site counts (2L + 1 ``layer_epilogue``,
L ``bias_gelu``) equal to the JAX compiler's on the same unrolled model,
where the JAX compiler runs.

AdamW keeps the reference's arithmetic: fp32 update math, bias
corrections in fp32, weight decay on every leaf, moments stored as fp32,
bf16 or blockwise int8 (sqrt companding, blocks of 2048), and in master
mode (``param_dtype`` != ``dtype``) the >= 2-D leaves live in the compute
dtype with fp32 masters in the state. ``weights="sr-bf16"`` keeps no
master: the >= 2-D leaves live in bf16 and each update is written back by
stochastic rounding (16 uniform bits added below bf16's mantissa cut of
the fp32 bits, then truncation), whose noise comes from a
``torch.Generator`` on the parameters' device, seeded from the step's
``seed``; the reference's rbg keys give bits its backend defines, so the
port is held to the reference's statistical checks, not its bits. Where
the reference donates its buffers to the jitted step, the port updates
parameters, masters and moments in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.flags import GLOBAL_FLAGS
from ..distributed.autograd_collectives import (QUANT_SYNC_PP_REFUSAL,
                                                _reduce, _scatter,
                                                dist_allreduce_quant)
from ..distributed.placement import P, sanitize_spec, spec_entries, spec_of
from ..distributed.sharding import (REF_COLUMNS, as_dtensor, axis_of_dim,
                                    gather_full, local_shard, reshard,
                                    shard_array_over, shard_spec_over,
                                    to_local)
from ..models.gpt import (GPTConfig, Shards, init_params, loss_fn,
                          sharded_block, sharded_embed, sharded_loss_fn,
                          sharded_tail)
from .pipeline import PipelineBlocks

__all__ = ["adamw_init", "adamw_update", "make_train_step",
           "gpt_param_specs", "shard_gpt_params", "opt_state_specs",
           "shard_opt_state", "zero_shard_opt_state",
           "make_sharded_train_step"]

_QBLOCK = 2048
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _is_quant(x) -> bool:
    return isinstance(x, dict) and "qm" in x


def _tree_map(fn, tree, *rest):
    """Map over nested dicts; an int8 moment {"qm", "qs"} is one leaf."""
    if isinstance(tree, dict) and not _is_quant(tree):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _master_leaf(a):
    """fp32 master of a >= 2-D leaf; 1-D leaves stay fp32 in the params
    themselves, so their master is a size-0 placeholder."""
    if a.dim() >= 2:
        return a.detach().to(torch.float32, copy=True)
    return torch.zeros((0,), dtype=torch.float32, device=a.device)


def _sqrt(x32):
    """Correctly rounded fp32 sqrt. CUDA's is; PyTorch's vectorized CPU
    sqrt is not (it differs from IEEE in the last bit for ~0.6% of
    inputs), so on the CPU it goes through fp64, whose rounding to fp32
    is exact."""
    if x32.is_cuda:
        return torch.sqrt(x32)
    return torch.sqrt(x32.double()).float()


def _quantize_moment(x32):
    """Blockwise absmax int8 with sqrt companding: {'qm': int8 [nb, 2048],
    'qs': fp32 [nb]}. torch.round rounds half to even, as jnp.round."""
    flat = x32.reshape(-1)
    pad = (-flat.numel()) % _QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1)
    nrm = blocks / torch.clamp_min(scale, 1e-20)[:, None]
    nrm = torch.sign(nrm) * _sqrt(nrm.abs())
    q = torch.clamp(torch.round(nrm * 127.0), -127, 127).to(torch.int8)
    return {"qm": q, "qs": scale}


def _dequantize_moment(mq, like):
    """fp32 tensor shaped like ``like`` from any moment representation."""
    if not _is_quant(mq):
        return mq.float()
    nrm = mq["qm"].float() / 127.0
    nrm = torch.sign(nrm) * torch.square(nrm)
    flat = (nrm * mq["qs"][:, None]).reshape(-1)
    return flat[:like.numel()].reshape(like.shape)


def _stochastic_round(x32, dtype, generator: torch.Generator):
    """fp32 -> ``dtype``; to bf16 by stochastic rounding: 16 uniform
    random bits added to the fp32 bits below bf16's mantissa cut, then
    truncated, so that the rounding is unbiased. The add runs on an int32
    view, which wraps modulo 2^32 as the reference's uint32 add does.
    Other dtypes are a plain cast (fp32 1-D leaves pass through)."""
    if dtype != torch.bfloat16:
        return x32.to(dtype)
    r = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                      device=x32.device, dtype=torch.int32)
    return _round_with(x32, r, dtype)


def _round_with(x32, r, dtype):
    """Stochastic rounding of ``x32`` with the int32 noise ``r`` (which
    it overwrites)."""
    r += x32.contiguous().view(torch.int32)
    r &= -(1 << 16)                             # 0xFFFF0000
    return r.view(torch.float32).to(dtype)


def _store_moment(x32, dtype):
    if dtype == "int8":
        return _quantize_moment(x32)
    return x32.to(_DTYPES[dtype])


def _moment_like(a, dtype):
    if a.dim() < 2 or dtype in (None, "float32"):
        return torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    if dtype == "int8":
        return _quantize_moment(torch.zeros(a.shape, dtype=torch.float32,
                                            device=a.device))
    return torch.zeros(a.shape, dtype=_DTYPES[dtype], device=a.device)


def _moment_dtype_for(a, dtype):
    return "float32" if (a.dim() < 2 or dtype is None) else dtype


def adamw_init(params: dict, master_weights: bool = False,
               m_dtype: str | None = None, v_dtype: str | None = None) -> dict:
    """Zero moments in the chosen storage, step 0 and, with
    ``master_weights``, fp32 masters of the >= 2-D leaves."""
    dev = _leaves(params)[0].device
    state = {"m": _tree_map(lambda a: _moment_like(a, m_dtype), params),
             "v": _tree_map(lambda a: _moment_like(a, v_dtype), params),
             "t": torch.zeros((), dtype=torch.int32, device=dev)}
    if master_weights:
        state["master"] = _tree_map(_master_leaf, params)
    return state


def _write(dst, src) -> None:
    if _is_quant(dst):
        dst["qm"].copy_(src["qm"])
        dst["qs"].copy_(src["qs"])
    else:
        dst.copy_(src)


def _adam_math(g32, m_old, v_old, p32, bc1, bc2, lr, wd, b1, b2, eps):
    """The AdamW arithmetic of one leaf in fp32: (p32, m32, v32)."""
    m32 = b1 * m_old + (1 - b1) * g32
    v32 = b2 * v_old + (1 - b2) * torch.square(g32)
    step = (m32 / bc1) / (_sqrt(v32 / bc2) + eps)
    return p32 - lr * (step + wd * p32), m32, v32


@torch.no_grad()
def adamw_update(params, grads, state, lr, wd=0.1, b1=0.9, b2=0.95,
                 eps=1e-8, m_dtype=None, v_dtype=None,
                 stochastic_round=False, sr_generator=None):
    """One AdamW step, written in place into ``params`` and ``state``
    (returned as well). ``grads`` is a tree like ``params``. With
    ``stochastic_round`` a leaf without a master is written back by
    stochastic rounding, its noise drawn from ``sr_generator`` (one draw
    per bf16 leaf per step), which must then be given."""
    if stochastic_round and sr_generator is None:
        raise ValueError("stochastic_round draws its noise from "
                         "sr_generator: pass a torch.Generator")
    t = state["t"] + 1
    bc1 = 1.0 - b1 ** t.float()
    bc2 = 1.0 - b2 ** t.float()
    masters = state.get("master")
    flat_mw = (_leaves(masters) if masters is not None
               else [None] * len(_leaves(params)))
    for p, g, m, v, mw in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"]),
                              flat_mw):
        has_master = mw is not None and mw.numel() > 0
        p32, m32, v32 = _adam_math(
            g.float(), _dequantize_moment(m, p), _dequantize_moment(v, p),
            mw if has_master else p.float(), bc1, bc2, lr, wd, b1, b2, eps)
        if has_master:
            mw.copy_(p32)
            p.copy_(p32.to(p.dtype))
        elif stochastic_round:
            p.copy_(_stochastic_round(p32, p.dtype, sr_generator))
        else:
            p.copy_(p32.to(p.dtype))
        _write(m, _store_moment(m32, _moment_dtype_for(p, m_dtype)))
        _write(v, _store_moment(v32, _moment_dtype_for(p, v_dtype)))
    state["t"].copy_(t)
    return params, state


def _check_options(weights, m_dtype, v_dtype) -> None:
    if weights not in ("auto", "sr-bf16"):
        raise ValueError(f"weights mode {weights!r}: expected 'auto' or "
                         "'sr-bf16'")
    for name, dt in (("m_dtype", m_dtype), ("v_dtype", v_dtype)):
        if dt not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(f"{name}={dt!r}: expected None/'float32'/"
                             "'bfloat16'/'int8'")
    if v_dtype == "int8":
        raise ValueError("v_dtype='int8' is unsafe (zeroed second moments "
                         "explode the update); use 'bfloat16'")


def make_train_step(cfg: GPTConfig, lr: float = 1e-4, seed: int = 0,
                    m_dtype: str | None = None, v_dtype: str | None = None,
                    weights: str = "auto", device=None, mesh=None,
                    n_microbatches: int = 1):
    """Build ``(step_fn, params, opt_state)`` for one device.
    ``step_fn(params, opt_state, tokens, labels) -> (loss, params,
    opt_state)``; ``step_fn.put_batch`` puts a host batch on the device.
    Weights are drawn on the device from ``torch.Generator`` seeded with
    ``seed``. When ``cfg.param_dtype`` differs from ``cfg.dtype``, the
    >= 2-D leaves live in ``cfg.dtype`` and ``weights='auto'`` keeps fp32
    masters of them in the state, ``weights='sr-bf16'`` none (stochastic
    rounding, its noise from a generator seeded with ``seed``). One
    device has no gradient to sync: ``dist_allreduce_quant`` changes
    nothing here. ``n_microbatches`` is ignored: one device has no pp
    axis, and without pp the reference's pipeline is the stage itself
    (``pipeline.py:76-77``)."""
    _check_options(weights, m_dtype, v_dtype)
    if mesh is not None:
        raise NotImplementedError("a mesh is make_sharded_train_step's "
                                  "argument")
    dev = resolve_device(device)
    low_precision = cfg.param_dtype != cfg.dtype
    sr = weights == "sr-bf16" and low_precision
    master = low_precision and not sr
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt_state = adamw_init(params, master_weights=master, m_dtype=m_dtype,
                           v_dtype=v_dtype)
    if low_precision:
        params = _tree_map(
            lambda a: a.to(cfg.dtype) if a.dim() >= 2 else a, params)
    sr_gen = torch.Generator(device=dev).manual_seed(seed) if sr else None

    def put_batch(arr):
        return torch.as_tensor(arr).to(dev)

    def step_fn(params, opt_state, tokens, labels):
        tokens = put_batch(tokens)
        labels = put_batch(labels)
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        grads = _tree_map(lambda _: next(it), params)
        adamw_update(params, grads, opt_state, lr, m_dtype=m_dtype,
                     v_dtype=v_dtype, stochastic_round=sr,
                     sr_generator=sr_gen)
        return loss.detach(), params, opt_state

    step_fn.put_batch = put_batch
    return step_fn, params, opt_state


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def gpt_param_specs(cfg: GPTConfig) -> dict:
    """Megatron-layout specs of the stacked GPT parameters."""
    specs = {
        "wte": P("mp", None),
        "wpe": P(),
        "blocks": {
            "ln1_g": P("pp", None), "ln1_b": P("pp", None),
            "qkv_w": P("pp", None, "mp"), "qkv_b": P("pp", "mp"),
            "proj_w": P("pp", "mp", None), "proj_b": P("pp", None),
            "ln2_g": P("pp", None), "ln2_b": P("pp", None),
            "fc_w": P("pp", None, "mp"), "fc_b": P("pp", "mp"),
            "fc2_w": P("pp", "mp", None), "fc2_b": P("pp", None),
        },
        "lnf_g": P(), "lnf_b": P(),
    }
    if not cfg.tie_embeddings:
        specs["head_w"] = P(None, "mp")
    if cfg.n_experts > 0 and cfg.n_moe_layers > 0:
        specs["moe"] = {
            "ln_g": P(), "ln_b": P(),
            "router_w": P(),
            # the expert dim over dp: the reference's "ep" group
            "w1": P(None, "dp", None, "mp"), "b1": P(None, "dp", None),
            "w2": P(None, "dp", "mp", None), "b2": P(None, "dp", None),
        }
    return specs


def _paths(tree, prefix=()) -> list:
    """(path, leaf) pairs in the tree's order; an int8 moment is a
    leaf."""
    if isinstance(tree, dict) and not _is_quant(tree):
        return [pl for k, v in tree.items()
                for pl in _paths(v, prefix + (k,))]
    return [(prefix, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _ref_columns(path, cfg: GPTConfig, mesh):
    """The reference's column of each column the port holds, for the
    fused qkv leaves over mp (each rank's heads' q, k, v side by side, as
    the fused-qkv flash entry reads them); None elsewhere."""
    mp = mesh.shape.get("mp", 1)
    if mp == 1 or path[-1] not in ("qkv_w", "qkv_b"):
        return None
    H = cfg.hidden
    hl = H // mp
    return torch.cat([torch.arange(r * hl, (r + 1) * hl) + j * H
                      for r in range(mp) for j in range(3)])


def _place(full, spec, mesh, cols):
    """A whole leaf (reference order) as this rank's DTensor block."""
    if cols is not None:
        full = full[..., cols.to(full.device)]
    with torch.no_grad():
        out = as_dtensor(local_shard(full, spec, mesh).clone(), spec, mesh,
                         tuple(full.shape))
    if cols is not None:
        setattr(out, REF_COLUMNS, cols)
    return out


def _check_mesh(cfg: GPTConfig, mesh) -> None:
    mp = mesh.shape.get("mp", 1)
    if mp > 1:
        for name, n in (("n_heads", cfg.n_heads),
                        ("ffn_mult * hidden", cfg.ffn_mult * cfg.hidden),
                        ("seq_len", cfg.seq_len)):
            if n % mp:
                raise ValueError(f"tensor parallelism over mp={mp} needs "
                                 f"{name} ({n}) divisible by it")
    pp = mesh.shape.get("pp", 1)
    if cfg.n_layers % pp:
        raise ValueError(f"the pipeline over pp={pp} needs n_layers "
                         f"({cfg.n_layers}) divisible by it")
    ring = cfg.ring_axis
    if ring and mesh.shape.get(ring, 1) > 1 and ring != "mp":
        raise NotImplementedError(
            f"ring_axis={ring!r}: the port runs ring attention over the mp "
            f"axis only (its {mesh.shape[ring]} ranks of {ring!r} hold other "
            "work); set ring_axis='mp' or leave it unset")


def _ring_mesh(cfg: GPTConfig, mesh):
    """The mesh ring attention runs over, where ``ring_axis`` names an
    axis of more than one rank (mp, by ``_check_mesh``); else None."""
    if cfg.ring_axis and mesh.shape.get(cfg.ring_axis, 1) > 1:
        return mesh
    return None


def shard_gpt_params(params: dict, cfg: GPTConfig, mesh) -> dict:
    """Whole parameters (reference order, the same on every rank) as
    DTensor blocks with the Megatron specs (``gpt_param_specs``,
    sanitized: degenerate axes and dims they do not divide stay
    replicated). Unchanged on a one-rank mesh."""
    if mesh.size == 1:
        return params
    _check_mesh(cfg, mesh)
    specs = gpt_param_specs(cfg)
    paths = [path for path, _ in _paths(params)]
    return _unflatten(paths, [
        _place(a, sanitize_spec(_at(specs, path), a.shape, mesh), mesh,
               _ref_columns(path, cfg, mesh))
        for path, a in _paths(params)])


def _follows_param(key: str, leaf) -> bool:
    """Whether a whole state leaf was made from its parameter (and so
    keeps its sharding, as ``zeros_like`` and ``astype`` do in the
    reference): fp32 moments, masters of >= 2-D leaves. bf16 moments,
    int8 blocks and size-0 master sentinels are fresh arrays."""
    if _is_quant(leaf):
        return False
    if key == "master":
        return leaf.numel() > 0
    return leaf.dtype == torch.float32


def opt_state_specs(state: dict, cfg: GPTConfig, mesh,
                    zero1: bool = True) -> dict:
    """Where the reference's ``adamw_init`` + ``zero_shard_opt_state``
    put each leaf of an AdamW state (a tree of specs like ``state``): a
    leaf made from its parameter keeps the parameter's spec, a fresh one
    is replicated, and with ``zero1`` every leaf also spreads its largest
    free divisible dim over dp."""
    specs = gpt_param_specs(cfg)

    def place(a, follows, path):
        spec = (sanitize_spec(_at(specs, path), a.shape, mesh) if follows
                else P())
        if zero1 and a.dim() > 0:
            spec = shard_spec_over(tuple(a.shape), spec, mesh, "dp") or spec
        return spec

    out = {"t": P()}
    for key in ("m", "v", "master"):
        if key in state:
            pairs = _paths(state[key])
            out[key] = _unflatten([p for p, _ in pairs], [
                ({k: place(v, False, path) for k, v in leaf.items()}
                 if _is_quant(leaf)
                 else place(leaf, _follows_param(key, leaf), path))
                for path, leaf in pairs])
    return out


def shard_opt_state(state: dict, cfg: GPTConfig, mesh,
                    zero1: bool = True) -> dict:
    """Whole AdamW state (reference order, the same on every rank) as
    DTensor blocks placed by ``opt_state_specs``. Unchanged on a one-rank
    mesh."""
    if mesh.size == 1:
        return state
    specs = opt_state_specs(state, cfg, mesh, zero1)
    out = {"t": state["t"]}
    for key in ("m", "v", "master"):
        if key not in state:
            continue
        pairs = _paths(state[key])
        placed = []
        for path, leaf in pairs:
            spec = _at(specs[key], path)
            if _is_quant(leaf):
                placed.append({k: _place(v, spec[k], mesh, None)
                               for k, v in leaf.items()})
            else:
                placed.append(_place(leaf, spec, mesh,
                                     _ref_columns(path, cfg, mesh)
                                     if leaf.numel() else None))
        out[key] = _unflatten([p for p, _ in pairs], placed)
    return out


def zero_shard_opt_state(state: dict, mesh, axis: str = "dp") -> dict:
    """ZeRO-1: spread AdamW moments (and fp32 masters, when present) over
    the dp axis (reference DygraphShardingOptimizer)."""
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return state

    def put(a):
        if _is_quant(a):
            return {k: put(v) for k, v in a.items()}
        return shard_array_over(a, mesh, axis) if a.dim() > 0 else a

    out = {"m": _tree_map(put, state["m"]), "v": _tree_map(put, state["v"]),
           "t": state["t"]}
    if "master" in state:
        out["master"] = _tree_map(put, state["master"])
    return out


def _reduce_to(g, src, dst, axes, mesh):
    """Sum a gradient block over ``axes`` and bring it from layout
    ``src`` to ``dst``: a reduce-scatter where ``dst`` splits a dim over
    the axis that ``src`` leaves whole, an all-reduce otherwise."""
    cur = axis_of_dim(src, g.dim())
    want = axis_of_dim(dst, g.dim())
    for a in axes:
        d = next((d for d in range(g.dim())
                  if want[d] == a and cur[d] is None), None)
        if d is not None:
            g = _scatter(g, d, mesh.group(a))
            cur[d] = a
        else:
            g = _reduce(g, mesh.group(a))
    return reshard(g, P(*cur), dst, mesh)


def _axes(spec, ndim: int) -> set:
    return {n for names in spec_entries(spec, ndim) for n in names}


class _ShardedStep:
    """The step on a mesh of more than one rank: each rank runs its dp
    rows through ``sharded_loss_fn`` (which places the training kernels
    on the rank's rows and heads), sums each gradient over the ranks
    that replicate its parameter, and updates the blocks of the
    optimizer's layout. On a one-rank mesh every collective is the
    identity (``make_sharded_train_step`` returns ``make_train_step``
    there; this class runs there only when built directly).

    Over pp (``_pipeline_grads``) the three parts of ``sharded_loss_fn``
    run where they belong: the embedding on stage 0, the blocks as a
    pipeline (``parallel/pipeline.py``), the MoE layers, the final
    LayerNorm and the head on the last stage. A parameter the stages
    replicate (``wte``, ``wpe``, ``lnf_*``, ``moe``, ``head_w``) gets its
    gradient summed over pp like any other replicated one: ``wte``'s is
    the embedding's (stage 0) plus the head's (last stage), every other
    one's a single stage's, so that every pp rank takes the same update
    of it, bit for bit."""

    def __init__(self, cfg, mesh, lr, sr, dev, seed, n_microbatches=1):
        self.cfg, self.mesh, self.lr, self.sr, self.dev = (cfg, mesh, lr,
                                                           sr, dev)
        self.sr_gen = (torch.Generator(device=dev).manual_seed(seed)
                       if sr else None)
        self.dp, self.mp = mesh.shape.get("dp", 1), mesh.shape.get("mp", 1)
        self.pp = mesh.shape.get("pp", 1)
        self.quant = bool(GLOBAL_FLAGS.get("dist_allreduce_quant")) and \
            self.dp > 1
        self.moe = cfg.n_experts > 0 and cfg.n_moe_layers > 0
        self.specs = gpt_param_specs(cfg)
        coords = mesh.coords()
        self.dp_rank = coords.get("dp", 0)
        ring = _ring_mesh(cfg, mesh)
        if self.quant:
            self.shards = Shards(mp=mesh.group("mp"), mp_size=self.mp,
                                 mp_rank=coords.get("mp", 0), ring=ring)
        else:
            self.shards = Shards(
                dp=mesh.group("dp"), dp_size=self.dp, dp_rank=self.dp_rank,
                mp=mesh.group("mp"), mp_size=self.mp,
                mp_rank=coords.get("mp", 0),
                ep=self.moe and self.dp > 1 and cfg.n_experts % self.dp == 0,
                ring=ring)
        self.pipe = None
        if self.pp > 1:
            self.pipe = PipelineBlocks(self._stage, mesh, n_microbatches)

    def _stage(self, bp: dict, x):
        """One pipeline stage: this rank's layers of the blocks, each
        ``sharded_block`` (no checkpoint: the pipeline's replay is the
        recompute, as the reference's stage runs block_apply in a plain
        scan)."""
        for i in range(bp["ln1_g"].shape[0]):
            x = sharded_block({k: v[i] for k, v in bp.items()}, x,
                              self.cfg, self.shards)
        return x

    def compute_spec(self, path, shape):
        """The layout a parameter is computed in: its Megatron spec, and
        under the int8-wire sync replicated over dp (the reference's
        per-rank region takes every parameter whole over dp)."""
        spec = sanitize_spec(_at(self.specs, path), shape, self.mesh)
        if self.quant:
            spec = P(*(None if e == ("dp",) else e for e in spec))
        return spec

    def _reported(self, nll, aux, n: int):
        """The reported loss from every rank's (nll_sum, aux), the same
        on every rank: the last stage's parts, in rank order; ``n`` is a
        dp rank's tokens."""
        import torch.distributed as dist

        every = torch.stack([nll, aux])
        if self.mesh.size > 1:
            part, every = every, torch.empty((self.mesh.size * 2,),
                                             dtype=every.dtype,
                                             device=every.device)
            dist.all_gather_into_tensor(every, part)
        last = self.mesh.devices.reshape(self.dp, self.pp, self.mp)[:, -1]
        every = every.reshape(-1, 2)[torch.as_tensor(last,
                                                     device=nll.device)]
        if self.quant:
            # the mean of the dp ranks' losses, as the reference's pmean
            per_dp = every[:, :, 0].sum(1) / n + 0.01 * every[:, 0, 1]
            return per_dp.sum() / self.dp
        return every[:, :, 0].sum() / (n * self.dp) + 0.01 * every[0, 0, 1]

    def loss(self, tree, tok, lab):
        """(objective, reported loss): the objectives summed over the
        ranks of a gradient reduction are the loss; the reported loss,
        made from every rank's parts in rank order, is the same on every
        rank."""
        obj, nll, aux = sharded_loss_fn(tree, tok, lab, self.cfg,
                                        self.shards)
        return obj, self._reported(nll, aux, tok.numel())

    def _pipeline_grads(self, blocks, paths, tok, lab):
        """(gradient of each of ``blocks``, reported loss) over pp: the
        embedding's graph on stage 0, the pipeline's schedule, the tail
        on the last stage, per microbatch where the loss sums over
        tokens and once over the whole batch with MoE (its capacity and
        aux loss see every token), where the schedule is then gpipe's."""
        cfg, pipe = self.cfg, self.pipe
        S, M, s = self.pp, pipe.n_micro, pipe.stage
        b, T = tok.shape
        if b % M:
            raise ValueError(f"a dp rank's {b} rows over {M} microbatches")
        mb = b // M
        tree = _unflatten(paths, blocks)
        index = {id(t): i for i, t in enumerate(blocks)}
        grads = [None] * len(blocks)

        def add(leaves, gs):
            for t, g in zip(leaves, gs):
                if g is not None:
                    i = index[id(t)]
                    grads[i] = g if grads[i] is None else grads[i] + g

        zero = torch.zeros((), dtype=torch.float32, device=self.dev)
        parts = {"nll": zero, "aux": zero}
        tail_leaves = [t for path, t in zip(paths, blocks)
                       if path[0] != "blocks"]
        n_tokens = b * T * self.dp

        def tail_grads(y, rows):
            yd = y.detach().requires_grad_(True)
            with torch.enable_grad():
                obj, nll, aux = sharded_tail(tree, yd, lab[rows], cfg,
                                             self.shards, n_tokens)
                got = torch.autograd.grad(obj, [yd] + tail_leaves,
                                          allow_unused=True)
            add(tail_leaves, got[1:])
            parts["nll"] = parts["nll"] + nll
            parts["aux"] = parts["aux"] + aux
            return got[0]

        if self.moe:
            def tail(ys):
                dy = tail_grads(torch.cat(ys), slice(0, b))
                return list(dy.reshape((M, mb) + tuple(dy.shape[1:])))
        else:
            def tail(j, y):
                return tail_grads(y, slice(j * mb, (j + 1) * mb))

        x = xs = None
        if s == 0:
            x = sharded_embed(tree, tok, cfg, self.shards)
            xs = list(x.detach().reshape((M, mb) + tuple(x.shape[1:])))
        like = torch.empty((mb, T // self.mp, cfg.hidden), dtype=cfg.dtype,
                           device=self.dev)
        dx, stage_grads = pipe.run(tree["blocks"], xs,
                                   tail if s == S - 1 else None,
                                   whole_tail=self.moe, like=like)
        add([t for path, t in zip(paths, blocks) if path[0] == "blocks"],
            [stage_grads[path[1]] for path in paths if path[0] == "blocks"])
        if s == 0:
            emb = [tree["wte"], tree["wpe"]]
            add(emb, torch.autograd.grad(x, emb, torch.cat(dx),
                                         allow_unused=True))
        return grads, self._reported(parts["nll"], parts["aux"], tok.numel())

    def put_batch(self, arr):
        """The global batch on the device (a rank's step reads its dp
        rows of it)."""
        return torch.as_tensor(arr).to(self.dev)

    def __call__(self, params, opt_state, tokens, labels):
        mesh = self.mesh
        tok, lab = self.put_batch(tokens), self.put_batch(labels)
        if tok.shape[0] % self.dp:
            raise ValueError(f"global batch {tok.shape[0]} over dp="
                             f"{self.dp}")
        b = tok.shape[0] // self.dp
        tok = tok[self.dp_rank * b:(self.dp_rank + 1) * b]
        lab = lab[self.dp_rank * b:(self.dp_rank + 1) * b]
        flat = _paths(params)
        blocks, comp = [], []
        for path, p in flat:
            c_spec = self.compute_spec(path, tuple(p.shape))
            comp.append(c_spec)
            with torch.no_grad():
                c = reshard(to_local(p), spec_of(p, mesh), c_spec, mesh)
            blocks.append(c.detach().requires_grad_(True))
        paths = [q for q, _ in flat]
        if self.pipe is not None:
            grads, loss = self._pipeline_grads(blocks, paths, tok, lab)
        else:
            obj, loss = self.loss(_unflatten(paths, blocks), tok, lab)
            grads = torch.autograd.grad(obj, blocks, allow_unused=True)
        self.update(flat, comp, grads, opt_state)
        return loss.detach(), params, opt_state

    def _moment(self, leaf, work, shape, cols):
        """A moment as an fp32 block of the work layout. An int8 moment
        is gathered and dequantized whole on every rank (its blocks run
        over the leaf's flat order, not over the layout's dims): the
        whole fp32 leaf exists for a moment on each rank."""
        mesh = self.mesh
        if _is_quant(leaf):
            q = {k: gather_full(to_local(v), spec_of(v, mesh), mesh)
                 for k, v in leaf.items()}
            full = _dequantize_moment(q, torch.empty(shape, device="meta"))
            if cols is not None:
                full = full[..., cols.to(full.device)]
            return local_shard(full, work, mesh)
        return reshard(to_local(leaf), spec_of(leaf, mesh), work,
                       mesh).float()

    def _store(self, leaf, x32, work, cols):
        """Write an fp32 block of the work layout into a moment."""
        mesh = self.mesh
        if _is_quant(leaf):
            full = _to_reference(gather_full(x32, work, mesh), cols)
            q = _quantize_moment(full)
            for k, v in leaf.items():
                to_local(v).copy_(local_shard(q[k], spec_of(v, mesh), mesh))
            return
        dst = to_local(leaf)
        dst.copy_(reshard(x32, work, spec_of(leaf, mesh), mesh).to(
            dst.dtype))

    def _sync(self, g, c_spec, work, cols, ndim):
        """A parameter's gradient block, summed over the ranks that
        replicate the parameter, in the work layout. Under the int8-wire
        sync the dp part is ``dist_allreduce_quant`` (mean) of the whole
        leaf in the reference's order, as the reference's region sees
        it."""
        mesh = self.mesh
        axes = [a for a in ("mp", "pp", "dp") if mesh.shape.get(a, 1) > 1
                and a not in _axes(c_spec, ndim)
                and not (self.quant and a == "dp")]
        if not self.quant:
            return _reduce_to(g, c_spec, work, axes, mesh)
        g = _reduce_to(g, c_spec, c_spec, axes, mesh)
        full = _to_reference(gather_full(g, c_spec, mesh), cols)
        full = dist_allreduce_quant(full, mesh.group("dp"), mean=True)
        if cols is not None:
            full = full[..., cols.to(full.device)]
        return local_shard(full, work, mesh)

    @torch.no_grad()
    def update(self, flat, comp, grads, state, wd=0.1, b1=0.9, b2=0.95,
               eps=1e-8):
        mesh = self.mesh
        t = state["t"] + 1
        bc1 = 1.0 - b1 ** t.float()
        bc2 = 1.0 - b2 ** t.float()
        masters = state.get("master")
        for (path, p), c_spec, g in zip(flat, comp, grads):
            shape = tuple(p.shape)
            cols = getattr(p, REF_COLUMNS, None)
            m, v = _at(state["m"], path), _at(state["v"], path)
            mw = _at(masters, path) if masters is not None else None
            has_master = mw is not None and mw.numel() > 0
            # the optimizer's layout: that of the plain moments / master
            work = next((spec_of(a, mesh) for a in (mw, m, v)
                         if a is not None and not _is_quant(a)
                         and a.numel() > 0), spec_of(p, mesh))
            if g is None:
                g = torch.zeros(to_local(p).shape, device=self.dev)
            g = self._sync(g.float(), c_spec, work, cols, len(shape))
            p_loc, p_spec = to_local(p), spec_of(p, mesh)
            p32 = (reshard(to_local(mw), spec_of(mw, mesh), work, mesh)
                   if has_master
                   else reshard(p_loc, p_spec, work, mesh).float())
            p32, m32, v32 = _adam_math(
                g, self._moment(m, work, shape, cols),
                self._moment(v, work, shape, cols), p32, bc1, bc2, self.lr,
                wd, b1, b2, eps)
            if has_master:
                to_local(mw).copy_(reshard(p32, work, spec_of(mw, mesh),
                                           mesh))
                new = p32.to(p.dtype)
            elif self.sr and p.dtype == torch.bfloat16:
                # one draw of the whole leaf, the same on every rank: each
                # block takes its own part of it
                r = torch.randint(0, 1 << 16, shape, generator=self.sr_gen,
                                  device=p32.device, dtype=torch.int32)
                new = _round_with(p32, local_shard(r, work, mesh).clone(),
                                  p.dtype)
            else:
                new = p32.to(p.dtype)
            p_loc.copy_(reshard(new, work, p_spec, mesh))
            self._store(m, m32, work, cols)
            self._store(v, v32, work, cols)
        state["t"].copy_(t)


def _to_reference(full, cols):
    """A whole leaf held in the port's column order, in the
    reference's."""
    if cols is None:
        return full
    out = torch.empty_like(full)
    out[..., cols.to(full.device)] = full
    return out


def make_sharded_train_step(cfg: GPTConfig, mesh, lr: float = 1e-4,
                            n_microbatches: int = 1, zero1: bool = True,
                            seed: int = 0, m_dtype: str | None = None,
                            v_dtype: str | None = None,
                            weights: str = "auto", abstract: bool = False,
                            _emb_pin: bool = True, device=None):
    """``(step_fn, params, opt_state)`` of the sharded train step on
    ``mesh`` (``distributed.process_mesh.build_mesh(shape, ("dp", "pp",
    "mp"))``): ``step_fn(params, opt_state, tokens, labels) -> (loss,
    params, opt_state)`` on the global batch (numpy or tensors; each rank
    takes its dp rows), the loss the global one, the same on every rank.

    - dp: the batch rows; gradients summed over dp (reduce-scattered
      onto the ZeRO-1 layout of the moments and masters with ``zero1``).
    - mp: Megatron tensor parallelism with sequence parallelism between
      blocks (``models/gpt.py::sharded_loss_fn``): heads, F columns and
      the vocab over mp, tokens over mp between blocks.
    - pp: each rank holds its L / pp layers; the blocks run as a pipeline
      of ``n_microbatches`` microbatches of a dp rank's rows
      (``parallel/pipeline.py``, the reference's "1f1b" schedule; the
      step's ``pipe.schedule`` may be set to "gpipe"), the embedding on
      stage 0, the MoE layers, final LayerNorm and head on the last
      stage; a stage's activation over mp is the rank's [mb, T / mp, H],
      passed between ranks of equal (dp, mp).
    - ``cfg.ring_axis="mp"``: attention runs as ring attention over mp
      (an all-to-all to the ring's layout, every head over T / mp, and
      back); an axis absent from the mesh or of one rank routes attention
      to ``flash_attention_raw`` (K1-sep / K3-sep), as one device does.
    - MoE: the expert dim over dp where dp divides it.
    - ZeRO-3: ``distributed.sharding.shard_array_over(p, mesh, "dp")`` on
      the parameters the step returns: they are held sharded between
      steps; the step gathers all of them to their compute layout before
      the forward (not layer by layer: the peak is not ZeRO-3's) and
      reduce-scatters their gradients.
    - ``FLAGS_dist_allreduce_quant``: forward and backward per dp rank on
      its own rows (its own MoE capacity; parameters gathered over dp),
      gradients synced by ``dist_allreduce_quant`` (mean), the loss the
      mean of the ranks' losses, as the reference's per-rank region;
      refused with pp > 1 and dp > 1, as the reference refuses it.

    On a mesh whose every axis is 1 this is ``make_train_step`` (the
    same state and step, bit for bit); ``n_microbatches`` is ignored
    without pp, as in the reference, and ``_emb_pin`` (a GSPMD layout
    pin) means nothing here. On more ranks the parameters are drawn from
    ``seed`` on every rank and cut into blocks, and the state is
    DTensors on the mesh's DeviceMesh (of the step's device type, so
    that gloo ranks sharing a card keep their state on it).
    ``abstract`` (the AOT state) is not ported."""
    _check_options(weights, m_dtype, v_dtype)
    pp = mesh.shape.get("pp", 1)
    if pp > 1 and GLOBAL_FLAGS.get("dist_allreduce_quant") and \
            mesh.shape.get("dp", 1) > 1:
        raise ValueError(QUANT_SYNC_PP_REFUSAL)
    if abstract:
        raise NotImplementedError(
            "abstract=True (the AOT state on the meta device) is not "
            "ported: ROADMAP.md, Queue 1")
    if mesh.size == 1:
        step, params, opt_state = make_train_step(
            cfg, lr=lr, seed=seed, m_dtype=m_dtype, v_dtype=v_dtype,
            weights=weights, device=device)
        step.mesh = mesh
        return step, params, opt_state
    _check_mesh(cfg, mesh)
    dev = resolve_device(device)
    mesh.make_device_mesh(dev.type)     # every rank makes the groups now
    low_precision = cfg.param_dtype != cfg.dtype
    sr = weights == "sr-bf16" and low_precision
    master = low_precision and not sr
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt_state = adamw_init(params, master_weights=master, m_dtype=m_dtype,
                           v_dtype=v_dtype)
    if low_precision:
        params = _tree_map(
            lambda a: a.to(cfg.dtype) if a.dim() >= 2 else a, params)
    params = shard_gpt_params(params, cfg, mesh)
    opt_state = shard_opt_state(opt_state, cfg, mesh, zero1)
    step = _ShardedStep(cfg, mesh, lr, sr, dev, seed, n_microbatches)
    return step, params, opt_state
