"""GPT, the flagship decoder-only LM, for training (port of
paddle_tpu/models/gpt.py).

The parameter tree has the reference's names, shapes and dtypes, with
``blocks.*`` stacked on a leading layer axis. Every cast point of the
reference is kept: LayerNorm computes in fp32 and casts back, matmuls
take and return ``cfg.dtype``, the gelu is tanh-approximate and the
logits are fp32. Attention on the fused qkv projection goes through the
flash kernels (K1 forward, K2 or K3 backward); where that gate fails,
through ``flash_attention_raw`` on the split q, k, v (K1-sep and K3-sep,
or the head-major K17 under ``flash_attention_native_layout=0`` or with
d 64 and an odd head count), as the reference's ``_attention``. The
chunked loss goes through the vocab-streaming cross-entropy kernels (K4,
K5) on CUDA.

The model is written as the plain op-by-op composition
(``_model_apply_unfused``); ``model_apply`` runs it through the fusion
compiler (``compiler.fused_call``), which places K6 (residual + bias +
LayerNorm) and K7 (bias + gelu) in the forward, as the reference's
default path does. Eager PyTorch always runs the layer loop unrolled, so
``unroll`` changes nothing.

MoE layers (``moe_block_apply``: Switch top-1 routing with a capacity,
the Switch aux loss) run after the dense stack, as the reference's.
Dispatch and combine go by slot index where the reference multiplies
by one-hot tensors: a slot (expert, queue position) holds at most one
token, so every sum the reference's einsums take has one nonzero term
and the two forms give the same bits. ``sharded_loss_fn`` is the
forward of the sharded train step (parallel/train_step.py) on a rank's
blocks, with explicit collectives where the reference leaves GSPMD to
place them; the pipeline runs its three parts (``sharded_embed``,
``sharded_block``, ``sharded_tail``) on the stages that own them. The
compiler does not trace it (its collectives are no graph ops), so it
places K6, K7 and K4/K5 itself where the compiler's plan would.
``model_apply``'s ``blocks_fn`` (the pipeline's,
``parallel/pipeline.py::pipeline_blocks_fn``) replaces the layer loop
and runs the plain composition; its other sharding hooks
(``sp_constraint``, ``emb_constraint``) are GSPMD layout constraints the
port has no use for, and raise.

``ring_axis``: on a sharded step's mesh whose axis of that name has more
than one rank (mp, the one the port honours), attention runs as ring
attention over it (``parallel/ring_attention.py``); where the axis is
absent or of one rank, as on one device, the fused-qkv entry is skipped
and attention goes through ``flash_attention_raw`` on the split q, k, v
(K1-sep forward, K3-sep backward), as the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..compiler import fused_call, remat_call
from ..core.flags import GLOBAL_FLAGS
from ..distributed.autograd_collectives import (all_gather_dim,
                                                all_reduce_sum,
                                                all_to_all_dim,
                                                reduce_scatter_dim)
from ..ops.kernels.flash_attention import (flash_attention_qkv,
                                           flash_attention_raw,
                                           flash_qkv_supported,
                                           flash_supported)
from ..ops.kernels.fused_bias_act import (fused_bias_act_supported,
                                          fused_bias_gelu)
from ..ops.kernels.fused_ce import (fused_ce_bwd, fused_ce_fwd,
                                    fused_ce_supported, fused_softmax_ce)
from ..ops.kernels.fused_norm_epilogue import (fused_norm_epilogue,
                                               fused_norm_epilogue_supported)

__all__ = ["GPTConfig", "gpt_presets", "init_params", "block_apply",
           "moe_block_apply", "moe_route", "moe_dispatch", "moe_combine",
           "moe_dispatch_dense", "moe_combine_dense", "model_apply",
           "loss_fn", "sharded_loss_fn", "sharded_embed", "sharded_block",
           "sharded_tail", "Shards", "gpt_flops_per_token"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    seq_len: int = 1024
    ffn_mult: int = 4
    n_experts: int = 0
    n_moe_layers: int = 0
    moe_capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16          # activation / compute dtype
    param_dtype: Any = torch.float32     # master params
    tie_embeddings: bool = True
    use_flash: bool = True
    # False | True | "full": each block runs through compiler.remat_call
    # (torch.utils.checkpoint with a selective policy, the reference's):
    # True saves the weight matmuls' outputs and the flash o/lse, "full"
    # the flash o/lse only; everything else (K6, K7, the elementwise work)
    # is recomputed in the backward, K1 never
    remat: bool | str = True
    unroll: bool = False                 # eager: always unrolled
    ring_axis: Optional[str] = None
    eps: float = 1e-5

    def __post_init__(self):
        if self.remat not in (False, True, "full"):
            raise ValueError(f"remat must be False, True, or 'full'; got "
                             f"{self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


def gpt_presets(name: str) -> GPTConfig:
    """GPT-3 family sizes (the reference's table)."""
    table = {
        "gpt3-125m": dict(hidden=768, n_layers=12, n_heads=12),
        "gpt3-350m": dict(hidden=1024, n_layers=24, n_heads=16),
        "gpt3-760m": dict(hidden=1536, n_layers=24, n_heads=16),
        "gpt3-1.3b": dict(hidden=2048, n_layers=24, n_heads=16),
        "gpt3-2.7b": dict(hidden=2560, n_layers=32, n_heads=32),
        "gpt3-6.7b": dict(hidden=4096, n_layers=32, n_heads=32),
        "gpt3-13b": dict(hidden=5120, n_layers=40, n_heads=40),
    }
    return GPTConfig(**table[name])


@dataclasses.dataclass(frozen=True)
class Shards:
    """A rank's place in a sharded step, as the forward needs it: the
    process groups along dp and mp (None: one rank, every collective the
    identity), this rank's index on each, whether the expert dim is
    split over dp, and the mesh whose ``cfg.ring_axis`` ring attention
    runs over (None: no ring). ``dp`` None with ``dp_size`` 1 is also
    how the per-rank forward of the int8-wire sync sees the batch: its
    own rows only."""
    dp: Any = None
    dp_size: int = 1
    dp_rank: int = 0
    mp: Any = None
    mp_size: int = 1
    mp_rank: int = 0
    ep: bool = False
    ring: Any = None


_ONE = Shards()


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters drawn on ``device`` from ``generator``: normal
    (0.02), wpe 0.01, residual projections 0.02 / sqrt(2L), LayerNorm
    gains 1 and biases 0. The numbers differ from the reference's (another
    generator); the tree, names, shapes and dtypes are the same."""
    H, L, Fd = cfg.hidden, cfg.n_layers, cfg.ffn_mult * cfg.hidden
    std = 0.02
    pstd = std / math.sqrt(2 * L)
    pd = cfg.param_dtype

    def nrm(shape, s=std):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, s, generator=generator)
        return w.to(pd)

    def const(shape, v):
        return torch.full(shape, v, dtype=pd, device=device)

    params = {
        "wte": nrm((cfg.vocab_size, H)),
        "wpe": nrm((cfg.seq_len, H), 0.01),
        "blocks": {
            "ln1_g": const((L, H), 1.0),
            "ln1_b": const((L, H), 0.0),
            "qkv_w": nrm((L, H, 3 * H)),
            "qkv_b": const((L, 3 * H), 0.0),
            "proj_w": nrm((L, H, H), pstd),
            "proj_b": const((L, H), 0.0),
            "ln2_g": const((L, H), 1.0),
            "ln2_b": const((L, H), 0.0),
            "fc_w": nrm((L, H, Fd)),
            "fc_b": const((L, Fd), 0.0),
            "fc2_w": nrm((L, Fd, H), pstd),
            "fc2_b": const((L, H), 0.0),
        },
        "lnf_g": const((H,), 1.0),
        "lnf_b": const((H,), 0.0),
    }
    if not cfg.tie_embeddings:
        params["head_w"] = nrm((H, cfg.vocab_size))
    if cfg.n_experts > 0 and cfg.n_moe_layers > 0:
        E, M = cfg.n_experts, cfg.n_moe_layers
        params["moe"] = {
            "ln_g": const((M, H), 1.0),
            "ln_b": const((M, H), 0.0),
            "router_w": nrm((M, H, E), 0.01),
            "w1": nrm((M, E, H, Fd)),
            "b1": const((M, E, Fd), 0.0),
            "w2": nrm((M, E, Fd, H), pstd),
            "b2": const((M, E, H), 0.0),
        }
    return params


def _layer_norm(x, g, b, eps):
    """fp32 statistics (population variance), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _mm(x, w, cfg: GPTConfig):
    return torch.matmul(x, w.to(cfg.dtype))


def _attention(q, k, v, cfg: GPTConfig):
    """Causal attention on [B, T, nH, dH] where the fused-qkv gate fails,
    as the reference's: ``flash_attention_raw`` (K1-sep, or the
    head-major K17) where the flash gate holds, else plain attention
    (fp32 logits, fill -1e30, probabilities cast to q's dtype)."""
    if cfg.use_flash and flash_supported(q.shape, q.dtype):
        return flash_attention_raw(q, k, v, causal=True)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    T = q.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend(qkv, n_heads: int, cfg: GPTConfig):
    """Causal attention over the fused projection ``qkv`` [B, T, 3 h d]
    (q, k, v of ``n_heads`` heads), to [B, T, h d]."""
    B, T, three = qkv.shape
    H = three // 3
    if cfg.use_flash and not cfg.ring_axis and \
            flash_qkv_supported(qkv.shape, n_heads, qkv.dtype):
        # K1/K2 read q, k and v from the projection output in place
        return flash_attention_qkv(qkv, n_heads, causal=True).reshape(
            B, T, H)
    q, k, v = (t.reshape(B, T, n_heads, cfg.head_dim)
               for t in qkv.split(H, dim=-1))
    return _attention(q, k, v, cfg).reshape(B, T, H)


def block_apply(bp: dict, x, cfg: GPTConfig):
    """One pre-LN transformer block; ``bp`` leaves are one layer's slice."""
    dt = cfg.dtype
    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"], cfg.eps)
    qkv = _mm(h, bp["qkv_w"], cfg) + bp["qkv_b"].to(dt)
    o = _attend(qkv, cfg.n_heads, cfg)
    o = _mm(o, bp["proj_w"], cfg)
    x = x + o + bp["proj_b"].to(dt)
    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"], cfg.eps)
    h = _mm(h, bp["fc_w"], cfg)
    h = F.gelu(h + bp["fc_b"].to(dt), approximate="tanh")
    h = _mm(h, bp["fc2_w"], cfg)
    return x + h + bp["fc2_b"].to(dt)


def _fusing(switch: str) -> bool:
    """Whether the fusion compiler would apply the templates behind the
    kill switch ``switch``."""
    return bool(GLOBAL_FLAGS.get("use_auto_fusion")
                and GLOBAL_FLAGS.get(switch))


def _sharded_norm(x, g, b, cfg: GPTConfig, sub=None, bias=None):
    """(r, LayerNorm(r)) with r = x (+ sub + bias) in the sharded
    forward: K6 where the compiler's plan would place it (the
    ``layer_epilogue`` template on, its gate on the rows holding), else
    the plain composition."""
    n = x.numel() // x.shape[-1]
    if _fusing("use_fused_norm_epilogue") and \
            fused_norm_epilogue_supported(n, x.shape[-1], x.dtype):
        return fused_norm_epilogue(x, sub, bias, g, b, norm="layer",
                                   eps=cfg.eps)
    if sub is not None:
        x = x + sub + bias.to(x.dtype)
    return x, _layer_norm(x, g, b, cfg.eps)


def _sharded_bias_gelu(h, b):
    """gelu_tanh(h + b) in the sharded forward: K7 where the compiler's
    ``bias_gelu`` template would place it, else the plain expression."""
    n = h.numel() // h.shape[-1]
    if _fusing("use_fused_bias_act") and \
            fused_bias_act_supported(n, h.shape[-1], h.dtype):
        return fused_bias_gelu(h, b)
    return F.gelu(h + b.to(h.dtype), approximate="tanh")


def _ring_attend(qkv, cfg: GPTConfig, shards: Shards):
    """Ring attention over mp on the fused projection ``qkv`` [B, T, 3 h
    d] of this rank's h heads over the whole sequence: an all-to-all
    over mp brings q, k and v to the ring's layout (every head, T / mp
    positions), the ring runs, and a second all-to-all brings the output
    back to this rank's heads over T, [B, T, h d]."""
    # imported here: the parallel package imports this module
    from ..parallel.ring_attention import ring_attention

    B, T, three = qkv.shape
    hl = three // 3 // cfg.head_dim
    q, k, v = (all_to_all_dim(t.reshape(B, T, hl, cfg.head_dim), 1, 2,
                              shards.mp)
               for t in qkv.split(three // 3, dim=-1))
    o = ring_attention(q, k, v, shards.ring, axis=cfg.ring_axis,
                       causal=True)
    return all_to_all_dim(o, 2, 1, shards.mp).reshape(B, T, three // 3)


def sharded_block(bp: dict, x, cfg: GPTConfig, shards: Shards):
    """``block_apply`` on a rank's blocks, with K6 at both LayerNorms
    (the second folding in the attention's residual and proj's bias, as
    the compiler's plan does) and K7 at the gelu, on the rows this rank
    holds. Over mp (Megatron-SP): ``x`` holds this rank's tokens [B,
    T / mp, H]; each LayerNorm output is all-gathered over T before a
    column-parallel product (qkv with the rank's heads, fc with its F
    columns), and each row-parallel product (proj, fc2) is
    reduce-scattered back over T. With ``shards.ring`` the attention is
    ring attention over mp (``_ring_attend``). Without mp the
    collectives are the identity."""
    dt = cfg.dtype
    mp = shards.mp
    h = _sharded_norm(x, bp["ln1_g"], bp["ln1_b"], cfg)[1]
    h = all_gather_dim(h, 1, mp)
    qkv = _mm(h, bp["qkv_w"], cfg) + bp["qkv_b"].to(dt)
    if shards.ring is not None:
        o = _ring_attend(qkv, cfg, shards)
    else:
        o = _attend(qkv, cfg.n_heads // shards.mp_size, cfg)
    o = reduce_scatter_dim(_mm(o, bp["proj_w"], cfg), 1, mp)
    x, h = _sharded_norm(x, bp["ln2_g"], bp["ln2_b"], cfg, o, bp["proj_b"])
    h = all_gather_dim(h, 1, mp)
    h = _sharded_bias_gelu(_mm(h, bp["fc_w"], cfg), bp["fc_b"])
    h = reduce_scatter_dim(_mm(h, bp["fc2_w"], cfg), 1, mp)
    return x + h + bp["fc2_b"].to(dt)


def _exclusive_counts(counts, shards: Shards):
    """Per expert, the tokens routed to it by the dp ranks before this
    one (their rows come first in the global batch)."""
    if shards.dp is None:
        return torch.zeros_like(counts)
    import torch.distributed as dist

    every = torch.empty((shards.dp_size * counts.numel(),),
                        dtype=counts.dtype, device=counts.device)
    dist.all_gather_into_tensor(every, counts.contiguous(), group=shards.dp)
    return every.reshape(shards.dp_size, -1)[:shards.dp_rank].sum(0)


def moe_route(flat, router_w, capacity: int, shards: Shards = None):
    """Top-1 routing of the token rows ``flat`` [N, H]: (probs [N, E]
    fp32, onehot [N, E] int32 of the chosen expert, gate [N] its
    probability, slot [N]: expert x C + the token's queue position, or
    E x C where the token is dropped). With ``shards`` the queue
    positions continue after the dp ranks before this one."""
    E = router_w.shape[-1]
    logits = torch.matmul(flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    idx = probs.argmax(-1)
    gate = probs.gather(-1, idx[:, None])[:, 0]
    onehot = (idx[:, None] == torch.arange(E, device=flat.device)).to(
        torch.int32)
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    pos = pos + _exclusive_counts(onehot.sum(0), shards or _ONE)[idx]
    slot = torch.where(pos < capacity, idx * capacity + pos, E * capacity)
    return probs, onehot, gate, slot


def moe_dispatch(flat, slot, E: int, C: int):
    """[E, C, H]: each slot's token row (0 where the slot is empty).

    Empty slots and dropped tokens all read or write one zero row, so
    the gathers are ``index_select``: its backward adds the rows by
    index (``index_add_``), where advanced indexing's sorts and adds
    the thousands of duplicates of that row one by one: 72 ms for two
    layers' forward and backward at gpt3-350m's widths on an H100."""
    n, H = flat.shape
    src = torch.full((E * C + 1,), n, dtype=torch.long,
                     device=flat.device).scatter(
        0, slot, torch.arange(n, device=flat.device))[:E * C]
    rows = torch.cat([flat, flat.new_zeros((1, H))])
    return rows.index_select(0, src).reshape(E, C, H)


def moe_combine(hout, slot, gate):
    """[N, H]: each token's slot of the expert outputs ``hout`` [E, C,
    H] times its gate (0 where the token was dropped)."""
    E, C, H = hout.shape
    rows = torch.cat([hout.reshape(E * C, H), hout.new_zeros((1, H))])
    return gate.to(hout.dtype)[:, None] * rows.index_select(0, slot)


def moe_dispatch_dense(flat, slot, E: int, C: int):
    """``moe_dispatch`` as the reference computes it: the one-hot
    dispatch tensor [N, E, C] contracted with the rows (the plain
    version the card holds the gather to)."""
    disp = _dispatch_tensor(slot, E, C, flat.dtype)
    return torch.einsum("nec,nh->ech", disp, flat)


def moe_combine_dense(hout, slot, gate):
    """``moe_combine`` as the reference computes it: the dispatch tensor
    times the gates, contracted with the expert outputs."""
    E, C, H = hout.shape
    comb = _dispatch_tensor(slot, E, C, hout.dtype) * gate.to(
        hout.dtype)[:, None, None]
    return torch.einsum("nec,ech->nh", comb, hout)


def _dispatch_tensor(slot, E: int, C: int, dtype):
    e = torch.arange(E * C, device=slot.device)
    return (slot[:, None] == e[None, :]).to(dtype).reshape(-1, E, C)


def moe_block_apply(mp: dict, x, cfg: GPTConfig, shards: Shards = None):
    """Switch-style top-1 MoE FFN: returns (x + y, aux).

    Capacity ``C = max(1, int(cap * N / E))`` over the N tokens of the
    (global) batch; a token's queue position is the number of tokens
    before it, in batch order, routed to its expert, and tokens at C or
    beyond are dropped (their residual passes through). Dispatch gathers
    each slot's token and combine gathers each token's slot, scaled by
    its gate (``moe_dispatch``, ``moe_combine``); the reference's one-hot
    einsums sum one nonzero term, so the bits are the same. Aux is the
    Switch load-balance loss E * sum_e f_e P_e over the batch.

    With ``shards``: ``x`` holds this rank's rows (and, over mp, its
    tokens, all-gathered here); positions continue after the dp ranks
    before this one; each rank's slots are summed onto the rank that owns
    the expert (a reduce-scatter over dp when the experts are split over
    dp, else an all-reduce), expert outputs, summed over mp (F is split
    over mp), are all-gathered back; f and P are global means. The
    LayerNorm is K6 where the compiler would place it (without
    ``shards`` the compiler traces this function and places it)."""
    s = shards or _ONE
    xf = all_gather_dim(x, 1, s.mp)
    B, T, H = xf.shape
    E = mp["router_w"].shape[-1]
    N = B * T * s.dp_size
    C = max(1, int(cfg.moe_capacity_factor * N / E))
    dt = cfg.dtype
    if shards is None:
        # traced by the compiler, which places K6 here
        flat = _layer_norm(xf, mp["ln_g"], mp["ln_b"], cfg.eps)
    else:
        flat = _sharded_norm(xf, mp["ln_g"], mp["ln_b"], cfg)[1]
    flat = flat.reshape(-1, H)
    probs, onehot, gate, slot = moe_route(flat, mp["router_w"], C, s)
    xin = moe_dispatch(flat.to(dt), slot, E, C)
    if s.ep:
        xin = reduce_scatter_dim(xin, 0, s.dp)
    else:
        xin = all_reduce_sum(xin, s.dp)
    hmid = torch.bmm(xin, mp["w1"].to(dt))
    b1 = mp["b1"]
    if b1.shape[-1] != hmid.shape[-1]:
        # w1's F columns are split over mp and b1 (the reference's spec)
        # is not: this rank's part of it
        f = hmid.shape[-1]
        b1 = b1[:, s.mp_rank * f:(s.mp_rank + 1) * f]
    hmid = F.gelu(hmid + b1.to(dt)[:, None, :], approximate="tanh")
    hout = all_reduce_sum(torch.bmm(hmid, mp["w2"].to(dt)), s.mp)
    hout = hout + mp["b2"].to(dt)[:, None, :]
    if s.ep:
        hout = all_gather_dim(hout, 0, s.dp)
    y = moe_combine(hout, slot, gate).reshape(B, T, H)
    if s.mp is not None:
        t_loc = x.shape[1]
        y = y[:, s.mp_rank * t_loc:(s.mp_rank + 1) * t_loc]
    f = all_reduce_sum(onehot.float().sum(0), s.dp) / N
    P = all_reduce_sum(probs.sum(0), s.dp) / N
    aux = E * torch.sum(f * P)
    return x + y, aux


def model_apply(params: dict, tokens, cfg: GPTConfig, sp_constraint=None,
                blocks_fn=None, return_hidden: bool = False,
                emb_constraint=None):
    """Forward to fp32 logits [B, T, V] (or, with ``return_hidden``, the
    final hidden states), and the MoE aux loss (0 without MoE layers).
    Routed through the fusion compiler, as the reference's when no
    sharding hooks are passed: the plan places K6 at every LayerNorm and
    K7 at every FFN gelu (with ``use_auto_fusion=0``, the plain
    composition runs). ``blocks_fn(params["blocks"], x)`` (the
    pipeline's) replaces the layer loop; the model around it is then the
    plain composition, which the compiler does not trace (as the
    reference's pp step runs outside its ``auto_fuse``).
    ``sp_constraint`` and ``emb_constraint`` are the reference's GSPMD
    layout constraints; the port's sharded step runs
    ``sharded_loss_fn`` instead."""
    if sp_constraint is not None or emb_constraint is not None:
        raise NotImplementedError(
            "sp_constraint and emb_constraint are GSPMD layout hooks: the "
            "port's sharded forward is "
            "parallel/train_step.py::make_sharded_train_step")
    if blocks_fn is not None:
        return _model_apply_unfused(params, tokens, cfg, return_hidden,
                                    blocks_fn=blocks_fn)
    return fused_call(("gpt_apply", cfg, bool(return_hidden)),
                      functools.partial(_model_apply_unfused, cfg=cfg,
                                        return_hidden=return_hidden),
                      params, tokens)


# remat setting -> compiler.remat_call policy (reference gpt.py's
# save_from_both_policies(dots_with_no_batch_dims_saveable, flash names)
# and save_only_these_names("flash_o", "flash_lse"))
_REMAT_POLICY = {True: "save_dots_and_flash", "full": "save_flash"}


def _model_apply_unfused(params: dict, tokens, cfg: GPTConfig,
                         return_hidden: bool = False, blocks_fn=None):
    """The plain op-by-op forward. With ``remat`` each block runs through
    ``compiler.remat_call`` with its policy: recomputed in the backward
    but for what the policy saves, and planned by the compiler as a
    nested program of its own. ``blocks_fn`` replaces the layer loop."""
    B, T = tokens.shape
    x = params["wte"][tokens.long()].to(cfg.dtype) + \
        params["wpe"][:T].to(cfg.dtype)
    if blocks_fn is not None:
        x = blocks_fn(params["blocks"], x)
    for i in range(cfg.n_layers if blocks_fn is None else 0):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        if cfg.remat:
            x = remat_call(("gpt_block", cfg),
                           functools.partial(block_apply, cfg=cfg), bp, x,
                           policy=_REMAT_POLICY[cfg.remat])
        else:
            x = block_apply(bp, x, cfg)
    x, aux = _moe_layers(params, x, cfg, None)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.eps)
    if return_hidden:
        return x, aux
    head = params["wte"].t() if cfg.tie_embeddings else params["head_w"]
    return torch.matmul(x.float(), head.to(cfg.dtype).float()), aux


def _moe_layers(params: dict, x, cfg: GPTConfig, shards):
    """The MoE layers after the dense stack; (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts > 0 and cfg.n_moe_layers > 0:
        for j in range(cfg.n_moe_layers):
            mp = {k: v[j] for k, v in params["moe"].items()}
            x, a = moe_block_apply(mp, x, cfg, shards)
            aux = aux + a
    return x, aux


def _ce_chunk(xc, head, lc):
    logits = torch.matmul(xc.float(), head.float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - gold).sum()


def _chunked_ce(x, head, labels, chunk: int):
    """Mean cross-entropy over token chunks of the sequence, each chunk's
    fp32 logits recomputed in the backward (the reference's
    jax.checkpoint'ed scan): peak extra memory [B, chunk, V]."""
    B, T, H = x.shape
    return _chunked_ce_total(x, head, labels, chunk) / (B * T)


def _chunked_ce_total(x, head, labels, chunk: int):
    """The summed cross-entropy of ``_chunked_ce``."""
    B, T, H = x.shape
    n = max(1, T // chunk)
    while T % n:
        n -= 1
    c = T // n
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        total = total + checkpoint(_ce_chunk, x[:, i * c:(i + 1) * c], head,
                                   labels[:, i * c:(i + 1) * c].long(),
                                   use_reentrant=False)
    return total


def _ce_kernels(x, n: int, v: int, cfg: GPTConfig) -> bool:
    """Whether the cross-entropy of ``n`` rows of ``x`` against ``v``
    vocab columns goes through K4/K5: on CUDA, with ``use_fused_ce`` on,
    where their gate holds."""
    return bool(x.is_cuda and GLOBAL_FLAGS.get("use_fused_ce")
                and fused_ce_supported(n, cfg.hidden, v, cfg.dtype))


def loss_fn(params, tokens, labels, cfg: GPTConfig, sp_constraint=None,
            blocks_fn=None, loss_chunk: int = 512, emb_constraint=None):
    """Causal LM cross-entropy in fp32. ``loss_chunk`` > 0 never holds
    the full logits: on CUDA with ``use_fused_ce`` on, the vocab-streaming
    kernels (K4/K5); elsewhere the chunked expression. 0 materializes the
    full logits."""
    if loss_chunk:
        hidden, aux = model_apply(params, tokens, cfg, sp_constraint,
                                  blocks_fn, return_hidden=True,
                                  emb_constraint=emb_constraint)
        head = params["wte"].t() if cfg.tie_embeddings else params["head_w"]
        B, T = tokens.shape
        if _ce_kernels(hidden, B * T, cfg.vocab_size, cfg):
            nll_tok = fused_softmax_ce(hidden.reshape(B * T, cfg.hidden),
                                       head.to(cfg.dtype),
                                       labels.reshape(B * T))
            return nll_tok.mean() + 0.01 * aux
        nll = _chunked_ce(hidden, head.to(cfg.dtype), labels, loss_chunk)
        return nll + 0.01 * aux
    logits, aux = model_apply(params, tokens, cfg, sp_constraint, blocks_fn,
                              emb_constraint=emb_constraint)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean() + 0.01 * aux


def _vocab_parallel_nll(x, head, labels, shards: Shards):
    """Per-token cross-entropy [B, T] of all the rows ``x`` [B, T, H]
    against a head whose vocab columns are split over mp: each rank's
    fp32 logits over its slab, the log-sum-exp combined over mp (max,
    then the sum of exponentials) and the gold logit taken on the rank
    whose slab holds the label."""
    import torch.distributed as dist

    B, T, H = x.shape
    v_loc = head.shape[1]
    logits = torch.matmul(x.float(), head.float()).reshape(B * T, v_loc)
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=shards.mp)
    se = all_reduce_sum(torch.exp(logits - m[:, None]).sum(-1), shards.mp)
    lab = labels.long().reshape(-1) - shards.mp_rank * v_loc
    inside = (lab >= 0) & (lab < v_loc)
    gold = logits.gather(-1, lab.clamp(0, v_loc - 1)[:, None])[:, 0]
    gold = all_reduce_sum(torch.where(inside, gold, 0.0), shards.mp)
    return (m + torch.log(se) - gold).reshape(B, T)


def _slab_labels(labels, rank: int, v: int):
    """Labels as indices into vocab slab ``rank`` of ``v`` columns: -1,
    the CE kernels' mark for a row without a label, where the label lies
    in another slab."""
    lab = labels.long() - rank * v
    return torch.where((lab >= 0) & (lab < v), lab, -1)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy [N] of the rows ``x`` [N, H] against a
    head whose vocab columns are split over the group: K4 on this rank's
    slab with the slab's labels (``_slab_labels``: -1, no gold, outside
    it), the
    slabs' log-sum-exps combined over the group and the gold logit taken
    from the rank whose slab holds the label; K5 on the slab with the
    combined log-sum-exp. The output is the same on every rank, and each
    rank's objective takes its own tokens of it, so the backward first
    sums the ranks' gradients (the adjoint of that copy)."""

    @staticmethod
    def forward(ctx, x, head, labels, group):
        nll, lse = fused_ce_fwd(x, head, labels)
        every = all_gather_dim(lse[None], 0, group)
        m = every.amax(0)
        lse_all = m + torch.log(torch.exp(every - m).sum(0))
        gold = all_reduce_sum(torch.where(labels >= 0, lse - nll, 0.0),
                              group)
        ctx.save_for_backward(x, head, labels, lse_all)
        ctx.group = group
        return lse_all - gold

    @staticmethod
    def backward(ctx, g):
        x, head, labels, lse = ctx.saved_tensors
        dx, dh = fused_ce_bwd(x, head, labels, lse,
                              all_reduce_sum(g, ctx.group))
        return dx, dh, None, None


def sharded_embed(params, tokens, cfg: GPTConfig, shards: Shards):
    """The embedding of the sharded forward: [B, T / mp, H] of this
    rank's rows and (over mp) its T-slice. The vocab-parallel embedding
    masks ids outside the rank's slab and reduce-scatters over T."""
    s = shards
    T = tokens.shape[1]
    t_loc = T // s.mp_size
    t0 = s.mp_rank * t_loc
    wte = params["wte"]
    if s.mp is not None and wte.shape[0] != cfg.vocab_size:
        ids = tokens.long() - s.mp_rank * wte.shape[0]
        inside = (ids >= 0) & (ids < wte.shape[0])
        emb = wte[ids.clamp(0, wte.shape[0] - 1)]
        emb = torch.where(inside[..., None], emb, torch.zeros_like(emb))
        emb = reduce_scatter_dim(emb, 1, s.mp)
    else:
        emb = wte[tokens.long()[:, t0:t0 + t_loc]]
    return emb.to(cfg.dtype) + params["wpe"][t0:t0 + t_loc].to(cfg.dtype)


def sharded_tail(params, x, labels, cfg: GPTConfig, shards: Shards,
                 n_tokens: int, loss_chunk: int = 512):
    """The sharded forward after the blocks, on their output ``x`` [B,
    T / mp, H] and its rows' ``labels`` [B, T]: the MoE layers, the final
    LayerNorm and the head's cross-entropy; (objective, nll_sum, aux)
    with the objective nll_sum / ``n_tokens`` + 0.01 x aux over the ranks
    that share aux (see ``sharded_loss_fn``). The head's cross-entropy
    runs on the rank's vocab slab of every token's logits with the
    log-sum-exp combined over mp: K4/K5 on the slab on CUDA where their
    gate holds (``_VocabParallelCE``), else the reference's expression
    under a mesh (``_vocab_parallel_nll``); without mp it is the
    single-device cross-entropy on the rank's rows (K4/K5 on CUDA where
    the gate holds)."""
    s = shards
    B, T = labels.shape
    dt = cfg.dtype
    t_loc = T // s.mp_size
    t0 = s.mp_rank * t_loc
    x, aux = _moe_layers(params, x, cfg, s)
    x = _sharded_norm(x, params["lnf_g"], params["lnf_b"], cfg)[1]
    head = (params["wte"].t() if cfg.tie_embeddings
            else params["head_w"]).to(dt)
    if s.mp is not None and head.shape[1] != cfg.vocab_size:
        xf = all_gather_dim(x, 1, s.mp)
        v_loc = head.shape[1]
        if _ce_kernels(xf, B * T, v_loc, cfg):
            lab = _slab_labels(labels.reshape(-1), s.mp_rank, v_loc)
            nll = _VocabParallelCE.apply(xf.reshape(B * T, cfg.hidden),
                                         head, lab, s.mp).reshape(B, T)
        else:
            nll = _vocab_parallel_nll(xf, head, labels, s)
        nll_sum = nll[:, t0:t0 + t_loc].sum()
    else:
        lab = labels[:, t0:t0 + t_loc]
        n = B * t_loc
        if _ce_kernels(x, n, cfg.vocab_size, cfg):
            nll_sum = fused_softmax_ce(x.reshape(n, cfg.hidden), head,
                                       lab.reshape(n)).sum()
        else:
            nll_sum = _chunked_ce_total(x, head, lab, loss_chunk)
    obj = nll_sum / n_tokens + 0.01 * aux / (s.dp_size * s.mp_size)
    return obj, nll_sum.detach(), aux.detach()


def sharded_loss_fn(params, tokens, labels, cfg: GPTConfig, shards: Shards,
                    loss_chunk: int = 512):
    """This rank's share of the loss, on its blocks of the parameters
    and its dp rows of the batch: (objective, nll_sum, aux).

    ``objective`` is the sum of the cross-entropy over the tokens this
    rank owns (its rows; over mp its T-slice) divided by the N tokens of
    the batch, plus 0.01 x aux over the ranks that share aux. Summed over
    ranks it is the loss, and each collective's backward is its forward's
    adjoint, so a parameter's gradient is the sum of its ranks'
    gradients. ``nll_sum`` and ``aux`` make the reported loss. The
    embedding (``sharded_embed``), the blocks (``sharded_block``, which
    place K6 and K7) and the tail (``sharded_tail``) in turn."""
    B, T = tokens.shape
    x = sharded_embed(params, tokens, cfg, shards)
    for i in range(cfg.n_layers):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        fn = functools.partial(sharded_block, cfg=cfg, shards=shards)
        if cfg.remat:
            # every op recomputed, the collectives with them (each rank
            # runs the same backward, so they pair up)
            x = checkpoint(fn, bp, x, use_reentrant=False)
        else:
            x = fn(bp, x)
    return sharded_tail(params, x, labels, cfg, shards,
                        B * T * shards.dp_size, loss_chunk)


def gpt_flops_per_token(cfg: GPTConfig) -> float:
    """Matmul-only MFU accounting, 6 * P_dense + causal attention (the
    port's copy of the reference bench's count)."""
    H, L, S, V, Fd = (cfg.hidden, cfg.n_layers, cfg.seq_len, cfg.vocab_size,
                      cfg.ffn_mult * cfg.hidden)
    p_dense = V * H + L * (4 * H * H + 2 * H * Fd) + (
        0 if cfg.tie_embeddings else H * V)
    return 6 * p_dense + 6 * L * S * H
