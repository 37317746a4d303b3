"""paddle_tpu_torch.compiler: fusion discovery over traced aten graphs.

Port of paddle_tpu/compiler/ (the reference's jaxpr-level pass) to
torch.fx. Models keep their plain composition; :func:`auto_fuse` wraps
a function and, once per trace key:

1. traces it with ``torch.fx.experimental.proxy_tensor.make_fx`` in fake
   mode over the flattened arguments (an aten graph with concrete
   shapes; the flash entry is a registered operator, one node),
2. plans fusions against the template catalog (catalog.py) with the
   validated pass (fusion_pass.py), and
3. rewrites the graph with the fused calls in place of the recognized
   chains.

Later calls with the same key run the rewritten GraphModule: autograd
runs through its aten nodes and the fused functions' own backwards.

The trace key has the content of the reference's ``_trace_key``
(argument structure, shapes and dtypes, the catalog flags) plus the
device and the flash and cross-entropy flags, because the traced graph
bakes in every Python branch taken while tracing. ``FLAGS_use_auto_fusion
=0`` bypasses everything: the wrapper calls the function directly and
traces nothing.

The reference's autotune v2 program record (``program_cache_hit``,
``adopt_program``) has no counterpart yet: the port has no autotune
registry, so ``FusionReport.program_cache_hit`` is always False.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.flags import GLOBAL_FLAGS
from . import fusion_pass
from .fusion_pass import Nested, plan_graph, program_hash, rewrite

__all__ = ["auto_fuse", "fused_call", "discover", "last_report",
           "remat_call", "FusionReport"]

# flags the key carries: the catalog's kill switches, and the flags of
# branches a trace bakes in (flash route, cross-entropy route)
_KEY_FLAGS = ("use_fused_norm_epilogue", "use_fused_rope_attention",
              "use_fused_bias_act",
              "use_fused_ce", "flash_attention_kernel_bwd",
              "flash_attention_native_layout", "use_library_flash_attention")


@dataclasses.dataclass
class FusionReport:
    """What one auto_fuse/discover trace discovered and did."""
    program_hash: str
    n_sites: int            # chains the catalog recognized (applied or not)
    n_applied: int          # chains rewritten to fused calls
    sites: list             # Plan.summary() rows
    program_cache_hit: bool  # no program record in the port: always False
    errors: list            # matcher exceptions (fusion lost, model intact)


_LAST_REPORT: FusionReport | None = None
_TRACING = 0                # > 0 while a program is being traced


def last_report() -> FusionReport | None:
    """Report of the most recent auto_fuse/discover call, or None."""
    return _LAST_REPORT


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _trace_key(flat, spec) -> tuple:
    return (spec, tuple(_meta(x) for x in flat),
            tuple(bool(GLOBAL_FLAGS.get(f)) for f in _KEY_FLAGS))


def _trace(fn, flat, spec):
    """(GraphModule over the flat arguments returning the flat outputs,
    output tree spec)."""
    global _TRACING
    out_spec = []

    def flat_fn(*xs):
        out, s = tree_flatten(fn(*tree_unflatten(list(xs), spec)))
        out_spec.append(s)
        return out

    _TRACING += 1
    try:
        gm = make_fx(flat_fn, tracing_mode="fake")(
            *[x.detach() for x in flat])
    finally:
        _TRACING -= 1
    return gm, out_spec[-1]


def _prepare_nested(gm) -> None:
    """Trace, plan and rewrite every nested program ``gm`` calls, once."""
    for node in gm.graph.nodes:
        if not fusion_pass._is_nested(node):
            continue
        n = fusion_pass.NESTED[node.args[1]]
        if n.gm is not None:
            continue
        example = [torch.empty(s, dtype=d, device=dev)
                   for s, d, dev in n.metas]
        sub, _ = _trace(n.fn, example, n.in_spec)
        _prepare_nested(sub)
        n.plan = plan_graph(sub.graph)
        n.gm = rewrite(sub, n.plan)


@dataclasses.dataclass
class _Program:
    gm: torch.fx.GraphModule
    plan: fusion_pass.Plan
    phash: str
    out_spec: object


def _make_program(fn, flat, spec) -> _Program:
    gm, out_spec = _trace(fn, flat, spec)
    phash = program_hash(gm)
    _prepare_nested(gm)
    plan = plan_graph(gm.graph)
    return _Program(rewrite(gm, plan), plan, phash, out_spec)


def _report(prog: _Program) -> FusionReport:
    sites = list(prog.plan.walk())
    return FusionReport(program_hash=prog.phash, n_sites=len(sites),
                        n_applied=sum(1 for s in sites if s.applied),
                        sites=prog.plan.summary(), program_cache_hit=False,
                        errors=list(prog.plan.walk_errors()))


def auto_fuse(fn):
    """Wrap a function of positional pytrees of tensors for automatic
    fusion. The plan is made once per trace key and cached on the
    wrapper; with ``use_auto_fusion=0`` the wrapper calls ``fn``."""
    cache: dict = {}

    @functools.wraps(fn)
    def wrapped(*args):
        global _LAST_REPORT
        if not GLOBAL_FLAGS.get("use_auto_fusion"):
            return fn(*args)
        flat, spec = tree_flatten(tuple(args))
        key = _trace_key(flat, spec)
        prog = cache.get(key)
        if prog is None:
            prog = cache[key] = _make_program(fn, flat, spec)
        _LAST_REPORT = _report(prog)
        if prog.plan.empty():
            return fn(*args)
        return tree_unflatten(prog.gm(*flat), prog.out_spec)

    wrapped.__wrapped__ = fn
    return wrapped


_WRAPPERS: dict = {}


def fused_call(key, fn, *args):
    """:func:`auto_fuse` with a process-level wrapper cache keyed by
    static configuration, for call sites (model applies) that build a
    new ``functools.partial`` on every call."""
    w = _WRAPPERS.get(key)
    if w is None:
        w = _WRAPPERS[key] = auto_fuse(fn)
    return w(*args)


def discover(fn, *args) -> FusionReport:
    """Trace and plan only: the :class:`FusionReport` auto_fuse would act
    on for these arguments, without running anything."""
    global _LAST_REPORT
    flat, spec = tree_flatten(tuple(args))
    _LAST_REPORT = _report(_make_program(fn, flat, spec))
    return _LAST_REPORT


# What a checkpointed block keeps for its backward, by policy name; the
# rest is recomputed. "save_flash": the flash forward's o and lse (the
# reference's save_only_these_names("flash_o", "flash_lse")), so the flash
# forward never runs twice; "save_dots_and_flash": those and the outputs
# of the weight matmuls, products without batch dimensions (the
# reference's dots_with_no_batch_dims_saveable). None saves nothing: the
# whole block is recomputed.
REMAT_POLICIES = ("save_flash", "save_dots_and_flash")


def _saved_ops(policy: str) -> frozenset:
    from ..ops.kernels import flash_attention, fused_rope_attention  # noqa: F401 -- registers the operators

    ops = torch.ops.paddle_tpu_torch
    flash = {ops.flash_qkv_fwd.default, ops.flash_fwd_sep.default,
             ops.flash_fwd_hm.default, ops.rope_flash_fwd.default}
    if policy == "save_flash":
        return frozenset(flash)
    if policy == "save_dots_and_flash":
        return frozenset(flash | {torch.ops.aten.mm.default,
                                  torch.ops.aten.addmm.default})
    raise ValueError(f"remat policy {policy!r}: expected one of "
                     f"{REMAT_POLICIES} or None")


def checkpointed(fn, args, policy: str | None):
    """``fn(*args)`` under ``torch.utils.checkpoint``, saving for the
    backward what ``policy`` names (see REMAT_POLICIES)."""
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    saved = _saved_ops(policy)

    def decide(ctx, op, *a, **kw):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, decide))


_NESTED_IDS: dict = {}


def remat_call(key, fn, *args, policy: str | None = None):
    """``fn(*args)``, recomputed in the backward except what ``policy``
    saves (see REMAT_POLICIES). Outside a trace this is
    ``torch.utils.checkpoint``. Inside an auto_fuse trace it records one
    node of a nested program that the pass traces and plans on its own
    and runs, fused, under checkpoint with the same policy: the
    counterpart of the reference's fusion inside ``remat2`` bodies.
    ``key`` names ``fn``'s static configuration, as in
    :func:`fused_call`."""
    if not _TRACING:
        return checkpointed(fn, args, policy)
    flat, spec = tree_flatten(args)
    metas = [_meta(t) for t in flat]
    nkey = (key, policy, spec, tuple(metas),
            tuple(bool(GLOBAL_FLAGS.get(f)) for f in _KEY_FLAGS))
    pid = _NESTED_IDS.get(nkey)
    if pid is None:
        pid = _NESTED_IDS[nkey] = len(fusion_pass.NESTED)
        fusion_pass.NESTED[pid] = Nested(fn, spec, metas, policy)
    outs = fusion_pass.nested_program(list(flat), pid)
    return tree_unflatten(outs, fusion_pass.NESTED[pid].out_spec)
