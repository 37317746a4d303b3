"""Fusion template catalog: aten graph patterns -> fused entries.

Port of paddle_tpu/compiler/catalog.py, all five templates:
``rms_epilogue``, ``layer_epilogue`` (K6,
ops/kernels/fused_norm_epilogue.py), ``rope_attention`` (K11,
ops/kernels/fused_rope_attention.py), ``bias_gelu`` (K7) and ``swiglu``
(K12, both ops/kernels/fused_bias_act.py).

Each template is ``(name, matcher)``; a matcher inspects one node of a
:class:`~.fusion_pass.Graph` (the anchor: a node that only occurs inside
its chain, ``aten.rsqrt`` for the norms, ``aten.gelu`` with
``approximate="tanh"`` for the gelu, ``aten.silu`` for the swiglu and the
separate-input flash operator for the rope) and walks producers and
consumers to the whole chain. It returns candidate
:class:`~.fusion_pass.Site` objects in preference order (residual + bias,
then residual, then the norm alone; both rotations, then q only, then k
only) or None; the pass applies the first safe candidate.

The matchers recognize the aten lowering of the port's own composition
(models/gpt.py::_layer_norm, models/llama.py::rms_norm and apply_rope,
the FFNs' ``F.gelu(h + b.to(dt), approximate="tanh")`` and
``F.silu(gate.float()).to(dt) * up``) and nothing else: the layer
statistic is ``aten.var.correction`` with ``correction=0`` over the last
axis, the mean ``aten.mean.dim`` over the last axis, the gelu follows the
add of a rank-1 bias, the rotation splits the last axis in halves
(``aten.split.Tensor``) and multiplies them by fp32 tables. Anything else
(another correction, another axis, the exact gelu, a rank-2 bias, extra
users of a chain's intermediates) returns None or fails validation.

Two standing guards every matcher applies, as the reference's:

- a chain is never followed across a resharding point
  (:func:`_is_sharded`; the one-device port has no such op yet);
- ``applied`` is the fused function's own ``*_supported`` gate, so a
  geometry the kernel does not take keeps its unfused nodes.
"""

from __future__ import annotations

import operator

import torch

from ..core.flags import GLOBAL_FLAGS
from .fusion_pass import Graph, Site, lit_scalar

_aten = torch.ops.aten
# ops that mark a resharding point a fused kernel must not absorb: the
# one-device port has none yet (the reference's sharding_constraint)
_RESHARD_TARGETS: tuple = ()


def _val(atom):
    """The traced tensor (shape, dtype, device) of a node, else None."""
    v = getattr(atom, "meta", {}).get("val") if isinstance(
        atom, torch.fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


def _is(node, *targets) -> bool:
    return (node is not None and node.op == "call_function"
            and node.target in targets)


def _is_sharded(g: Graph, atom) -> bool:
    _, node = g.producer(atom)
    return node is not None and node.target in _RESHARD_TARGETS


def _arg(node, pos: int, name: str, default=None):
    if len(node.args) > pos:
        return node.args[pos]
    return node.kwargs.get(name, default)


def _plain_binary(node) -> bool:
    """An elementwise add/sub/mul without an ``alpha`` scale."""
    return _arg(node, 2, "alpha", 1) == 1


def _lit_operand(node):
    """(literal value, other operand) when one operand of a binary node
    is a scalar literal, else (None, None)."""
    a, b = node.args[:2]
    for lit_at, other in ((a, b), (b, a)):
        v = lit_scalar(lit_at)
        if v is not None:
            return v, other
    return None, None


def _other(node, cur):
    a, b = node.args[:2]
    return b if a is cur else a


def _rows(shape) -> int:
    n = 1
    for d in shape[:-1]:
        n *= d
    return n


def _last_axis(dims, ndim: int) -> bool:
    if isinstance(dims, int):
        dims = [dims]
    return dims is not None and len(dims) == 1 and dims[0] in (-1, ndim - 1)


def _mean_last_axis(g: Graph, atom, of_var, cons: set) -> bool:
    """Match ``of_var.mean(-1, keepdim=True)``; True on success (its node
    and any peeled plumbing added to ``cons``)."""
    root, peeled = g.peel(atom)
    mi, mnode = g.producer(root)
    if not _is(mnode, _aten.mean.dim) or mnode.args[0] is not of_var:
        return False
    v = _val(of_var)
    if (v is None or not _last_axis(_arg(mnode, 1, "dim"), v.dim())
            or not _arg(mnode, 2, "keepdim", False)
            or mnode.kwargs.get("dtype") is not None):
        return False
    cons.update(peeled)
    cons.add(mi)
    return True


# ---------------------------------------------------------------------------
# norm epilogues (rms / layer)
# ---------------------------------------------------------------------------

def _rank1_partner(g: Graph, node, cur, h: int):
    """(root, peeled) of the operand of ``node`` other than ``cur`` when
    it is an [h] tensor (through casts and views), else (None, None)."""
    root, peeled = g.peel(_other(node, cur))
    v = _val(root)
    if v is not None and tuple(v.shape) == (h,):
        return root, peeled
    return None, None


def _norm_tail(g: Graph, y1, x_dtype, want_beta: bool, cons: set):
    """Forward walk from the normalized value: mul by a rank-1 gain, add
    of a rank-1 beta (layer), cast back to ``x_dtype``. Returns
    (gain_root, beta_root, y_out) or None."""
    h = _val(y1).shape[-1]
    gi, gnode = g.sole_consumer(y1)
    if not _is(gnode, _aten.mul.Tensor):
        return None
    gain, peeled = _rank1_partner(g, gnode, y1, h)
    if gain is None:
        return None
    cons.add(gi)
    cons.update(peeled)
    cur, beta = gnode, None
    if want_beta:
        bi, bnode = g.sole_consumer(cur)
        if not _is(bnode, _aten.add.Tensor) or not _plain_binary(bnode):
            return None
        beta, peeled = _rank1_partner(g, bnode, cur, h)
        if beta is None:
            return None
        cons.add(bi)
        cons.update(peeled)
        cur = bnode
    if x_dtype != torch.float32:
        ci, cnode = g.sole_consumer(cur)
        if (not _is(cnode, _aten._to_copy.default)
                or _val(cnode) is None or _val(cnode).dtype != x_dtype):
            return None
        cons.add(ci)
        cur = cnode
    return gain, beta, cur


def _residual_candidates(g: Graph, x_atom, with_bias: bool):
    """Producer patterns of the norm input that fold into the epilogue,
    preferred first: GPT's ``add(add(a, b), cast(bias[h]))`` (with
    ``with_bias``) and ``add(a, b)``. Yields (extra_consumed,
    named_inputs, r_node)."""
    xi, xnode = g.producer(x_atom)
    xv = _val(x_atom)
    if (not _is(xnode, _aten.add.Tensor) or not _plain_binary(xnode)
            or xv is None):
        return

    def like_x(*atoms) -> bool:
        vals = [_val(a) for a in atoms]
        return all(v is not None and v.shape == xv.shape
                   and v.dtype == xv.dtype for v in vals)

    if with_bias:
        for inner, b in (xnode.args[:2], xnode.args[1::-1]):
            b_root, peeled = g.peel(b)
            bv = _val(b_root)
            if bv is None or tuple(bv.shape) != (xv.shape[-1],):
                continue
            ii, inode = g.producer(inner)
            if not _is(inode, _aten.add.Tensor) or not _plain_binary(inode):
                continue
            a, s = inode.args[:2]
            if like_x(a, s):
                yield ({xi, ii, *peeled}, {"x": a, "sub": s, "bias": b_root},
                       x_atom)
    a, b = xnode.args[:2]
    if like_x(a, b):
        yield {xi}, {"x": a, "sub": b}, x_atom


def _stat(g: Graph, stat_at, norm: str, cons: set):
    """The fp32 operand u of the norm statistic, or None: rms is
    ``(u * u).mean(-1, keepdim=True)`` (or ``u.pow(2)``), layer is
    ``u.var(-1, unbiased=False, keepdim=True)`` (``aten.var.correction``
    with correction 0; any other correction is another statistic)."""
    root, peeled = g.peel(stat_at)
    si, snode = g.producer(root)
    if norm == "rms":
        if not _is(snode, _aten.mean.dim):
            return None
        sq = snode.args[0]
        qi, qnode = g.producer(sq)
        if _is(qnode, _aten.mul.Tensor) and qnode.args[0] is qnode.args[1]:
            u = qnode.args[0]
        elif (_is(qnode, _aten.pow.Tensor_Scalar)
              and lit_scalar(qnode.args[1]) == 2.0):
            u = qnode.args[0]
        else:
            return None
        if not _mean_last_axis(g, root, sq, cons):
            return None
        cons.add(qi)
    else:
        if not _is(snode, _aten.var.correction):
            return None
        u = snode.args[0]
        v = _val(u)
        corr = snode.kwargs.get("correction")
        if (v is None or corr is None or lit_scalar(corr) != 0.0
                or not _last_axis(_arg(snode, 1, "dim"), v.dim())
                or not snode.kwargs.get("keepdim", False)):
            return None
        cons.add(si)
    cons.update(peeled)
    return u


def _norm_sites(g: Graph, i, node, norm: str):
    """The rms and layer templates' shared matcher, anchored at rsqrt."""
    if not _is(node, _aten.rsqrt.default):
        return None
    cons = {i}
    ai, anode = g.producer(node.args[0])
    if not _is(anode, _aten.add.Tensor) or not _plain_binary(anode):
        return None
    eps, stat_at = _lit_operand(anode)
    if eps is None or eps <= 0:
        return None
    cons.add(ai)
    u = _stat(g, stat_at, norm, cons)
    uv = _val(u)
    if uv is None or uv.dtype != torch.float32:
        return None

    # u = x cast to fp32 (or x itself when the model runs fp32)
    ci, cnode = g.producer(u)
    x_atom = u
    if (_is(cnode, _aten._to_copy.default) and _val(cnode.args[0]) is not None
            and _val(cnode.args[0]).device == uv.device):
        x_atom = cnode.args[0]
        cons.add(ci)
    xv = _val(x_atom)
    if xv is None:
        return None

    # normalized value: mul(u, rsqrt) for rms, mul(sub(u, mean), rsqrt)
    # for layer
    rvar, rpeel, ni, nnode = g.forward_through(node)
    if not _is(nnode, _aten.mul.Tensor):
        return None
    cons.update(rpeel)
    partner = _other(nnode, rvar)
    if norm == "rms":
        if partner is not u:
            return None
    else:
        si, snode = g.producer(partner)
        if (not _is(snode, _aten.sub.Tensor) or not _plain_binary(snode)
                or snode.args[0] is not u
                or not _mean_last_axis(g, snode.args[1], u, cons)):
            return None
        cons.add(si)
    cons.add(ni)

    tail = _norm_tail(g, nnode, xv.dtype, want_beta=(norm == "layer"),
                      cons=cons)
    if tail is None:
        return None
    gain, beta, y_out = tail

    from ..ops.kernels.fused_norm_epilogue import (
        fused_norm_epilogue, fused_norm_epilogue_supported)

    supported = fused_norm_epilogue_supported(_rows(xv.shape), xv.shape[-1],
                                              xv.dtype)
    resharded = _is_sharded(g, x_atom)

    def mk(extra_cons, named, r_node):
        all_cons = frozenset(cons | extra_cons)
        names = ("x",) + tuple(k for k in ("sub", "bias") if k in named)
        inputs = tuple([named.get("x", x_atom)]
                       + [named[k] for k in names[1:]]
                       + [gain] + ([beta] if beta is not None else []))

        def norm_epilogue_site(*vals, names=names, has_beta=beta is not None,
                               norm=norm, eps=float(eps)):
            kw = dict(zip(names, vals[:len(names)]))
            kw["gain"] = vals[len(names)]
            if has_beta:
                kw["beta"] = vals[len(names) + 1]
            x = kw.pop("x")
            return fused_norm_epilogue(x, norm=norm, eps=eps, **kw)

        binds = (((y_out, 1),) if r_node is None
                 else ((r_node, 0), (y_out, 1)))
        return Site(f"{norm}_epilogue", all_cons, max(all_cons), inputs,
                    binds, norm_epilogue_site,
                    applied=supported and not resharded,
                    note="resharded" if resharded else "")

    cands = [mk(ec, named, rn) for ec, named, rn in _residual_candidates(
        g, x_atom, with_bias=(norm == "layer"))]
    cands.append(mk(set(), {}, None))
    return cands


def match_rms_epilogue(g: Graph, i, node):
    return _norm_sites(g, i, node, "rms")


def match_layer_epilogue(g: Graph, i, node):
    return _norm_sites(g, i, node, "layer")


# ---------------------------------------------------------------------------
# bias + gelu (tanh approximation)
# ---------------------------------------------------------------------------

def match_bias_gelu(g: Graph, i, node):
    """``aten.gelu(add(h, cast(bias[f])), approximate="tanh")``."""
    if (not _is(node, _aten.gelu.default)
            or _arg(node, 1, "approximate", "none") != "tanh"):
        return None
    x_at = node.args[0]
    bi, bnode = g.producer(x_at)
    xv = _val(x_at)
    if not _is(bnode, _aten.add.Tensor) or not _plain_binary(bnode) \
            or xv is None:
        return None
    found = None
    for h_at, b_at in (bnode.args[:2], bnode.args[1::-1]):
        b_root, peeled = g.peel(b_at)
        bv, hv = _val(b_root), _val(h_at)
        if (bv is not None and tuple(bv.shape) == (xv.shape[-1],)
                and hv is not None and hv.shape == xv.shape
                and hv.dtype == xv.dtype):
            found = (h_at, b_root, peeled)
            break
    if found is None:
        return None
    h_at, b_root, peeled = found
    cons = {i, bi, *peeled}

    from ..ops.kernels.fused_bias_act import (fused_bias_act_supported,
                                              fused_bias_gelu)

    supported = fused_bias_act_supported(_rows(xv.shape), xv.shape[-1],
                                         xv.dtype)

    def bias_gelu_site(h, b):
        return (fused_bias_gelu(h, b),)

    return [Site("bias_gelu", frozenset(cons), max(cons), (h_at, b_root),
                 ((node, 0),), bias_gelu_site,
                 applied=supported and not _is_sharded(g, h_at))]


# ---------------------------------------------------------------------------
# RoPE + flash attention
# ---------------------------------------------------------------------------

def _flash_sep_args(g: Graph, node):
    """(q, k, v, o, outs) when ``node`` is the separate-input flash
    operator (ops/kernels/flash_attention.py::flash_attention_raw) on 4-d
    operands, else None: ``o`` is the node of its first output, ``outs``
    the indices of the nodes that take its outputs (o and lse) apart. The
    operator is found by its identity, where the reference compared
    printed jaxprs."""
    if node.op != "call_function" or not str(node.target).startswith(
            "paddle_tpu_torch.flash_fwd_sep."):
        return None
    q, k, v = node.args[:3]
    if any(_val(a) is None or _val(a).dim() != 4 for a in (q, k, v)):
        return None
    outs = {u.args[1]: u for u in node.users if _is(u, operator.getitem)}
    if 0 not in outs or len(outs) != len(node.users):
        return None
    return q, k, v, outs[0], {g.defs[u] for u in outs.values()}


def _half_slice(g: Graph, atom, lo: bool):
    """``atom`` as the low (``lo``) or high half of a split of the last
    axis at d/2 (``aten.split.Tensor`` and its ``getitem``): returns
    (consumed indices, split source) or None."""
    gi, gnode = g.producer(atom)
    if not _is(gnode, operator.getitem) or gnode.args[1] != (0 if lo else 1):
        return None
    si, snode = g.producer(gnode.args[0])
    if not _is(snode, _aten.split.Tensor):
        return None
    src = snode.args[0]
    sv = _val(src)
    if (sv is None or sv.shape[-1] % 2 or snode.args[1] != sv.shape[-1] // 2
            or not _last_axis(_arg(snode, 2, "dim", 0), sv.dim())):
        return None
    return (gi, si), src


def _table_mul(g: Graph, atom, cons: set):
    """Match ``mul(half, table)`` with an fp32 table (possibly arriving
    through casts and views); returns (half, lo, src, table, table_root)
    or None.

    The table's peeled nodes are deliberately NOT consumed: the cos/sin
    tables are computed once and shared by every layer's rope chains, so
    eating their views into one site would leak them to the other layers
    and fail validation. The site reads the mul's direct table operand
    instead."""
    mi, mnode = g.producer(atom)
    if not _is(mnode, _aten.mul.Tensor):
        return None
    for half_at, tab_at in (mnode.args[:2], mnode.args[1::-1]):
        for lo in (True, False):
            hs = _half_slice(g, half_at, lo)
            if hs is None:
                continue
            idx, src = hs
            root, _ = g.peel(tab_at)
            rv = _val(root)
            if rv is None or rv.dtype != torch.float32:
                continue
            cons.update((mi, *idx))
            return half_at, lo, src, tab_at, root
    return None


def _rope_chain(g: Graph, atom):
    """Match the apply_rope lowering producing ``atom``: cat(x1*cos -
    x2*sin, x2*cos + x1*sin) over the fp32 halves of x (cast to fp32 and
    back when x is not fp32). Returns {x, cos, sin, cos_root, sin_root,
    cons} or None."""
    av = _val(atom)
    if av is None:
        return None
    cons: set = set()
    cur = atom
    ci, cnode = g.producer(cur)
    if _is(cnode, _aten._to_copy.default):
        cons.add(ci)
        cur = cnode.args[0]
    ki, knode = g.producer(cur)
    if (not _is(knode, _aten.cat.default) or len(knode.args[0]) != 2
            or not _last_axis(_arg(knode, 1, "dim", 0), av.dim())):
        return None
    cons.add(ki)
    o1, o2 = knode.args[0]
    si, snode = g.producer(o1)
    ai, anode = g.producer(o2)
    if (not _is(snode, _aten.sub.Tensor) or not _plain_binary(snode)
            or not _is(anode, _aten.add.Tensor) or not _plain_binary(anode)):
        return None
    cons.update((si, ai))
    # o1 = x1*cos - x2*sin (operand order fixed by sub)
    m1 = _table_mul(g, snode.args[0], cons)
    m2 = _table_mul(g, snode.args[1], cons)
    if m1 is None or m2 is None or not m1[1] or m2[1]:
        return None
    x1, _, src, cos_at, cos_root = m1
    x2, _, src2, sin_at, sin_root = m2
    if src is not src2:
        return None
    # o2 = x2*cos + x1*sin, either operand order
    m3 = _table_mul(g, anode.args[0], cons)
    m4 = _table_mul(g, anode.args[1], cons)
    if m3 is None or m4 is None:
        return None
    if m3[1]:                       # the low half first: the x1*sin term
        m3, m4 = m4, m3
    if (m3[1] or not m4[1] or m3[0] is not x2 or m4[0] is not x1
            or m3[4] is not cos_root or m4[4] is not sin_root):
        return None
    # src = x cast to fp32 (or x itself when x is fp32)
    sv = _val(src)
    if sv is None or sv.dtype != torch.float32:
        return None
    ei, enode = g.producer(src)
    x_root = src
    if _is(enode, _aten._to_copy.default):
        x_root = enode.args[0]
        cons.add(ei)
    if _val(x_root) is None or _val(x_root).dtype != av.dtype:
        return None
    return {"x": x_root, "cos": cos_at, "sin": sin_at, "cos_root": cos_root,
            "sin_root": sin_root, "cons": cons}


def match_rope_attention(g: Graph, i, node):
    """flash_attention_raw over rotated q (and k): K11 with the rotation
    in the tile. Candidates: both rotations, then q only (k's rotated
    value escapes, as into the prefill's cache, or hides behind the GQA
    repeat), then k only."""
    args = _flash_sep_args(g, node)
    if args is None:
        return None
    q_at, k_at, v_at, o_node, outs = args
    qv = _val(q_at)
    S, d = qv.shape[1], qv.shape[-1]

    def chain(atom):
        c = _rope_chain(g, atom)
        # tables of positions 0..S-1, one row each
        if c is None or any(_val(c[t]).numel() != S * d // 2
                            for t in ("cos", "sin")):
            return None
        return c

    qc, kc = chain(q_at), chain(k_at)
    if qc is not None and kc is not None and (
            qc["cos_root"] is not kc["cos_root"]
            or qc["sin_root"] is not kc["sin_root"]):
        kc = None               # other tables: only the q rotation is ours
    if qc is None and kc is None:
        return None

    from ..ops.kernels.fused_rope_attention import (
        fused_rope_flash_attention, fused_rope_supported)

    supported = fused_rope_supported(tuple(qv.shape), qv.dtype)
    resharded = _is_sharded(g, q_at)
    causal, scale = bool(node.args[3]), float(node.args[4])

    def mk(use_q, use_k):
        chain_q = qc if use_q else None
        chain_k = kc if use_k else None
        tables = chain_q or chain_k
        cons = frozenset({i} | outs
                         | (chain_q["cons"] if chain_q else set())
                         | (chain_k["cons"] if chain_k else set()))
        inputs = (chain_q["x"] if chain_q else q_at,
                  chain_k["x"] if chain_k else k_at,
                  v_at, tables["cos"], tables["sin"])

        def rope_attention_site(q, k, v, cos, sin, rq=use_q, rk=use_k):
            return (fused_rope_flash_attention(q, k, v, cos, sin,
                                               causal=causal,
                                               sm_scale=scale, rope_q=rq,
                                               rope_k=rk),)

        return Site("rope_attention", cons, max(cons), inputs,
                    ((o_node, 0),), rope_attention_site,
                    applied=supported and not resharded,
                    note="resharded" if resharded else "",
                    projections=len(outs))

    cands = [mk(qc is not None, kc is not None)]
    if qc is not None and kc is not None:
        cands += [mk(True, False), mk(False, True)]
    return cands


# ---------------------------------------------------------------------------
# swiglu
# ---------------------------------------------------------------------------

def match_swiglu(g: Graph, i, node):
    """``silu(gate.float()).to(gate.dtype) * up`` (no casts in fp32)."""
    if not _is(node, _aten.silu.default):
        return None
    cons = {i}
    g32 = node.args[0]
    gv = _val(g32)
    if gv is None or gv.dtype != torch.float32:
        return None
    gate_at = g32
    ci, cnode = g.producer(g32)
    if (_is(cnode, _aten._to_copy.default) and _val(cnode.args[0]) is not None
            and _val(cnode.args[0]).device == gv.device):
        gate_at = cnode.args[0]
        cons.add(ci)
    gate_v = _val(gate_at)
    cur = node
    if gate_v.dtype != torch.float32:
        di, dnode = g.sole_consumer(cur)
        if (not _is(dnode, _aten._to_copy.default) or _val(dnode) is None
                or _val(dnode).dtype != gate_v.dtype):
            return None
        cons.add(di)
        cur = dnode
    mi, mnode = g.sole_consumer(cur)
    if not _is(mnode, _aten.mul.Tensor):
        return None
    up_at = _other(mnode, cur)
    up_v = _val(up_at)
    if (up_v is None or up_v.shape != gate_v.shape
            or up_v.dtype != gate_v.dtype):
        return None
    cons.add(mi)

    from ..ops.kernels.fused_bias_act import (fused_bias_act_supported,
                                              fused_swiglu)

    supported = fused_bias_act_supported(_rows(gate_v.shape),
                                         gate_v.shape[-1], gate_v.dtype)

    def swiglu_site(gate, up):
        return (fused_swiglu(gate, up),)

    return [Site("swiglu", frozenset(cons), max(cons), (gate_at, up_at),
                 ((mnode, 0),), swiglu_site,
                 applied=supported and not _is_sharded(g, gate_at))]


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

ALL_TEMPLATES = (
    ("rms_epilogue", match_rms_epilogue),
    ("layer_epilogue", match_layer_epilogue),
    ("rope_attention", match_rope_attention),
    ("bias_gelu", match_bias_gelu),
    ("swiglu", match_swiglu),
)

# kill switch of each template
_SWITCH = {"rms_epilogue": "use_fused_norm_epilogue",
           "layer_epilogue": "use_fused_norm_epilogue",
           "rope_attention": "use_fused_rope_attention",
           "bias_gelu": "use_fused_bias_act",
           "swiglu": "use_fused_bias_act"}


def active_templates():
    """The catalog filtered by the per-template kill switches:
    ``use_fused_norm_epilogue`` disables discovery of the norm templates,
    ``use_fused_rope_attention`` that of ``rope_attention``,
    ``use_fused_bias_act`` that of ``bias_gelu`` and ``swiglu``."""
    return [(name, matcher) for name, matcher in ALL_TEMPLATES
            if name not in _SWITCH or GLOBAL_FLAGS.get(_SWITCH[name])]
