"""Fusion pass over a traced aten graph: plan, validate, rewrite.

Port of paddle_tpu/compiler/fusion_pass.py from jaxprs to torch.fx
graphs. ``plan_graph`` walks the nodes of a graph that
``torch.fx.experimental.proxy_tensor.make_fx`` traced (aten ops with
concrete shapes in ``node.meta["val"]``) and asks every catalog template
(catalog.py) whether it recognizes a fusable chain anchored at each
node. Matches become :class:`Site` records: the nodes the fused call
replaces, the values it reads, the nodes it re-binds and a ``build``
callable that calls the fused function. A generic validator then proves
each site safe independently of how the matcher was written: every
replaced node's value is either re-bound by the fused call or consumed
only inside the site, and every re-bound value's other users run after
the site. A matcher bug can cost a fusion, never correctness.

``rewrite`` applies a plan to its GraphModule: the fused call goes in at
the trigger (the site's last node), the re-bound nodes' users read its
outputs, the replaced nodes are erased, then ``graph.lint()`` and
``recompile()``.

Nested programs stand in for the reference's recursion into ``remat2``
and ``scan`` bodies: ``nested_program`` is a registered operator that a
trace records as one node (see ``compiler.remat_call``); its body is
traced and planned on its own, and the rewrite runs the fused body under
``torch.utils.checkpoint`` with the program's remat policy, so it is
recomputed in the backward except what the policy saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import operator
import re
from typing import Any, Callable, Sequence

import torch
import torch.fx
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["Graph", "Site", "Plan", "plan_graph", "rewrite",
           "program_hash", "lit_scalar", "NESTED"]

_aten = torch.ops.aten
# single-operand casts and views a chain may pass through
_TRANSPARENT = (_aten._to_copy, _aten.view, _aten._unsafe_view,
                _aten.expand, _aten.unsqueeze)


def _packet(node):
    t = getattr(node, "target", None)
    return getattr(t, "overloadpacket", None)


# ---------------------------------------------------------------------------
# graph view
# ---------------------------------------------------------------------------

class Graph:
    """Def/use index over one fx graph, with the walk helpers the catalog
    matchers share. Nodes are numbered in program order."""

    def __init__(self, graph: torch.fx.Graph):
        self.graph = graph
        self.nodes = list(graph.nodes)
        self.defs = {n: i for i, n in enumerate(self.nodes)}
        self.uses = {n: sorted(self.defs[u] for u in n.users)
                     for n in self.nodes}
        out = [n for n in self.nodes if n.op == "output"]
        self.outvars = ({a for a in tree_flatten(out[0].args)[0]
                         if isinstance(a, torch.fx.Node)} if out else set())

    def producer(self, atom):
        """(index, node) of the op computing ``atom``, or (None, None)
        for placeholders, attributes and literals."""
        if isinstance(atom, torch.fx.Node) and atom.op == "call_function":
            return self.defs[atom], atom
        return None, None

    def peel(self, atom, prims: Sequence = _TRANSPARENT):
        """Walk backward through single-operand casts and views; returns
        (root_atom, peeled_indices)."""
        peeled: list[int] = []
        while True:
            i, node = self.producer(atom)
            if (node is None or _packet(node) not in prims
                    or len(node.all_input_nodes) != 1):
                return atom, peeled
            peeled.append(i)
            atom = node.all_input_nodes[0]

    def consumers(self, var) -> list[int]:
        return self.uses.get(var, [])

    def sole_consumer(self, var):
        """(index, node) when exactly one node uses ``var`` (possibly as
        several operands) and it is not a graph output; else
        (None, None)."""
        if (not isinstance(var, torch.fx.Node) or len(var.users) != 1
                or var in self.outvars):
            return None, None
        (user,) = var.users
        return self.defs[user], user

    def forward_through(self, var, prims: Sequence = _TRANSPARENT):
        """Walk forward through solely consumed casts and views; returns
        (last_var, peeled_indices, consumer_index, consumer) with the
        first other sole consumer."""
        peeled: list[int] = []
        while True:
            i, node = self.sole_consumer(var)
            if node is None:
                return var, peeled, None, None
            if node.op == "call_function" and _packet(node) in prims \
                    and len(node.all_input_nodes) == 1:
                peeled.append(i)
                var = node
                continue
            return var, peeled, i, node


def lit_scalar(atom):
    """Python float of a scalar literal operand, else None."""
    if isinstance(atom, (int, float)) and not isinstance(atom, bool):
        return float(atom)
    return None


# ---------------------------------------------------------------------------
# sites and plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    """One planned rewrite: replace the ``consumed`` nodes with a call to
    ``build`` at the position of node ``trigger``."""
    template: str
    consumed: frozenset
    trigger: int
    inputs: tuple                 # nodes or literals the build reads
    out_binds: tuple              # ((node, build-output index), ...)
    build: Callable[..., Sequence]
    applied: bool = True          # the fused function's gate at plan time
    note: str = ""
    projections: int = 0          # getitem nodes among ``consumed``: the
                                  # outputs of a multi-output operator
                                  # taken apart, no equations of their own


@dataclasses.dataclass
class Plan:
    sites: list                   # all discovered Sites (applied or not)
    nested: dict                  # node index -> Plan of a nested program
    errors: list

    def applied_sites(self):
        return [s for s in self.sites if s.applied]

    def empty(self) -> bool:
        """True when nothing anywhere in the plan tree is applied."""
        return (not self.applied_sites()
                and all(p.empty() for p in self.nested.values()))

    def walk(self):
        """Every site of this plan and of its nested plans, each nested
        program once per node that calls it."""
        yield from self.sites
        for p in self.nested.values():
            yield from p.walk()

    def walk_errors(self):
        yield from self.errors
        for p in self.nested.values():
            yield from p.walk_errors()

    def summary(self) -> list:
        """JSON-able record of the fusion decisions."""
        return sorted(
            ({"template": s.template, "applied": bool(s.applied),
              "eqns": len(s.consumed) - s.projections, "note": s.note}
             for s in self.walk()),
            key=lambda d: (d["template"], -d["applied"], d["eqns"]))


def _validate(g: Graph, site: Site) -> bool:
    """Prove the rewrite safe: replaced nodes' values must be re-bound by
    the fused call or used only inside the site, re-bound values' other
    users must run after the trigger, and inputs come from outside."""
    cons = set(site.consumed)
    if not cons or site.trigger != max(cons):
        return False
    bound = {v for v, _ in site.out_binds}
    produced = set()
    for i in cons:
        if i < 0 or i >= len(g.nodes) or g.nodes[i].op != "call_function":
            return False
        v = g.nodes[i]
        produced.add(v)
        if v in bound:
            if any(u <= site.trigger and u not in cons
                   for u in g.consumers(v)):
                return False
            continue
        if v in g.outvars:
            return False
        if any(u not in cons for u in g.consumers(v)):
            return False
    if not all(v in produced for v, _ in site.out_binds):
        return False
    for a in site.inputs:
        if isinstance(a, torch.fx.Node) and g.defs.get(a) in cons:
            return False
    return True


# ---------------------------------------------------------------------------
# nested programs (the counterpart of remat2 bodies)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Nested:
    """A program traced apart from its caller: ``fn`` over the pytree
    ``in_spec`` of tensors shaped like ``metas``, checkpointed with the
    remat ``policy`` (compiler.REMAT_POLICIES, or None); ``gm`` and
    ``plan`` once traced."""
    fn: Callable
    in_spec: Any
    metas: list
    policy: Any = None
    out_spec: Any = None
    gm: Any = None
    plan: Any = None


NESTED: dict[int, Nested] = {}


def _run_nested(args, pid: int):
    n = NESTED[pid]
    out = n.fn(*tree_unflatten(list(args), n.in_spec))
    flat, n.out_spec = tree_flatten(out)
    return flat


@torch.library.custom_op("paddle_tpu_torch::nested_program",
                         mutates_args=())
def nested_program(args: list[torch.Tensor], pid: int) -> list[torch.Tensor]:
    """One node of a trace for a whole nested program; the rewrite
    replaces it with the fused body under checkpoint."""
    return [t.clone() for t in _run_nested(args, pid)]


@nested_program.register_fake
def _(args, pid):
    # runs the body on the fake inputs for its output shapes (and its
    # output tree); nothing of it is recorded in the caller's trace
    return [t.clone() for t in _run_nested(args, pid)]


def _remat_runner(gm, policy):
    from . import checkpointed

    def run_remat(args, pid):
        return list(checkpointed(gm, args, policy))
    return run_remat


def _is_nested(node) -> bool:
    return (node.op == "call_function"
            and node.target is torch.ops.paddle_tpu_torch.nested_program
            .default)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_graph(graph: torch.fx.Graph) -> Plan:
    from . import catalog

    templates = catalog.active_templates()
    g = Graph(graph)
    found: list[Site] = []
    errors: list[str] = []
    for i, node in enumerate(g.nodes):
        if node.op != "call_function":
            continue
        for name, matcher in templates:
            try:
                cands = matcher(g, i, node)
            except Exception as e:  # noqa: BLE001 -- a matcher bug must
                # cost the fusion, never the model; surfaced in the report
                errors.append(f"{name}@{i}: {type(e).__name__}: {e}")
                cands = None
            if not cands:
                continue
            for s in cands:
                if _validate(g, s):
                    found.append(s)
                    break
            else:
                found.append(dataclasses.replace(
                    cands[0], applied=False,
                    note=cands[0].note or "unsafe"))
            break
    # de-overlap in program order: the first valid site wins its nodes
    sites, taken = [], set()
    for s in sorted(found, key=lambda s: s.trigger):
        if s.applied and (s.consumed & taken):
            s = dataclasses.replace(s, applied=False, note="overlap")
        if s.applied:
            taken |= s.consumed
        sites.append(s)
    nested = {i: NESTED[node.args[1]].plan
              for i, node in enumerate(g.nodes)
              if _is_nested(node) and i not in taken}
    return Plan(sites, nested, errors)


# ---------------------------------------------------------------------------
# rewrite
# ---------------------------------------------------------------------------

def rewrite(gm: torch.fx.GraphModule, plan: Plan) -> torch.fx.GraphModule:
    """Apply ``plan`` (made from ``gm.graph``) to ``gm`` in place."""
    graph = gm.graph
    nodes = list(graph.nodes)
    remap: dict = {}

    def resolve(a):
        while isinstance(a, torch.fx.Node) and a in remap:
            a = remap[a]
        return a

    for s in sorted(plan.applied_sites(), key=lambda s: s.trigger):
        trig = nodes[s.trigger]
        with graph.inserting_before(trig):
            call = graph.call_function(s.build,
                                       tuple(resolve(a) for a in s.inputs))
            for v, oi in s.out_binds:
                get = graph.call_function(operator.getitem, (call, oi))
                v.replace_all_uses_with(get)
                remap[v] = get
        for i in sorted(s.consumed, reverse=True):
            graph.erase_node(nodes[i])
    for i in plan.nested:
        node = nodes[i]
        n = NESTED[node.args[1]]
        node.target = _remat_runner(n.gm, n.policy)
    graph.lint()
    gm.recompile()
    return gm


# ---------------------------------------------------------------------------
# program identity
# ---------------------------------------------------------------------------

def program_hash(gm: torch.fx.GraphModule) -> str:
    """Stable hash of a traced program: sha1 over its generated code with
    object addresses stripped, first 16 hex digits."""
    s = re.sub(r"0x[0-9a-fA-F]+", "0x", gm.code)
    return hashlib.sha1(s.encode()).hexdigest()[:16]
