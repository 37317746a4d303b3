"""The pipeline over a mesh's pp axis (port of
paddle_tpu/parallel/pipeline.py).

Each pp rank holds its L / pp slice of the stacked blocks and runs
``stage_fn`` on it; microbatches of B / M rows stream from stage 0 to
stage S-1 through ``distributed.autograd_collectives.ppermute`` (one
exchange a tick in each direction, every rank of the pp group taking
part), and the last stage's output is the model's. The reference keeps
its schedule inside one compiled program; here the host drives it, tick
by tick, and both schedules keep the reference's memory contract: a
stage's forward runs without saving activations, each real stage input
is stashed, and the backward replays the stage from its stash (the
reference's ``_make_1f1b_local`` and GPipe's ``jax.checkpoint``). Every
rank therefore runs its stage's forward twice a microbatch.
"""

from __future__ import annotations

import torch

from ..distributed.autograd_collectives import _send_recv

__all__ = ["pipeline_blocks_fn", "PipelineBlocks", "stage_orders",
           "timeline"]

SCHEDULES = ("1f1b", "gpipe")


def stage_orders(n_stages: int, n_micro: int, stage: int, schedule: str,
                 whole_tail: bool = False) -> list:
    """The order of stage ``stage``'s units, ("F", j) forward and ("B",
    j) backward of microbatch j. "gpipe": every forward, then every
    backward. "1f1b" (Paddle's pipeline_parallel.py:565): S-1-s warm-up
    forwards, then one forward and one backward in turn, then the
    cool-down backwards. A tail that needs the whole batch
    (``whole_tail``) lets no backward start before the last forward:
    both schedules are then gpipe's."""
    S, M = n_stages, n_micro
    if schedule == "gpipe" or whole_tail:
        return [("F", j) for j in range(M)] + [("B", j) for j in range(M)]
    warm = min(S - 1 - stage, M)
    ops = [("F", j) for j in range(warm)]
    for i in range(M - warm):
        ops += [("F", warm + i), ("B", i)]
    return ops + [("B", j) for j in range(M - warm, M)]


def timeline(orders: list, n_micro: int, whole_tail: bool = False) -> list:
    """The ticks of per-stage unit ``orders``: each stage runs its next
    unit at the first tick its input is there (a forward's from the
    stage before, a backward's from the stage after or, on the last
    stage, from the tail, after that stage's forward of the microbatch
    and, with ``whole_tail``, after its last forward). A row holds each
    stage's unit or None. Every rank computes the same table, so the
    pairs of each tick's exchange agree."""
    S = len(orders)
    has_f = any(k == "F" for o in orders for k, _ in o)
    done, pos, rows = {}, [0] * S, []
    while any(pos[s] < len(orders[s]) for s in range(S)):
        t = len(rows)

        def before(key):
            return done.get(key, t) < t

        row = []
        for s in range(S):
            if pos[s] == len(orders[s]):
                row.append(None)
                continue
            kind, j = orders[s][pos[s]]
            if kind == "F":
                ok = s == 0 or before((s - 1, "F", j))
            else:
                ok = not has_f or before((s, "F", j))
                if s < S - 1:
                    ok = ok and before((s + 1, "B", j))
                elif has_f and whole_tail:
                    ok = ok and before((s, "F", n_micro - 1))
            row.append((kind, j) if ok else None)
        for s, unit in enumerate(row):
            if unit:
                done[(s,) + unit] = t
                pos[s] += 1
        rows.append(row)
    return rows


class PipelineBlocks:
    """``blocks_fn(stacked_params, x)`` running the stacked layers as a
    pipeline over ``pp_axis`` (``pipeline_blocks_fn``'s result).

    Called as a function (``__call__``) it is differentiable and
    replicated over pp, as the reference's GSPMD value: every pp rank
    passes its stage's slice of the blocks and the same x [B, ...]
    (stage 0's is used), and gets the last stage's output; the backward
    takes the last stage's output cotangent and gives every rank stage
    0's input cotangent and its own stage's parameter gradients (this
    rank's slice of ``P("pp", ...)``). There the loss after the blocks
    needs every microbatch's output before the first backward, so both
    schedules run every forward first and then the backwards in their
    own order.

    ``run`` drives a whole training step's schedule with a ``tail`` that
    the last stage calls to turn outputs into cotangents: per microbatch
    (``whole_tail=False``, a loss that sums over tokens) the "1f1b"
    schedule interleaves forwards and backwards and a rank stashes at
    most S - s inputs (``peak_stash``), where "gpipe" stashes M.

    The parameter gradients are the same sum over microbatches in both
    schedules; only its order differs (and from the reference's, whose
    backward adds in its own tick order), so they agree to rounding, not
    bit for bit. ``n_stages == 1`` is ``stage_fn(params, x)``.
    """

    def __init__(self, stage_fn, mesh, n_microbatches: int,
                 pp_axis: str = "pp", schedule: str = "1f1b"):
        self.stage_fn, self.mesh, self.schedule = stage_fn, mesh, schedule
        self.n_stages = mesh.shape.get(pp_axis, 1)
        self.n_micro = int(n_microbatches)
        self.pp_axis = pp_axis
        self.peak_stash = 0

    @property
    def schedule(self) -> str:
        """"1f1b" or "gpipe" (``SCHEDULES``); may be set between
        steps."""
        return self._schedule

    @schedule.setter
    def schedule(self, schedule: str) -> None:
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule {schedule!r}: expected one of "
                             f"{SCHEDULES}")
        self._schedule = schedule

    @property
    def stage(self) -> int:
        return self.mesh.axis_index(self.pp_axis)

    @property
    def group(self):
        return self.mesh.group(self.pp_axis)

    def __call__(self, stacked_params, x):
        if self.n_stages == 1:
            return self.stage_fn(stacked_params, x)
        B = x.shape[0]
        if B % self.n_micro:
            raise ValueError(f"batch {B} % microbatches {self.n_micro} "
                             "!= 0")
        leaves, rebuild = _flatten(stacked_params)
        return _Pipeline.apply(self, rebuild, x, *leaves)

    # -- the engine --------------------------------------------------------

    def _replay(self, leaves, rebuild, x, g, want_dx: bool):
        """Stage ``x`` again with the graph kept and its backward from the
        output cotangent ``g``: (dx or None, parameter gradients)."""
        ps = [p.detach().requires_grad_(True) for p in leaves]
        xd = x.detach().requires_grad_(want_dx)
        with torch.enable_grad():
            y = self.stage_fn(rebuild(ps), xd)
            got = torch.autograd.grad(y, ([xd] if want_dx else []) + ps, g,
                                      allow_unused=True)
        if want_dx:
            return got[0], list(got[1:])
        return None, list(got)

    def execute(self, leaves, rebuild, orders, xs=None, tail=None,
                whole_tail: bool = False, stash=None, dys=None,
                want_dx: bool = True, like=None):
        """Run this rank's units of the ``orders`` table. ``xs`` (stage
        0): the M microbatch inputs. ``tail`` (last stage): called with
        (j, y_j), or with every output at once under ``whole_tail``, to
        give the cotangents; or ``dys`` gives them. ``stash`` carries
        the stage inputs of a forward run into its backward. ``like``:
        a tensor shaped and typed as one microbatch's activation.
        Returns (outputs by j (last stage), stage input cotangents by j
        (stage 0), parameter gradients, stash)."""
        S, M, s = self.n_stages, self.n_micro, self.stage
        group = self.group
        stash = {} if stash is None else stash
        dys = {} if dys is None else dys
        inbox_f, inbox_b, outs, dxs = {}, {}, {}, {}
        grads = [None] * len(leaves)
        for t, row in enumerate(timeline(orders, M, whole_tail)):
            unit = row[s]
            send_f = send_b = like
            if unit and unit[0] == "F":
                j = unit[1]
                x = xs[j] if s == 0 else inbox_f.pop(j)
                stash[j] = x
                with torch.no_grad():
                    y = self.stage_fn(rebuild(leaves), x)
                if s == S - 1:
                    outs[j] = y
                else:
                    send_f = y
            elif unit:
                j = unit[1]
                if s < S - 1:
                    g = inbox_b.pop(j)
                else:
                    if j not in dys:
                        if whole_tail:
                            dys.update(enumerate(tail(
                                [outs.pop(i) for i in range(M)])))
                        else:
                            dys[j] = tail(j, outs.pop(j))
                    g = dys.pop(j)
                dx, gp = self._replay(leaves, rebuild, stash.pop(j), g,
                                      want_dx or s > 0)
                for i, gi in enumerate(gp):
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
                if s == 0:
                    dxs[j] = dx
                else:
                    send_b = dx
            self.peak_stash = max(self.peak_stash, len(stash))
            # the tick's exchanges: activations one stage on, then
            # cotangents one stage back (a rank no pair names skips one)
            fwd = [(a, a + 1) for a, u in enumerate(row)
                   if u and u[0] == "F" and a < S - 1]
            if any(s in pair for pair in fwd):
                got = _send_recv(send_f, group, fwd, tag=2 * t)
                if (s - 1, s) in fwd:
                    inbox_f[row[s - 1][1]] = got
            bwd = [(a, a - 1) for a, u in enumerate(row)
                   if u and u[0] == "B" and a > 0]
            if any(s in pair for pair in bwd):
                got = _send_recv(send_b, group, bwd, tag=2 * t + 1)
                if (s + 1, s) in bwd:
                    inbox_b[row[s + 1][1]] = got
        return outs, dxs, grads, stash

    def run(self, stacked_params, xs, tail, whole_tail: bool = False,
            like=None):
        """One training step's pipeline: forwards and backwards in the
        schedule's order (``stage_orders``). ``xs``: stage 0's M
        microbatch inputs (None elsewhere); ``tail``: the last stage's
        cotangent maker (see ``execute``); ``like``: one microbatch's
        activation shape and dtype, on every rank. Returns (stage 0's
        input cotangents in microbatch order, or None; this stage's
        parameter gradients, a tree like ``stacked_params``)."""
        leaves, rebuild = _flatten(stacked_params)
        orders = [stage_orders(self.n_stages, self.n_micro, s,
                               self.schedule, whole_tail)
                  for s in range(self.n_stages)]
        self.peak_stash = 0
        _, dxs, grads, _ = self.execute(leaves, rebuild, orders, xs=xs,
                                        tail=tail, whole_tail=whole_tail,
                                        like=like)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        dx = [dxs[j] for j in range(self.n_micro)] if self.stage == 0 \
            else None
        return dx, rebuild(grads)


class _Pipeline(torch.autograd.Function):
    """``PipelineBlocks.__call__``: every forward, then the backwards."""

    @staticmethod
    def forward(ctx, pipe, rebuild, x, *leaves):
        import torch.distributed as dist

        S, M, s = pipe.n_stages, pipe.n_micro, pipe.stage
        xs = list(x.detach().reshape((M, -1) + tuple(x.shape[1:])))
        like = torch.empty_like(xs[0])
        orders = [[("F", j) for j in range(M)] for _ in range(S)]
        pipe.peak_stash = 0
        outs, _, _, stash = pipe.execute(leaves, rebuild, orders,
                                         xs=xs if s == 0 else None,
                                         like=like)
        y = (torch.cat([outs[j] for j in range(M)]) if s == S - 1
             else torch.empty_like(x))
        dist.broadcast(y, dist.get_global_rank(pipe.group, S - 1),
                       group=pipe.group)
        ctx.pipe, ctx.rebuild, ctx.stash, ctx.like = pipe, rebuild, stash, \
            like
        ctx.save_for_backward(*leaves)
        return y

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed as dist

        pipe = ctx.pipe
        S, M, s = pipe.n_stages, pipe.n_micro, pipe.stage
        leaves = ctx.saved_tensors
        orders = [[("B", j) for j in range(M)] for _ in range(S)]
        dys = None
        if s == S - 1:
            dys = dict(enumerate(dy.reshape((M, -1) + tuple(dy.shape[1:]))))
        want_dx = ctx.needs_input_grad[2]
        _, dxs, grads, _ = pipe.execute(leaves, ctx.rebuild, orders,
                                        stash=ctx.stash, dys=dys,
                                        want_dx=want_dx, like=ctx.like)
        ctx.stash = None
        dx = None
        if want_dx:
            dx = (torch.cat([dxs[j] for j in range(M)]) if s == 0
                  else torch.empty_like(dy))
            dist.broadcast(dx, dist.get_global_rank(pipe.group, 0),
                           group=pipe.group)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (None, None, dx, *grads)


def _flatten(tree):
    """(leaves, rebuild) of a dict of tensors (nested dicts allowed)."""
    if not isinstance(tree, dict):
        return [tree], lambda leaves: leaves[0]
    keys = list(tree)
    parts = [_flatten(tree[k]) for k in keys]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = {}, 0
        for k, (_, fn), n in zip(keys, parts, sizes):
            out[k] = fn(list(leaves[i:i + n]))
            i += n
        return out

    return [x for p in parts for x in p[0]], rebuild


def pipeline_blocks_fn(stage_fn, mesh, n_microbatches: int,
                       pp_axis: str = "pp", schedule: str = "1f1b"):
    """A ``blocks_fn(stacked_params, x)`` running the stacked layers as a
    pipeline over ``pp_axis`` (a ``PipelineBlocks``).
    ``stage_fn(stage_params, x) -> y`` applies one stage's slice of the
    stack; x is the activation [B, T, H] with B divisible by
    ``n_microbatches``; ``schedule`` is "1f1b" (the default) or
    "gpipe"."""
    return PipelineBlocks(stage_fn, mesh, n_microbatches, pp_axis, schedule)
