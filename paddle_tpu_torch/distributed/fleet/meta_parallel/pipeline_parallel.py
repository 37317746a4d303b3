"""The pipeline-parallel runtime: ``PipelineParallel`` (1F1B),
``PipelineParallelWithInterleave`` and ``PipelineParallelZeroBubble``
(the port's copy of paddle_tpu/distributed/fleet/meta_parallel/
pipeline_parallel.py; Paddle's fleet/meta_parallel/pipeline_parallel.py).

The reference drives every stage from one controller and hops an
activation between stage submeshes (``device_put``; across processes a
payload through the coordination service's KV store). Here a stage is a
process, so each rank runs its own stage's schedule, Paddle's
per-stage 1F1B: ``min(pp - s - 1, n)`` warm-up forwards on stage s, then
one-forward-one-backward pairs, then the cool-down backwards; so stage s
holds at most pp - s microbatches' activations (``max_stash`` counts
them). Activations go forward and their gradients back point to point
between pp neighbours (``collective.isend`` / ``recv`` on the hcg's pp
group; staged through pinned host memory on gloo), a small shape and
dtype header ahead of each stream's first tensor of a batch (Paddle's
``SendRecvMeta``), the forward and backward streams on tags of their
own so that the messages of one stream arrive in order. Sends are
posted without waiting and receives wait, so a schedule no neighbour
blocks on cannot deadlock. An activation a stage receives requires
grad, whatever its microbatch input does (the reference's two-process
deadlock, pipeline_parallel.py:148-156), and the gradient of its
floating-point input always goes back.

The loss runs on the last stage only, each microbatch's scaled by 1/n
for backward; ``total_loss`` (their mean) is broadcast over pp at the
end, so every rank returns it. ``train_batch`` then sums the shared
weights' gradients over their owners, and steps the optimizer (dp sync
and the pp-aware clip are ``HybridParallelOptimizer``'s).

``PipelineParallelWithInterleave`` runs Paddle's interleaved 1F1B over
the rank's segments {s, s + pp, ...}; ``PipelineParallelZeroBubble``
runs ZB-H1: the forwards and the B passes with ``WeightGradStore``
enabled, so that ``linear`` / ``matmul`` defer their weight gradients,
and each ``w`` of ``static_scheduler()`` flushing
one microbatch's W. ``schedule_log`` records the order this stage ran.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from ....core import autograd as _autograd
from ....core.autograd import WeightGradStore
from ....core.tensor import Tensor
from ...collective import broadcast, isend, recv
from ...parallel import MetaParallelBase, broadcast_parameters
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave",
           "PipelineParallelZeroBubble"]

FWD_TAG, BWD_TAG = 1, 2
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8)
_HDR = 10                                # ndim, dtype code, up to 8 dims


def _header(t: torch.Tensor) -> torch.Tensor:
    if t.dim() > _HDR - 2:
        raise ValueError(f"pipeline hop: {t.dim()}-d activation (at most "
                         f"{_HDR - 2})")
    h = [t.dim(), _DTYPES.index(t.dtype)] + list(t.shape)
    return torch.tensor(h + [0] * (_HDR - len(h)), dtype=torch.int64,
                        device=t.device)


class _Channel:
    """The point-to-point streams of one stage over the pp group: a
    stream is (peer stage, tag); its first tensor of a batch follows a
    header. ``stats`` counts tensors, bytes and the wall time spent in
    sends and receives (waits included)."""

    def __init__(self, group, device):
        self.group = group
        self.device = device
        self.pending = []
        self.sent, self.meta = set(), {}
        self.stats = {"sends": 0, "recvs": 0, "bytes": 0, "ms": 0.0}

    def begin(self) -> None:
        self.sent.clear()
        self.meta.clear()

    def send(self, t: torch.Tensor, peer: int, tag: int) -> None:
        t0 = time.perf_counter()
        t = t.detach().contiguous()
        if (peer, tag) not in self.sent:
            self.pending.append(isend(_header(t), peer, self.group, tag=tag))
            self.sent.add((peer, tag))
        self.pending.append(isend(t, peer, self.group, tag=tag))
        self.stats["sends"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3

    def recv(self, peer: int, tag: int) -> torch.Tensor:
        t0 = time.perf_counter()
        meta = self.meta.get((peer, tag))
        if meta is None:
            h = torch.empty(_HDR, dtype=torch.int64, device=self.device)
            recv(h, peer, self.group, tag=tag)
            h = h.tolist()
            meta = self.meta[(peer, tag)] = (tuple(h[2:2 + h[0]]),
                                             _DTYPES[h[1]])
        buf = torch.empty(meta[0], dtype=meta[1], device=self.device)
        recv(buf, peer, self.group, tag=tag)
        self.stats["recvs"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3
        return buf

    def drain(self) -> None:
        for task in self.pending:
            task.wait()
        self.pending = []


class PipelineParallel(MetaParallelBase):
    """Paddle's PipelineParallel (reference pipeline_parallel.py:207):
    one rank a stage, per-stage 1F1B."""

    def __init__(self, layers: PipelineLayer, hcg, strategy):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        super().__init__(layers, hcg, strategy)
        pc = getattr(strategy, "pipeline_configs", {}) or {}
        self.accumulate_steps = int(pc.get("accumulate_steps", 1))
        self.micro_batch_size = int(pc.get("micro_batch_size", 1))
        self.num_stages = layers.get_num_stages()
        self.stage_id = layers.stage_id
        self.total_loss = None
        self.schedule_log: list = []
        self.max_stash = 0
        if hcg is not None:
            broadcast_parameters(layers, hcg.get_model_parallel_group(),
                                 distributed_too=False)
            broadcast_parameters(layers, hcg.get_data_parallel_group(),
                                 distributed_too=True)
        layers.broadcast_shared_weights()
        self._chan = None
        if self.num_stages > 1:
            self._chan = _Channel(hcg.get_pipe_parallel_group(),
                                  self._device())

    def _device(self) -> torch.device:
        for p in self._layers.parameters():
            return p._data.device
        from ....core.device import current_device

        return current_device()

    @property
    def p2p_stats(self) -> dict:
        return dict(self._chan.stats) if self._chan is not None else {}

    # -- the schedule ---------------------------------------------------------
    def _tokens(self) -> list:
        """This stage's order: (kind, microbatch, segment) triples."""
        n, S, s = self.accumulate_steps, self.num_stages, self.stage_id
        warmup = min(S - s - 1, n)
        out = [("f", i, s) for i in range(warmup)]
        for i in range(n - warmup):
            out += [("f", warmup + i, s), ("b", i, s)]
        return out + [("b", i, s) for i in range(n - warmup, n)]

    def _forward_scope(self):
        return contextlib.nullcontext()

    def _backward_scope(self):
        return contextlib.nullcontext()

    def _on_cooldown_slot(self, m: int) -> None:
        """A ``w`` of the schedule (the zero-bubble subclass's)."""

    def _finish_schedule(self) -> None:
        """After the last backward, before the step."""

    def _split_micro(self, data):
        if isinstance(data, (tuple, list)):
            return list(zip(*[self._split_micro(d) for d in data]))
        n = self.accumulate_steps
        if not isinstance(data, Tensor):
            data = Tensor(torch.as_tensor(data, device=self._device()))
        b = data.shape[0]
        if b % n != 0:
            raise ValueError(f"batch {b} not divisible by accumulate_steps "
                             f"{n}")
        k = b // n
        return [Tensor(data._data[i * k:(i + 1) * k],
                       stop_gradient=data.stop_gradient) for i in range(n)]

    def _micro(self, data, compute_loss: bool = True):
        inputs, labels = data if isinstance(data, tuple) and \
            len(data) == 2 else (data, None)
        mi = self._split_micro(inputs)
        ml = self._split_micro(labels) if labels is not None and \
            compute_loss else [None] * self.accumulate_steps
        return mi, ml

    def _backward_step(self, loss, scaler, n):
        scaled = loss.scale(1.0 / n)
        if scaler is not None:
            scaler.scale(scaled).backward()
        else:
            scaled.backward()

    def _forward(self, m, g, mi, ml, stash):
        L = self._layers
        last = g == L.num_segments - 1
        if g == 0:
            x = mi[m]
        else:
            buf = self._chan.recv(L.segment_stage(g - 1), FWD_TAG)
            if buf.is_floating_point():
                buf.requires_grad_()
            x = Tensor(buf, stop_gradient=not buf.requires_grad)
        with self._forward_scope():
            y = L.forward_segment(x, g)
            if last and L._loss_fn is not None and ml[m] is not None:
                y = L._loss_fn(y, ml[m])
        if not last:
            self._chan.send(y._data, L.segment_stage(g + 1), FWD_TAG)
        if stash is not None:
            stash[(m, g)] = (x, y)
            self.max_stash = max(self.max_stash, len(stash))
        return y

    def _backward(self, m, g, stash, scaler, losses):
        L = self._layers
        x, y = stash.pop((m, g))
        with self._backward_scope():
            if g == L.num_segments - 1:
                self._backward_step(y, scaler, self.accumulate_steps)
                losses.append(y._data.detach())
            else:
                cot = self._chan.recv(L.segment_stage(g + 1), BWD_TAG)
                if y._data.requires_grad:
                    torch.autograd.backward(y._data, cot)
        if g > 0 and x._data.is_floating_point():
            gx = x._data.grad
            if gx is None:
                gx = torch.zeros_like(x._data)
            self._chan.send(gx, L.segment_stage(g - 1), BWD_TAG)

    def _broadcast_from_last(self, t: Optional[torch.Tensor]):
        """``t`` of the last stage on every rank of the pp group."""
        if self.num_stages == 1:
            return t
        group, last = self._chan.group, self.num_stages - 1
        if self.stage_id == last:
            h = _header(t)
        else:
            h = torch.empty(_HDR, dtype=torch.int64, device=self._device())
        broadcast(h, src=last, group=group)
        if self.stage_id != last:
            h = h.tolist()
            t = torch.empty(tuple(h[2:2 + h[0]]), dtype=_DTYPES[h[1]],
                            device=self._device())
        t = t.contiguous()
        broadcast(t, src=last, group=group)
        return t

    def forward_backward_pipeline(self, data, scaler=None):
        """Run this stage's schedule over the batch's microbatches;
        returns the mean loss on every rank."""
        mi, ml = self._micro(data)
        if self._chan is not None:
            self._chan.begin()
        stash, losses = {}, []
        self.schedule_log = []
        try:
            for kind, m, g in self._tokens():
                self.schedule_log.append(f"{kind}{m}")
                if kind == "f":
                    self._forward(m, g, mi, ml, stash)
                elif kind == "b":
                    self._backward(m, g, stash, scaler, losses)
                else:
                    self._on_cooldown_slot(m)
            self._finish_schedule()
        finally:
            if self._chan is not None:
                self._chan.drain()
        total = None
        if losses:
            total = torch.stack([v.float().reshape(()) for v in losses]
                                ).mean()
        total = self._broadcast_from_last(total)
        self.total_loss = Tensor(total) if total is not None else None
        return self.total_loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference :365: the schedule, the shared weights' gradients
        summed over their owners, then one optimizer step."""
        loss = self.forward_backward_pipeline(data, scaler=scaler)
        self._layers.allreduce_shared_weight_gradients()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss: bool = True):
        """Forwards only, microbatch by microbatch through this rank's
        segments; the mean loss (``compute_loss``) or the last
        segment's outputs, on every rank."""
        L = self._layers
        mi, ml = self._micro(data, compute_loss)
        if self._chan is not None:
            self._chan.begin()
        outs = []
        try:
            with _autograd.no_grad():
                for m in range(self.accumulate_steps):
                    for g in L.own_segments():
                        y = self._forward(m, g, mi, ml, None)
                        if g == L.num_segments - 1:
                            outs.append(y._data)
        finally:
            if self._chan is not None:
                self._chan.drain()
        if compute_loss:
            total = torch.stack([o.float().reshape(()) for o in outs]
                                ).mean() if outs else None
            return Tensor(self._broadcast_from_last(total))
        if self.num_stages == 1:
            return [Tensor(o) for o in outs]
        return [Tensor(self._broadcast_from_last(
            outs[m] if outs else None)) for m in range(self.accumulate_steps)]


class PipelineParallelZeroBubble(PipelineParallel):
    """ZB-H1 (reference pipeline_parallel.py:421): the backward split
    into B, the activation gradients on the critical path, and W, the
    weight gradients (``WeightGradStore``), each cool-down slot filled
    with one microbatch's W and the rest flushed before the step. A
    failed batch leaves no thunk behind."""

    def __init__(self, layers: PipelineLayer, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        if layers._num_virtual > 1:
            raise ValueError("PipelineParallelZeroBubble runs a "
                             "PipelineLayer of one segment a stage "
                             "(num_virtual_pipeline_stages 1)")

    def _tokens(self) -> list:
        s = self.stage_id
        return [(t[0], int(t[1:]), s)
                for t in self.static_scheduler()[s].split(";")]

    @contextlib.contextmanager
    def _forward_scope(self):
        # the split ops go on the tape, and defer, while the store is on
        WeightGradStore.enable()
        try:
            yield
        finally:
            WeightGradStore.disable()

    @contextlib.contextmanager
    def _backward_scope(self):
        before = WeightGradStore.size()
        with self._forward_scope():
            yield
        self._b_thunks.append(WeightGradStore.size() - before)
        self.deferred += self._b_thunks[-1]

    def _on_cooldown_slot(self, m: int) -> None:
        WeightGradStore.flush(limit=self._b_thunks.pop(0))

    def _finish_schedule(self) -> None:
        WeightGradStore.flush()

    def forward_backward_pipeline(self, data, scaler=None):
        # stale thunks of a failed batch must not reach this one's grads
        WeightGradStore.clear()
        self._b_thunks = []
        self.deferred = 0
        try:
            return super().forward_backward_pipeline(data, scaler=scaler)
        except BaseException:
            WeightGradStore.clear()
            raise

    def static_scheduler(self):
        """The per-stage ZB-H1 order as strings, without running
        (reference: 'f0;f1;b0;...', the W passes as w's)."""
        n = self.accumulate_steps
        S = self.num_stages
        out = []
        for stage in range(S):
            warmup = min(S - stage - 1, n)
            steps = []
            fwd = bwd = w = 0
            for _ in range(warmup):
                steps.append(f"f{fwd}")
                fwd += 1
            while fwd < n:
                steps.append(f"f{fwd}")
                fwd += 1
                steps.append(f"b{bwd}")
                bwd += 1
            while bwd < n:
                steps.append(f"b{bwd}")
                bwd += 1
                if w < bwd - 1:  # fill the freed slot with a deferred W
                    steps.append(f"w{w}")
                    w += 1
            while w < n:
                steps.append(f"w{w}")
                w += 1
            out.append(";".join(steps))
        return out


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved (virtual) pipeline (reference pipeline_parallel.py:505;
    Paddle's PipelineParallelWithInterleave): stage s owns segments s,
    s + pp, ...; Paddle's interleaved 1F1B over them, microbatches taken
    pp at a time, so ``accumulate_steps`` must be a multiple of pp."""

    def __init__(self, layers: PipelineLayer, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        if layers._num_virtual <= 1 or self.num_stages == 1:
            raise ValueError(
                "PipelineParallelWithInterleave needs a PipelineLayer built "
                "with num_virtual_pipeline_stages > 1 over pp > 1")
        if self.accumulate_steps % self.num_stages:
            raise ValueError(
                f"the interleaved schedule takes microbatches pp at a time "
                f"(as Paddle's): accumulate_steps {self.accumulate_steps} "
                f"is not a multiple of pp {self.num_stages}")

    def _tokens(self) -> list:
        n, S, s = self.accumulate_steps, self.num_stages, self.stage_id
        V = self._layers._num_virtual
        total = n * V
        warmup = min((S - s - 1) * 2 + (V - 1) * S, total)

        def tok(kind, k):
            c = (k % (S * V)) // S
            if kind == "b":
                c = V - 1 - c
            return (kind, (k // (S * V)) * S + k % S, c * S + s)

        out = [tok("f", k) for k in range(warmup)]
        for k in range(total - warmup):
            out += [tok("f", warmup + k), tok("b", k)]
        return out + [tok("b", k) for k in range(total - warmup, total)]
