"""Pipeline layer partitioning: ``LayerDesc``, ``SharedLayerDesc``,
``SegmentLayers`` and ``PipelineLayer`` (the port's copy of
paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py; Paddle's
fleet/meta_parallel/parallel_layers/pp_layers.py).

The reference builds every stage in one controller and places each
stage's parameters on its pp submesh. Here a stage is a process: every
rank keeps the same segment metadata (``segment_parts``, the owner of
each segment ``segment_stage(g) = g % pp``), and builds only the layers
of its own segments, named as the reference names them (``stage{s}_{k}``,
k counting the stage's layer descs in model order). So the reference's
``state_dict`` is the union of the ranks' (the stage-rank
correspondence rule), a shared layer's entries under the name of its
first registration, as the reference's state lists a shared parameter
once (``shared_aliases`` maps a later stage's names to it).

A ``SharedLayerDesc`` layer (tied embeddings) is built on every stage
that uses it; its weight is broadcast from its first owner when the
pipeline wraps the layer (``PipelineParallel``), and its gradient summed
over its owners before the step (``allreduce_shared_weight_gradients``,
Paddle's pipeline_parallel.py): the reference's XLA sums it for free.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from ....nn.layer.layers import Layer
from ...topology import get_hybrid_communicate_group

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:33)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer) and not callable(layer_func):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self) -> Layer:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        name = getattr(self.layer_func, "__name__", self.layer_func)
        return f"LayerDesc({name})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages, e.g. tied embeddings (reference
    pp_layers.py:50)."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Partition N layer descs into num_parts stages (reference
    pp_layers.py:62): uniform by count, by named-layer boundaries
    (``"layer:<regex>"``), or a user-provided list of boundaries."""

    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self._layers_desc = layers_desc
        self.method = method
        self.num_parts = num_parts
        self.num_items = len(layers_desc)
        if num_virtual_pipeline_stage:
            self.total_parts = num_parts * num_virtual_pipeline_stage
        else:
            self.total_parts = num_parts
        if self.num_items < self.total_parts:
            raise ValueError("layer number should be greater than number of "
                             "segments")

    def do_segment(self) -> list[int]:
        if isinstance(self.method, list):
            seg = list(self.method)
            if seg[0] != 0:
                seg.insert(0, 0)
            if seg[-1] != self.num_items:
                seg.append(self.num_items)
            return seg
        if self.method == "uniform":
            return self.uniform(self.num_items, self.total_parts)
        if self.method.startswith("layer:"):
            # each segment an equal share of the named layers
            name = self.method.split(":", 1)[1]
            weights = [0] * self.num_items
            for i, d in enumerate(self._layers_desc):
                layer_name = (d.layer_func.__name__
                              if isinstance(d, LayerDesc) else
                              d.__class__.__name__)
                if re.search(name, layer_name):
                    weights[i] = 1
            total = sum(weights)
            if total % self.total_parts != 0 and total < self.total_parts:
                raise ValueError(f"only {total} '{name}' layers for "
                                 f"{self.total_parts} segments")
            result = [0] * (self.total_parts + 1)
            memory_counter, seg_idx = 0, 1
            target = total / self.total_parts
            for i, w in enumerate(weights):
                memory_counter += w
                if memory_counter >= target * seg_idx - 1e-6 and w:
                    result[seg_idx] = i + 1
                    seg_idx += 1
                    if seg_idx == self.total_parts:
                        break
            result[self.total_parts] = self.num_items
            for i in range(1, self.total_parts + 1):
                if result[i] == 0:
                    result[i] = result[i - 1]
            return result
        raise ValueError(f"unknown seg method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts) -> list[int]:
        result = [0] * (num_parts + 1)
        part_size = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


class _SharedFwd(Layer):
    """A shared layer called through its desc's ``forward_func``."""

    def __init__(self, inner, fn):
        super().__init__()
        self.inner = inner
        self._fn = fn

    def forward(self, x):
        return self._fn(self.inner, x)


class PipelineLayer(Layer):
    """A model given as a list of layer descs, cut into ``num_stages`` x
    V segments (reference pp_layers.py:133); this rank builds the layers
    of the segments its stage owns (every one at pp 1). ``loss_fn`` is
    applied by the pipeline runtime after the last segment."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval: int = 0, num_virtual_pipeline_stages=None,
                 hcg=None):
        super().__init__()
        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._hcg = hcg or get_hybrid_communicate_group()
        if num_stages is None:
            if self._hcg is None:
                raise ValueError("num_stages or an initialized hybrid "
                                 "topology is required")
            num_stages = self._hcg.get_pipe_parallel_world_size()
        self._num_stages = int(num_stages)
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        if self._num_stages > 1:
            if self._hcg is None or \
                    self._hcg.get_pipe_parallel_world_size() != \
                    self._num_stages:
                raise ValueError(
                    f"a PipelineLayer of {self._num_stages} stages needs a "
                    f"hybrid topology of pp {self._num_stages} (one rank a "
                    "stage): fleet.init with pp_degree")
            self._stage_id = self._hcg.get_stage_id()
        else:
            self._stage_id = 0

        seg = SegmentLayers(
            self._layers_desc, self._num_stages, method=seg_method,
            num_virtual_pipeline_stage=(self._num_virtual
                                        if self._num_virtual > 1 else None))
        self.segment_parts = seg.do_segment()
        n_segments = self._num_stages * self._num_virtual
        if len(self.segment_parts) != n_segments + 1:
            raise ValueError(
                f"segmentation produced {len(self.segment_parts) - 1} "
                f"segments but pp({self._num_stages}) x "
                f"virtual({self._num_virtual}) = {n_segments} are required "
                "(a seg_method list must carry pp*V boundaries)")
        self._segment_stage = [g % self._num_stages
                               for g in range(n_segments)]
        self._shared_layers: dict = {}
        self._built_by_index: dict = {}
        self.run_function: list = []
        names = self._global_names()
        for i in self._owned_indices(self._stage_id):
            desc = self._layers_desc[i]
            if isinstance(desc, SharedLayerDesc):
                key = desc.layer_name
                if key not in self._shared_layers:
                    self._shared_layers[key] = desc.build_layer()
                lyr = self._shared_layers[key]
                if desc.forward_func is not None:
                    lyr = _SharedFwd(lyr, desc.forward_func)
            elif isinstance(desc, LayerDesc):
                lyr = desc.build_layer()
            elif isinstance(desc, Layer):
                lyr = desc
            elif callable(desc):
                # plain functions (e.g. reshape lambdas) are allowed
                self.run_function.append(desc)
                self._built_by_index[i] = desc
                continue
            else:
                raise TypeError(f"bad layer desc {desc!r}")
            self.add_sublayer(names[i], lyr)
            self.run_function.append(lyr)
            self._built_by_index[i] = lyr
        self._shared_meta = self._shared_owners(names)
        for key, (owners, _, _) in self._shared_meta.items():
            if key in self._shared_layers and \
                    owners[0] != self._stage_id:
                w = getattr(self._shared_layers[key],
                            self._shared_attr(key))
                w.is_firstly_shared = False
        self._shared_groups: dict = {}

    # -- metadata every rank keeps ------------------------------------------
    def _owned_indices(self, s: int) -> list:
        return [i for g in range(self.num_segments)
                if self._segment_stage[g] == s
                for i in range(self.segment_parts[g],
                               self.segment_parts[g + 1])]

    def _global_names(self) -> dict:
        """{desc index: sublayer name} as the reference registers them
        (``stage{s}_{k}``, k the index among stage s's descs)."""
        out = {}
        for s in range(self._num_stages):
            for k, i in enumerate(self._owned_indices(s)):
                out[i] = f"stage{s}_{k}"
        return out

    def _shared_attr(self, key: str) -> str:
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc) and d.layer_name == key:
                return d.shared_weight_attr
        raise KeyError(key)

    def _shared_owners(self, names: dict) -> dict:
        """{key: (owner stages ascending, the reference's prefix of the
        shared layer, this rank's prefixes of it)}."""
        meta = {}
        for s in range(self._num_stages):
            for i in self._owned_indices(s):
                d = self._layers_desc[i]
                if not isinstance(d, SharedLayerDesc):
                    continue
                prefix = names[i] + (".inner" if d.forward_func is not None
                                     else "")
                owners, first, mine = meta.setdefault(
                    d.layer_name, ([], prefix, []))
                if s not in owners:
                    owners.append(s)
                if s == self._stage_id:
                    mine.append(prefix)
        return meta

    def shared_aliases(self) -> dict:
        """{this rank's prefix of a shared layer: the reference's} for
        every prefix that differs (a later owner's, or a second use on
        one stage)."""
        out = {}
        for _, first, mine in self._shared_meta.values():
            for p in mine:
                if p != first:
                    out[p] = first
        return out

    # -- shared weights across stages ---------------------------------------
    def _shared_group(self, key: str):
        """The process group of ``key``'s owner stages through this rank
        (None: one owner), made on first use by every rank."""
        if key not in self._shared_groups:
            owners = self._shared_meta[key][0]
            pg = None
            if len(owners) > 1:
                import torch.distributed as dist

                pp = self._hcg.get_pipe_parallel_group()
                if len(owners) == self._num_stages:
                    pg = pp.process_group
                else:
                    rows = [[int(r) for r in np.asarray(row)[owners]]
                            for row in pp._members()]
                    pg, _ = dist.new_subgroups_by_enumeration(rows)
            self._shared_groups[key] = pg
        return self._shared_groups[key]

    def _shared_weights(self):
        """(key, weight, group) of the shared layers with more than one
        owner stage; every rank walks the keys in one order."""
        for key in sorted(self._shared_meta):
            pg = self._shared_group(key)
            if pg is None or key not in self._shared_layers:
                continue
            yield key, getattr(self._shared_layers[key],
                               self._shared_attr(key)), pg

    def broadcast_shared_weights(self) -> None:
        """Every shared weight from its first owner stage (Paddle's
        ``_synchronize_shared_weights``)."""
        import torch
        import torch.distributed as dist

        for key, w, pg in self._shared_weights():
            src = dist.get_global_rank(pg, 0)
            with torch.no_grad():
                dist.broadcast(w._data, src=src, group=pg)

    def allreduce_shared_weight_gradients(self) -> None:
        """Sum each shared weight's gradient over its owner stages
        (Paddle's pipeline_parallel.py ``allreduce_shared_weight_
        gradients``)."""
        import torch.distributed as dist

        for key, w, pg in self._shared_weights():
            g = w._data.grad
            if g is not None:
                dist.all_reduce(g, group=pg)

    # -- info ---------------------------------------------------------------
    def get_num_stages(self) -> int:
        return self._num_stages

    def get_stage_from_index(self, layer_idx: int) -> int:
        """The stage owning model-order layer ``layer_idx`` (interleave:
        its segment's stage, g % pp)."""
        for g in range(self.num_segments):
            if self.segment_parts[g] <= layer_idx < self.segment_parts[g + 1]:
                return self._segment_stage[g]
        raise ValueError(layer_idx)

    @property
    def num_segments(self) -> int:
        return self._num_stages * self._num_virtual

    def segment_stage(self, g: int) -> int:
        """The stage owning segment g (g % pp)."""
        return self._segment_stage[g]

    @property
    def stage_id(self) -> int:
        return self._stage_id

    def own_segments(self) -> list:
        return [g for g in range(self.num_segments)
                if self._segment_stage[g] == self._stage_id]

    def forward_segment(self, x, g: int):
        """Run segment g's layers (model order); g must be this rank's."""
        if self._segment_stage[g] != self._stage_id:
            raise ValueError(f"segment {g} runs on stage "
                             f"{self._segment_stage[g]}, this rank is stage "
                             f"{self._stage_id}")
        for i in range(self.segment_parts[g], self.segment_parts[g + 1]):
            x = self._built_by_index[i](x)
        return x

    def forward(self, x):
        """The whole model in one process (pp 1); a pipeline of several
        stages runs through ``PipelineParallel.train_batch`` /
        ``eval_batch``."""
        if self._num_stages > 1:
            raise RuntimeError(
                f"a PipelineLayer of {self._num_stages} stages holds this "
                "rank's segments only: run it through "
                "PipelineParallel.train_batch / eval_batch "
                "(fleet.distributed_model)")
        for g in range(self.num_segments):
            x = self.forward_segment(x, g)
        return x
