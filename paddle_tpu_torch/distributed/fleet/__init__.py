"""Fleet: the hybrid-parallel user facade (the port's copy of
paddle_tpu/distributed/fleet/__init__.py; reference fleet.py:151
``init``, model.py:32 ``distributed_model``,
base/distributed_strategy.py:284), and elastic supervision of training
processes (``elastic.py``).

``fleet.init(strategy)`` joins the launcher's world and lays the hybrid
topology over it; ``distributed_model`` wraps by parallel mode
(``DataParallel``, ``TensorParallel``, ``SegmentParallel``) as
model.py:142-180 dispatches; ``distributed_optimizer`` wraps in
``HybridParallelOptimizer``. Pipeline mode, and a zero-bubble
``schedule_mode``, are refused: their Layers (``pp_layers.py``,
``pipeline_parallel.py``) are a later slice.
"""

from __future__ import annotations

from typing import Optional

from .. import parallel as _parallel
from ..parallel import DataParallel
from ..topology import ParallelMode, get_hybrid_communicate_group
from . import meta_parallel
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .random import RNGStatesTracker, get_rng_state_tracker
from .recompute import recompute, recompute_sequential

__all__ = [
    "init", "DistributedStrategy", "get_hybrid_communicate_group",
    "distributed_model", "distributed_optimizer", "worker_index",
    "worker_num", "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "ParallelCrossEntropy", "RNGStatesTracker",
    "get_rng_state_tracker", "recompute", "recompute_sequential",
    "meta_parallel", "ParallelMode",
]


class DistributedStrategy:
    """The distributed knobs (reference: the protobuf-backed
    DistributedStrategy, distributed_strategy.proto:105 HybridConfig),
    as plain attributes."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.pipeline_configs = {
            "accumulate_steps": 1,
            "micro_batch_size": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_FLEET_STATE = {"initialized": False, "strategy": None}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None):
    """Join the world and build the hybrid topology of ``strategy``'s
    degrees (reference fleet.py:218 ``_init_hybrid_parallel_env``); the
    degrees' product must be the world's size."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    _parallel.init_parallel_env({
        "dp": int(hc.get("dp_degree", 1)),
        "pp": int(hc.get("pp_degree", 1)),
        "sharding": int(hc.get("sharding_degree", 1)),
        "sep": int(hc.get("sep_degree", 1)),
        "mp": int(hc.get("mp_degree", 1)),
    })
    _FLEET_STATE["initialized"] = True
    _FLEET_STATE["strategy"] = strategy
    return get_hybrid_communicate_group()


def worker_index() -> int:
    from ..process_mesh import this_rank

    return this_rank()


def worker_num() -> int:
    return _parallel.get_world_size()


def _refuse_pipeline(strategy) -> None:
    pc = getattr(strategy, "pipeline_configs", {}) or {}
    mode = str(pc.get("schedule_mode", ""))
    raise NotImplementedError(
        f"later slice: pipeline parallel Layers (pp_layers.py, "
        f"pipeline_parallel.py{', schedule_mode ' + mode if mode else ''}) "
        "are not ported; fleet.distributed_model refuses pipeline mode")


def distributed_model(model):
    """Wrap by parallel mode (reference fleet/model.py:142-180)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init()
        hcg = get_hybrid_communicate_group()
    strategy = _FLEET_STATE["strategy"] or DistributedStrategy()
    mode = hcg.get_parallel_mode()
    pc = getattr(strategy, "pipeline_configs", {}) or {}
    if mode == ParallelMode.PIPELINE_PARALLEL or \
            str(pc.get("schedule_mode", "")).upper().startswith("ZB"):
        _refuse_pipeline(strategy)
    if mode == ParallelMode.SEGMENT_PARALLEL:
        return meta_parallel.SegmentParallel(model, hcg, strategy)
    if mode == ParallelMode.TENSOR_PARALLEL:
        return meta_parallel.TensorParallel(model, hcg, strategy)
    return DataParallel(model, find_unused_parameters=bool(
        getattr(strategy, "find_unused_parameters", False)))


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """reference fleet.py distributed_optimizer: the
    ``HybridParallelOptimizer`` over the topology (the optimizer itself
    without one)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return optimizer
    from .hybrid_parallel_optimizer import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or _FLEET_STATE["strategy"]
                                   or DistributedStrategy())
