"""Hybrid-parallel topology: the 5-D logical mesh (the port's copy of
paddle_tpu/distributed/topology.py).

``CommunicateTopology`` holds the degrees of the five axes, in the
reference's order outer to inner: data, pipe, sharding, sep, model.
``HybridCommunicateGroup`` lays them out as a ``process_mesh.Mesh`` with
the short axis names ("dp", "pp", "sharding", "sep", "mp", the names
sharding specs use) and holds a ``collective.Group`` an axis and the
check group over (dp, pp, sharding), whose ``process_group`` is the
mesh's ``torch.distributed`` group through this rank. With the process
group joined and the world the mesh's size, the groups are made when
the topology is (every rank builds it at the same point); otherwise the
topology serves its shape alone.

The rank getters return this process's coordinate on the axis (its
global rank for ``get_global_rank``): what ``lax.axis_index`` gives
inside the reference's program, and 0 on rank 0, as the reference's
single controller returns. ``ring_attention`` takes
``HybridCommunicateGroup.mesh``; its "sep" axis is the default ring.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .collective import Group
from .process_mesh import Mesh, build_mesh, this_rank

__all__ = [
    "CommunicateTopology",
    "HybridCommunicateGroup",
    "ParallelMode",
    "get_hybrid_communicate_group",
    "set_hybrid_communicate_group",
]

# the reference's axis order (fleet/base/topology.py:73-79) and the short
# names of its sharding specs
HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")
AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}


class ParallelMode:
    """The reference's fleet/base/topology.py:40."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    def __init__(self, hybrid_group_names=HYBRID_AXES,
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self._world_size = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world_size

    def get_dim_size(self, axis_name):
        return self.get_dim(axis_name)


def _joined(size: int) -> bool:
    import torch.distributed as dist

    return (size > 1 and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == size)


class HybridCommunicateGroup:
    """The global mesh and a ``Group`` an axis."""

    def __init__(self, topology: CommunicateTopology, devices=None):
        self._topo = topology
        dims = [topology.get_dim(n) for n in HYBRID_AXES]
        self._dp_degree, self._pp_degree, self._sharding_degree, \
            self._sep_degree, self._mp_degree = dims
        axis_names = tuple(AXIS_ALIAS[n] for n in HYBRID_AXES)
        self._mesh: Mesh = build_mesh(dims, axis_names, devices=devices)
        self._groups = {
            a: Group(self._mesh, (a,), gid=i, name=f"{a}_group")
            for i, a in enumerate(axis_names)
        }
        # the group over dp(+pp+sharding) of the global grad-norm clip and
        # AMP's found_inf (the reference's topology.py:240 _set_check_group)
        self._check_group = Group(
            self._mesh, ("dp", "pp", "sharding"), gid=100, name="check_group")
        if _joined(self._mesh.size):
            for g in list(self._groups.values()) + [self._check_group]:
                g.process_group

    # -- degrees ------------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree * self._sharding_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # -- groups -------------------------------------------------------------
    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_check_parallel_group(self, sharding_new_group=False) -> Group:
        return self._check_group

    # -- ranks: this process's coordinates ------------------------------------
    def _coord(self, axis: str) -> int:
        return self._mesh.coords().get(axis, 0) if self._mesh.size > 1 \
            else 0

    def get_global_rank(self):
        return this_rank()

    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sep_parallel_rank(self):
        return self._coord("sep")

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self):
        # the reference's order: sep alone is segment parallelism
        if self._sep_degree > 1 and self._mp_degree == 1 \
                and self._pp_degree == 1:
            return ParallelMode.SEGMENT_PARALLEL
        if self._mp_degree == 1 and self._pp_degree == 1 \
                and self._sharding_degree == 1:
            return ParallelMode.DATA_PARALLEL
        if self._sharding_degree > 1 and self._mp_degree == 1 \
                and self._pp_degree == 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        return ParallelMode.TENSOR_PARALLEL

    def __repr__(self):
        return (f"HybridCommunicateGroup(dp={self._dp_degree}, "
                f"pp={self._pp_degree}, sharding={self._sharding_degree}, "
                f"sep={self._sep_degree}, mp={self._mp_degree})")


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG
