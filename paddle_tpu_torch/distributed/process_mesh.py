"""ProcessMesh: the n-d logical mesh of ranks (the port's copy of
paddle_tpu/distributed/process_mesh.py).

:func:`build_mesh` returns a :class:`Mesh`: named axes over the ranks
``0 .. n-1`` laid out row-major (or the ``devices`` given), with, for a
mesh of more than one rank, a ``torch.distributed.device_mesh.DeviceMesh``
over the process group the caller joined (``distributed/launch.py::
init_from_env``: gloo on the CPU, nccl on the card) and one subgroup an
axis. A mesh whose every axis is 1 needs no process group: it runs in a
plain process. The DeviceMesh is made on first use, which every rank
reaches in the same order (``make_sharded_train_step`` reaches it while
it builds the step), so that a mesh can also be built only for its
shape, as the spec tests do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["Mesh", "ProcessMesh", "get_mesh", "set_mesh", "build_mesh",
           "this_rank"]

_GLOBAL_MESH: Optional["ProcessMesh"] = None


def this_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """Named axes over ranks: ``shape`` maps axis -> size in axis order,
    ``devices`` holds the rank at each coordinate."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self._device_mesh = None

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the joined group; None at one rank."""
        if self.size == 1:
            return None
        if self._device_mesh is None:
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"a mesh of {self.size} ranks needs the process group: "
                    "join it first (distributed.launch.init_from_env, or "
                    "torch.distributed.init_process_group)")
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh of {self.size} ranks in a group of "
                                 f"{dist.get_world_size()}")
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(kind, self.devices,
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    def coords(self, rank: Optional[int] = None) -> dict:
        """axis -> index of ``rank`` (this process's by default)."""
        rank = this_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str) -> int:
        return self.coords()[axis] if self.size > 1 else 0

    def group(self, axis: str):
        """The process group along ``axis`` through this rank; None when
        the axis has one rank (every collective over it is the
        identity)."""
        if self.shape.get(axis, 1) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(shape: Sequence[int], axis_names: Sequence[str],
               devices=None) -> Mesh:
    """A mesh of ``shape`` over ranks ``0 .. prod(shape)-1`` row-major, or
    over ``devices`` (ranks) reshaped to ``shape``."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if devices is None:
        devices = np.arange(n)
    devices = np.asarray(devices).reshape(shape)
    return Mesh(devices, axis_names)


class ProcessMesh:
    """An n-d mesh of ranks with named axes (the reference's API over a
    :class:`Mesh`)."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None):
        if isinstance(mesh, Mesh):
            self._mesh = mesh
        else:
            if mesh is not None:
                arr = np.asarray(mesh)
                shape = arr.shape
            if shape is None:
                raise ValueError("ProcessMesh needs `mesh` (array of ids) "
                                 "or `shape`")
            shape = tuple(int(s) for s in shape)
            if dim_names is None:
                dim_names = [f"d{i}" for i in range(len(shape))]
            self._mesh = build_mesh(shape, dim_names,
                                    None if mesh is None else arr)
        self._shape = tuple(self._mesh.devices.shape)
        self._dim_names = tuple(self._mesh.axis_names)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(i) for i in self._mesh.devices.reshape(-1)]

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def get_dim_size(self, dim_name: str) -> int:
        return self._shape[self._dim_names.index(dim_name)]

    def get_mesh_with_dim(self, dim_name: str, index=None):
        """Sub-mesh views: ``dim_name`` moved first, or (with ``index``)
        the slice at that coordinate."""
        axis = self._dim_names.index(dim_name)
        names = [n for i, n in enumerate(self._dim_names) if i != axis]
        devices = np.moveaxis(self._mesh.devices, axis, 0)
        if index is None:
            return ProcessMesh(Mesh(devices, (dim_name,) + tuple(names)))
        return ProcessMesh(Mesh(devices[index], tuple(names)))

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and other._shape == self._shape
                and other._dim_names == self._dim_names)

    def __hash__(self):
        return hash((self._shape, self._dim_names))

    def __repr__(self):
        return (f"ProcessMesh(shape={list(self._shape)}, "
                f"dim_names={list(self._dim_names)})")


def set_mesh(mesh) -> None:
    global _GLOBAL_MESH
    if isinstance(mesh, Mesh):
        mesh = ProcessMesh(mesh)
    _GLOBAL_MESH = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _GLOBAL_MESH
