"""Communication groups (the port's copy of the ``Group`` class,
``new_group`` and ``get_group`` of paddle_tpu/distributed/collective.py;
the rest of that module, the collectives on the reference's ``Tensor``,
comes with the Paddle API slice).

A :class:`Group` is one or more named axes of a mesh (the port's
``process_mesh.Mesh``): the ranks that share this process's coordinates
on every other axis. Where the reference's single controller has no
process of its own in a group, here every rank is one: ``rank`` is this
process's index in its group (0 on rank 0 and in a one-process run, as
the reference returns), and ``process_group`` the ``torch.distributed``
group over those ranks, made the first time it is asked for (every rank
must ask in the same order, as for any new group; None for a group of
one rank).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .process_mesh import Mesh, build_mesh, this_rank

__all__ = ["Group", "new_group", "get_group"]


class Group:
    """A communicator over the named mesh axes ``axis_names``;
    ``nranks`` is the product of their sizes."""

    def __init__(self, mesh: Mesh, axis_names: Sequence[str], gid: int = 0,
                 name: str = ""):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.id = gid
        self.name = name or f"group_{'_'.join(self.axis_names)}"
        self._pg = None

    @property
    def nranks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axis_names]))

    @property
    def world_size(self) -> int:
        return self.nranks

    def _members(self) -> np.ndarray:
        """[groups, nranks]: the mesh's ranks with the group's axes last,
        one row a group (row-major over the group's axes)."""
        names = self.mesh.axis_names
        mine = [names.index(a) for a in self.axis_names]
        rest = [i for i in range(len(names)) if i not in mine]
        return np.transpose(self.mesh.devices, rest + mine).reshape(
            -1, self.nranks)

    @property
    def ranks(self) -> list:
        """The global ranks of this process's group, in group order."""
        rows = self._members()
        return [int(r) for r in rows[np.argwhere(rows == this_rank())[0][0]]]

    @property
    def rank(self) -> int:
        """This process's index in its group."""
        return self.ranks.index(this_rank())

    def is_member(self) -> bool:
        return this_rank() in self.ranks

    def get_group_rank(self, rank: int) -> int:
        """The index of global ``rank`` in this process's group; -1 if
        it is not in it."""
        ranks = self.ranks
        return ranks.index(rank) if rank in ranks else -1

    @property
    def process_group(self):
        """The ``torch.distributed`` group of this process's group
        (None: one rank)."""
        if self.nranks == 1:
            return None
        if self._pg is None:
            if len(self.axis_names) == 1:
                self._pg = self.mesh.group(self.axis_names[0])
            else:
                import torch.distributed as dist

                self.mesh.device_mesh           # the axes' groups first
                self._pg, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in self._members()])
        return self._pg

    def __repr__(self):
        return f"Group(axes={self.axis_names}, nranks={self.nranks})"


_GROUPS: dict = {}
_NEXT_GID = [1]


def _default_mesh() -> Mesh:
    """The hybrid topology's mesh where one is set, else one axis over
    the joined group's ranks (one rank without a group)."""
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.mesh
    import torch.distributed as dist

    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    return build_mesh((n,), ("world",))


def new_group(ranks=None, backend=None, axis_names=None,
              mesh: Optional[Mesh] = None) -> Group:
    """A communicator over mesh axes: ``axis_names`` of ``mesh`` (by
    default the hybrid topology's mesh, or one axis over every rank);
    every axis of the mesh without ``axis_names``. As the reference's,
    groups are mesh-axis aligned: ``ranks`` and ``backend`` are accepted
    for the signature and not read."""
    mesh = mesh if mesh is not None else _default_mesh()
    axis_names = tuple(axis_names) if axis_names else tuple(mesh.axis_names)
    g = Group(mesh, axis_names, gid=_NEXT_GID[0])
    _NEXT_GID[0] += 1
    _GROUPS[g.id] = g
    return g


def get_group(gid: int) -> Optional[Group]:
    return _GROUPS.get(gid)
