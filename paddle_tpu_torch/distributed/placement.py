"""Placement algebra for distributed tensors (the port's copy of
paddle_tpu/distributed/placement.py).

A tensor's distribution over a mesh is one placement per mesh axis:
``Shard(dim)``, ``Replicate()`` or ``Partial(op)``, or, per tensor dim,
a partition spec :class:`P` naming the mesh axes that dim is split over
(the reference's ``jax.sharding.PartitionSpec``). :func:`to_placements`
lowers a spec onto ``torch.distributed.tensor`` placements, the form the
port's sharded state is held in (``DTensor``), and :func:`spec_of`
reads a spec back from them.
"""

from __future__ import annotations

__all__ = ["P", "Placement", "Shard", "Replicate", "Partial",
           "to_partition_spec", "sanitize_spec", "to_placements", "spec_of",
           "spec_entries"]


class P(tuple):
    """A partition spec: one entry a tensor dim, each None, an axis name
    or a tuple of axis names (missing trailing entries are None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _names(e) -> tuple:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def spec_entries(spec, ndim: int) -> tuple:
    """The spec as ``ndim`` tuples of axis names (``()`` unsharded)."""
    spec = tuple(spec) if spec is not None else ()
    return tuple(_names(spec[d]) if d < len(spec) else ()
                 for d in range(ndim))


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop spec entries whose dim the product of their (present,
    non-degenerate) mesh axes does not divide; drop axes absent from the
    mesh or of size 1, so that one spec serves every mesh."""
    entries = []
    for d, names in enumerate(spec_entries(spec, len(shape))):
        names = tuple(n for n in names
                      if n in mesh.axis_names and mesh.shape[n] > 1)
        prod = 1
        for n in names:
            prod *= mesh.shape[n]
        entries.append(names if names and shape[d] % prod == 0 else None)
    return P(*entries)


class Placement:
    def is_shard(self, dim=None) -> bool:
        return False

    def is_replicate(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


class Shard(Placement):
    """Tensor dim ``dim`` is split across this mesh axis."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def get_dim(self) -> int:
        return self.dim

    def is_shard(self, dim=None) -> bool:
        return dim is None or dim == self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    """Tensor is fully replicated across this mesh axis."""

    def is_replicate(self) -> bool:
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    """Each device along this axis holds a partial reduction term;
    ``reduce_type`` in {"sum", "avg", "max", "min"}."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self) -> bool:
        return True

    def __eq__(self, other):
        return (isinstance(other, Partial)
                and other.reduce_type == self.reduce_type)

    def __hash__(self):
        return hash(("Partial", self.reduce_type))

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def to_partition_spec(placements, mesh_axis_names, ndim: int) -> P:
    """Lower a per-mesh-axis placement list (the port's or
    ``torch.distributed.tensor``'s) to a spec: per tensor dim, the mesh
    axes it is split on. Partial placements contribute nothing."""
    entries: list = [None] * ndim
    for axis_name, p in zip(mesh_axis_names, placements):
        if p.is_shard():
            d = p.dim % ndim
            entries[d] = (entries[d] or []) + [axis_name]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*(tuple(e) if e else None for e in entries))


def to_placements(spec, mesh, ndim: int) -> list:
    """The ``torch.distributed.tensor`` placements (one a mesh axis, in
    the mesh's order) of a spec on ``mesh``. A dim split over several
    axes is split in mesh-axis order, as DTensor splits it."""
    from torch.distributed.tensor import Replicate as TReplicate
    from torch.distributed.tensor import Shard as TShard

    out = [TReplicate() for _ in mesh.axis_names]
    for d, names in enumerate(spec_entries(spec, ndim)):
        for n in names:
            out[mesh.axis_names.index(n)] = TShard(d)
    return out


def spec_of(tensor, mesh=None) -> P:
    """The spec a ``DTensor`` is held in (``P()`` for a plain tensor)."""
    placements = getattr(tensor, "placements", None)
    if placements is None:
        return P()
    names = (mesh.axis_names if mesh is not None
             else tensor.device_mesh.mesh_dim_names)
    return to_partition_spec(placements, names, tensor.dim())
