"""The training runtime's distributed plane (the port's copy of the
reference's ``paddle_tpu/distributed/`` runtime modules): the rendezvous
store, format-v2 checkpoints that both packages read, the comm and step
watchdogs, the process launcher and elastic supervision; sharded
training's mesh (``process_mesh``), placements (``placement``), ZeRO
layouts (``sharding``) and collectives (``autograd_collectives``:
``ppermute``, the pipeline's and ring attention's transport); and the
hybrid topology (``topology``) with its groups (``collective.Group``).
The fleet wrappers and the rest of the reference's user-facing API come
with the Paddle API slice."""

from .placement import Partial, Placement, Replicate, Shard
from .process_mesh import ProcessMesh, build_mesh, get_mesh, set_mesh

__all__ = ["Partial", "Placement", "Replicate", "Shard", "ProcessMesh",
           "build_mesh", "get_mesh", "set_mesh"]
