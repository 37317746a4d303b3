"""The training runtime's distributed plane (the port's copy of the
reference's ``paddle_tpu/distributed/`` runtime modules): the rendezvous
store, format-v2 checkpoints that both packages read, the comm and step
watchdogs, the process launcher and elastic supervision; and sharded
training's mesh (``process_mesh``), placements (``placement``), ZeRO
layouts (``sharding``) and collectives (``autograd_collectives``). The
fleet wrappers and the rest of the reference's user-facing API come with
later slices."""

from .placement import Partial, Placement, Replicate, Shard
from .process_mesh import ProcessMesh, build_mesh, get_mesh, set_mesh

__all__ = ["Partial", "Placement", "Replicate", "Shard", "ProcessMesh",
           "build_mesh", "get_mesh", "set_mesh"]
