"""The training runtime's distributed plane (the port's copy of the
reference's ``paddle_tpu/distributed/`` runtime modules): the rendezvous
store, format-v2 checkpoints that both packages read, the comm and step
watchdogs, the process launcher and elastic supervision. Sharded
training (meshes, collectives) is a later slice."""
