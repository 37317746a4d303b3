"""TensorParallel model wrapper (the port's copy of
paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py; Paddle's
fleet/meta_parallel/tensor_parallel.py).

The reference marks every parameter that is not mp-split as replicated
over its mesh: one logical copy. Here each rank holds a copy, so at wrap
time the parameters that are not ``is_distributed`` (and the buffers)
are broadcast across mp from mp rank 0, and every parameter across dp
from dp rank 0, as Paddle's wrapper does. The gradients of the
replicated parameters need no sync over mp: every mp rank computes the
same ones (the mp Layers' collectives carry the partial sums).
"""

from __future__ import annotations

from ...parallel import MetaParallelBase, broadcast_parameters

__all__ = ["TensorParallel"]


class TensorParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        broadcast_parameters(layers, hcg.get_model_parallel_group(),
                             distributed_too=False)
        broadcast_parameters(layers, hcg.get_data_parallel_group(),
                             distributed_too=True)
