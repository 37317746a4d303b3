"""Meta-parallel model wrappers (the port's copy of
paddle_tpu/distributed/fleet/meta_parallel/__init__.py): the tensor- and
segment-parallel ones. The pipeline Layers (``pp_layers.py``,
``pipeline_parallel.py``) are a later slice; ``fleet.distributed_model``
refuses pipeline mode until then."""

from .segment_parallel import SegmentParallel, concat_sequence, \
    split_sequence
from .tensor_parallel import TensorParallel

__all__ = ["TensorParallel", "SegmentParallel", "split_sequence",
           "concat_sequence"]
