"""Meta-parallel model wrappers (the port's copy of
paddle_tpu/distributed/fleet/meta_parallel/__init__.py): the tensor-,
segment- and pipeline-parallel ones and the pipeline's layer descs."""

from .pipeline_parallel import (PipelineParallel,
                                PipelineParallelWithInterleave,
                                PipelineParallelZeroBubble)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .segment_parallel import SegmentParallel, concat_sequence, \
    split_sequence
from .tensor_parallel import TensorParallel

__all__ = ["TensorParallel", "PipelineParallel",
           "PipelineParallelWithInterleave", "PipelineParallelZeroBubble",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "SegmentParallel", "split_sequence", "concat_sequence"]
