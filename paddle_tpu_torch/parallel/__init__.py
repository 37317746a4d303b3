"""The training step and its runtime (the port's copy of
paddle_tpu/parallel/): the sharded step on a mesh, the pipeline over its
pp axis, ring attention, and the resilient loop."""

from .pipeline import pipeline_blocks_fn
from .resilient_loop import ResilientTrainLoop, with_retries
from .ring_attention import ring_attention
from .train_step import make_sharded_train_step, shard_gpt_params

__all__ = ["make_sharded_train_step", "shard_gpt_params",
           "pipeline_blocks_fn", "ring_attention",
           "ResilientTrainLoop", "with_retries"]
