"""The training step and its runtime (the port's copy of
paddle_tpu/parallel/): the sharded step on a mesh and the resilient
loop. The pipeline and ring attention come with a later slice."""

from .resilient_loop import ResilientTrainLoop, with_retries
from .train_step import make_sharded_train_step, shard_gpt_params

__all__ = ["make_sharded_train_step", "shard_gpt_params",
           "ResilientTrainLoop", "with_retries"]
