"""paddle_tpu_torch.incubate (port of paddle_tpu.incubate): the serving
ops of ``incubate.nn.functional.fused_transformer`` so far, and the MoE
Layer of ``incubate.distributed.models.moe`` (imported on its own, as
the reference's)."""

from . import nn

__all__ = ["nn"]
