"""paddle_tpu_torch.incubate (port of paddle_tpu.incubate): the serving
ops of ``incubate.nn.functional.fused_transformer`` so far."""

from . import nn

__all__ = ["nn"]
