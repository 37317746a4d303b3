"""paddle_tpu_torch.incubate (port of paddle_tpu.incubate): the fused
functionals and Layers of ``incubate.nn``, the incubate optimizers and,
imported on their own as the reference's, ASP (``incubate.asp``) and the
MoE Layer of ``incubate.distributed.models.moe``."""

from . import nn
from . import optimizer

__all__ = ["nn", "optimizer"]
