"""paddle_tpu_torch.incubate.distributed (port of
paddle_tpu/incubate/distributed)."""

from . import models

__all__ = ["models"]
