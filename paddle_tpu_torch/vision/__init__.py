"""paddle_tpu_torch.vision (port of paddle_tpu/vision/): ``models`` (the
ResNet family). The reference's ``transforms``, ``datasets``, ``ops``
and other model files are ROADMAP Queue 1 item 3."""

from . import models  # noqa: F401
from .models import *  # noqa: F401,F403

__all__ = ["models"]
