"""paddle_tpu_torch.vision (port of paddle_tpu/vision/): ``models`` (the
ResNet family) and, of ``ops``, the NMS core that ``multiclass_nms3``
needs. The reference's ``transforms``, ``datasets``, the rest of
``ops`` and the other model files are ROADMAP Queue 1 item 7."""

from . import models, ops  # noqa: F401
from .models import *  # noqa: F401,F403

__all__ = ["models", "ops"]
