"""paddle_tpu_torch.nn: Layer, ParamAttr, the initializers, the
attention functionals and the gradient clips (port of the reference's
nn/ core; its other layers and functionals are ROADMAP Queue 1 item 3)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .layer.layers import Layer, ParamAttr  # noqa: F401
