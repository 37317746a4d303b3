"""paddle_tpu_torch.nn.functional: the functional API (port of
paddle_tpu/nn/functional/): activations, attention, common (linear,
dropout, padding, interpolation), conv, input (embedding, one_hot),
losses, norms, pooling and vision (grid_sample, affine_grid)."""

from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .input import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403

from . import (activation, attention, common, conv, input,  # noqa: F401,A004
               loss, norm, pooling, vision)
