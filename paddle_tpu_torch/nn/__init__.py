"""paddle_tpu_torch.nn: layers, the functional API, initializers and
gradient clips (port of paddle_tpu/nn/)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
from .layer.extra import *  # noqa: F401,F403
from .utils import (clip_grad_norm_, clip_grad_value_,  # noqa: F401
                    parameters_to_vector, vector_to_parameters)
