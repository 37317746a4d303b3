"""paddle_tpu_torch.nn.functional: the functional API (port of
paddle_tpu/nn/functional/): activations, attention, common (linear,
dropout, padding, interpolation), input (embedding, one_hot), losses
and norms. The reference's conv, pooling and vision functionals are
ROADMAP Queue 1 item 3."""

from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .input import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403

from . import activation, attention, common, input, loss, norm  # noqa: F401,A004
