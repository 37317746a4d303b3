"""paddle_tpu_torch.nn.functional: the functionals ported so far
(attention); the rest of the reference's functional API is ROADMAP
Queue 1 item 3."""

from . import attention  # noqa: F401
from .attention import *  # noqa: F401,F403
