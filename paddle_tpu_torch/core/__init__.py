from . import autograd, device, dtype, flags, random
from .autograd import (backward, enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .dispatch import OP_REGISTRY, op, op_call
from .flags import get_flags, set_flags
from .tensor import Parameter, Tensor
