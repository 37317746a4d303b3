"""paddle_tpu_torch.optimizer (port of paddle_tpu/optimizer)."""

from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    ASGD, DecayedAdagrad, DpSGD, Ftrl, LBFGS, NAdam, RAdam, RMSProp, Rprop,
    SGD, AdaDelta, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum)
