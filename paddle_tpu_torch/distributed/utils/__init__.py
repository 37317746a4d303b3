"""paddle_tpu_torch.distributed.utils (port of
paddle_tpu/distributed/utils/): the expert all-to-all."""

from . import moe_utils
from .moe_utils import global_gather, global_scatter

__all__ = ["moe_utils", "global_scatter", "global_gather"]
