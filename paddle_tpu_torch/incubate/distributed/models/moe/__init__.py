"""The MoE user API (port of
paddle_tpu/incubate/distributed/models/moe/: ``MoELayer`` and the
gates), the experts of a moe group spread over its ranks and tokens
moved by ``distributed.utils.global_scatter`` / ``global_gather``."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import MoELayer

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
