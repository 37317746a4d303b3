"""incubate.nn (port of paddle_tpu.incubate.nn): the fused functionals
and the fused Layers."""

from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedDropoutAdd", "FusedFeedForward", "FusedLinear",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer"]
