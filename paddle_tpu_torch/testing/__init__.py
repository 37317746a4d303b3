"""Testing utilities: deterministic fault injection (``chaos``)."""

from . import chaos
from .chaos import ChaosInjected, FaultPlan, FaultSpec

__all__ = ["chaos", "FaultPlan", "FaultSpec", "ChaosInjected"]
