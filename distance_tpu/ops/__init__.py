"""Device compute for the pairwise counter sweep."""

from distance_tpu.ops.features import CounterPlan, get_plan
from distance_tpu.ops.pairwise_xla import counters_xla

__all__ = ["CounterPlan", "get_plan", "counters_xla"]
