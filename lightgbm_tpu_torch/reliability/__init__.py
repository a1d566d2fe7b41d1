"""Reliability: the non-finite guard rails (guards.py) and the counters
that make a recovery observable (counters.py). Port of the part of
lightgbm_tpu/reliability/ that training uses; checkpoints, retries and
the flight recorder are ROADMAP.md port-queue A9."""

from .counters import ReliabilityCounters, counters
from .guards import GUARD_POLICIES, GuardError, all_finite, trip

__all__ = ["ReliabilityCounters", "counters", "GUARD_POLICIES", "GuardError",
           "all_finite", "trip"]
