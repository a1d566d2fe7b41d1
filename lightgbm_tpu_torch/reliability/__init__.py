"""Reliability: the non-finite guard rails (guards.py), single-host
checkpoint bundles for kill-and-resume training (checkpoint.py) and the
counters that make a recovery observable (counters.py). Port of the part
of lightgbm_tpu/reliability/ that training uses; retries, fault injection
and the flight recorder are ROADMAP.md port-queue A9 part 2, the
coordinated multihost checkpoint A10."""

from .counters import ReliabilityCounters, counters
from .guards import GUARD_POLICIES, GuardError, all_finite, trip

__all__ = ["ReliabilityCounters", "counters", "GUARD_POLICIES", "GuardError",
           "all_finite", "trip"]
