"""Reliability: fault tolerance for training.

Port of lightgbm_tpu/reliability/ for one host:

- checkpoint/resume: atomic training-state bundles and `train(...,
  resume_from=)`, so a killed run resumes to the model text of an
  uninterrupted one (`reliability.checkpoint`);
- unified fault injection: a registry of named sites with deterministic
  skip/fail schedules, with a ``rank_death`` mode that ends the process
  (`reliability.faults`);
- guard rails and retries: non-finite detection with a configurable
  policy, and capped-exponential-backoff retries at the growth and fused
  dispatches (`reliability.guards`, `reliability.retry`), with the
  backoff curve as a policy object for loops across attempts
  (`reliability.backoff`).

Every recovery is counted (`reliability.counters`) and the fatal ones
leave a flight-recorder bundle (observability/flightrec.py). The
collective watchdog and the coordinated multihost checkpoint come with
the distributed learners (ROADMAP A10).
"""

from .counters import ReliabilityCounters, counters
from .faults import (FaultRegistry, InjectedFault, KNOWN_SITES,
                     RANK_DEATH_EXIT_CODE, faults)
from .guards import GUARD_POLICIES, GuardError, all_finite, trip
from .retry import retry_call
from .backoff import BackoffPolicy
from .checkpoint import (CheckpointState, latest_checkpoint,
                         load_checkpoint, pinned_bundle, save_checkpoint)

__all__ = [
    "ReliabilityCounters", "counters",
    "FaultRegistry", "InjectedFault", "KNOWN_SITES",
    "RANK_DEATH_EXIT_CODE", "faults",
    "GUARD_POLICIES", "GuardError", "all_finite", "trip",
    "retry_call", "BackoffPolicy",
    "CheckpointState", "latest_checkpoint", "load_checkpoint",
    "pinned_bundle", "save_checkpoint",
]
