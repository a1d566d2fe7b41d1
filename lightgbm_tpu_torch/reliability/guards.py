"""Numeric guard rails: catch non-finite training state before it
poisons the model.

Port of lightgbm_tpu/reliability/guards.py. A single NaN gradient
(exploding custom objective, bad init score) corrupts every later
iteration: scores are cumulative. With ``guard_nonfinite`` on, the booster
(GBDT.train_one_iter) checks the gradients and hessians before growth and
the training score and the new trees' leaf values after, and applies a
policy:

``warn``            log, set the non-finite values to 0 and continue
``skip_iteration``  drop the iteration's contribution, keep training
``rollback``        roll the iteration that produced the bad scores back
                    (rollback_one_iter) and recompute, keep training
``raise``           raise `GuardError` at once

Each activation increments the ``guard_trips`` counter. Each check is one
host read, which is why the guard is opt-in and keeps the booster on the
per-iteration path: a block of the fused trainer has no host boundary to
interpose on. The JAX package's flight-recorder record of a trip waits
for the flight recorder's port (ROADMAP.md A9).
"""

from __future__ import annotations

import torch

from ..utils.log import Log
from .counters import counters

__all__ = ["GuardError", "GUARD_POLICIES", "all_finite", "trip"]

GUARD_POLICIES = ("off", "warn", "skip_iteration", "rollback", "raise")


class GuardError(RuntimeError):
    """Raised by the ``raise`` guard policy on non-finite state."""


def all_finite(*tensors) -> bool:
    """True when every element of every tensor is finite (None skipped):
    one fused reduction a tensor, one host read in all."""
    ok = None
    for t in tensors:
        if t is None:
            continue
        fin = torch.isfinite(t).all()
        ok = fin if ok is None else ok & fin
    return True if ok is None else bool(ok)


def trip(what: str, policy: str, iteration: int) -> None:
    """Record a guard activation and apply the terminal part of the
    policy (log, or raise); the caller implements skip and rollback."""
    counters.inc("guard_trips")
    msg = (f"non-finite {what} detected at iteration {iteration} "
           f"(guard_nonfinite={policy})")
    if policy == "raise":
        raise GuardError(msg)
    Log.warning(msg)
