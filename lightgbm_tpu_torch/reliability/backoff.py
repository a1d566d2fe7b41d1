"""Capped-exponential backoff policy for cross-attempt crash loops.

Port of lightgbm_tpu/reliability/backoff.py. `retry.retry_call` owns the
in-call retry ladder (one function, one attempt budget, sleeps inline). A
loop that retries across whole recover/rebuild attempts (the continuous
trainer, ROADMAP A11) needs the same curve outside a single call, with
the attempt counter in the calling loop: this policy object is that curve,
deterministic by default (no jitter, as retry.py) and injectable
(`sleep=` stub for tests).

Multi-rank retry ladders want the opposite of determinism: after a
resize every survivor retries against the same recovering peer on the
same curve. ``jitter="decorrelated"`` switches to the decorrelated-jitter
curve (Brooker, AWS Architecture Blog 2015): each delay is drawn
uniformly from [base, 3 x previous delay], capped. The RNG is a private
seeded ``random.Random``, so a seed gives a deterministic yet jittered
sequence.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """delay(attempt) = min(base_ms * 2**attempt, max_ms), attempt 0-based.

    With ``jitter="decorrelated"``:
    delay = min(max_ms, uniform(base_ms, 3 * previous_delay)), stateful
    across calls (the attempt number is not used), bounded by [base_ms,
    max_ms] at every step.
    """

    def __init__(self, base_ms: float = 50.0, max_ms: float = 2000.0,
                 sleep: Callable[[float], None] = time.sleep,
                 jitter: str = "none", seed: Optional[int] = None):
        if jitter not in ("none", "decorrelated"):
            raise ValueError(f"unknown jitter mode {jitter!r} "
                             f"(expected 'none' or 'decorrelated')")
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = jitter
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._prev_ms = self.base_ms

    def reset(self) -> None:
        """Forget the jitter state (a recovered run restarts the ladder)."""
        self._prev_ms = self.base_ms

    def delay_ms(self, attempt: int) -> float:
        if self.base_ms <= 0:
            return 0.0
        if self.jitter == "decorrelated":
            drawn = self._rng.uniform(self.base_ms, 3.0 * self._prev_ms)
            self._prev_ms = min(max(drawn, self.base_ms), self.max_ms)
            return self._prev_ms
        return min(self.base_ms * (2.0 ** max(0, int(attempt))),
                   self.max_ms)

    def wait(self, attempt: int) -> float:
        """Sleep the capped delay for `attempt`; returns the delay (ms)
        slept, for the caller to log or record."""
        delay = self.delay_ms(attempt)
        if delay > 0:
            self._sleep(delay / 1e3)
        return delay
