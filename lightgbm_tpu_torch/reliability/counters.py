"""Process-wide reliability counters: degradation must be observable.

Port of lightgbm_tpu/reliability/counters.py. Every recovery path (a
device retry, the fused -> per-iteration fall-back, a guard-rail trip, a
checkpoint write that failed) increments a named counter here, so a run
shows how degraded it was; the flight recorder's post-mortem bundle
carries the snapshot (observability/flightrec.py).
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["ReliabilityCounters", "counters"]

_KEYS = (
    "device_retries",      # retry_call attempts that followed a failure
    "fallbacks",           # degraded dispatches (fused->per-iteration)
    "guard_trips",         # non-finite guard activations
    "checkpoint_saves",    # successful checkpoint bundles written
    "checkpoint_failures", # checkpoint writes that failed (training continued)
)


class ReliabilityCounters:
    """Thread-safe named counters with a stable snapshot schema."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in _KEYS}

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + int(n)

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        """All keys, always present: consumers index without guards."""
        with self._lock:
            out = {k: 0 for k in _KEYS}
            out.update(self._counts)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts = {k: 0 for k in _KEYS}


#: process-wide singleton
counters = ReliabilityCounters()
