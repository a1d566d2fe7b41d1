"""Process-wide reliability counters: degradation must be observable.

Port of lightgbm_tpu/reliability/counters.py, with the one key that the
port increments: a guard-rail trip. Device retries, fallbacks and
checkpoint writes add their keys when they are ported.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["ReliabilityCounters", "counters"]

_KEYS = (
    "guard_trips",         # non-finite guard activations
)


class ReliabilityCounters:
    """Thread-safe named counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in _KEYS}

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + int(n)

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts = {k: 0 for k in _KEYS}


#: process-wide singleton
counters = ReliabilityCounters()
