"""Self-healing circuit breaker for the serving device path.

The port's copy of lightgbm_tpu/serving/breaker.py. A sticky
``degraded`` flag on the model entry (one device failure parks the
model on the host path until a manual ``refresh_model``) is the wrong
shape for transient device trouble: the flag never heals, so a single
hiccup permanently forfeits the device throughput the serving engine
exists for.

This breaker is the classic three-state machine, one
instance per (model, replica):

    closed ──(threshold consecutive failures)──▶ open
    open ──(cooldown elapsed, one probe granted)──▶ half_open
    half_open ──probe succeeds──▶ closed        (self-heals)
    half_open ──probe fails────▶ open           (cooldown restarts)

``try_acquire()`` is the routing gate: closed grants every dispatch;
open grants nothing until ``cooldown_s`` has elapsed, then transitions
to half_open and grants exactly ONE probe dispatch (concurrent callers
are refused while the probe is in flight); the probe's
``record_success``/``record_failure`` closes or re-opens. Success in
the closed state resets the consecutive-failure count, so only an
unbroken run of failures opens the breaker — the property injected
faults drive in tests (`faults.injected("serving_replica_predict",
fail=threshold)` opens it, the next cooldown-elapsed dispatch probes,
and a clean device closes it again).

The clock is injectable so tests step through cooldowns without
sleeping. All transitions are visible in ``snapshot()`` (state string,
open/close/probe counters) — the chaos harness asserts the full
open → half_open → closed cycle from metrics alone.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

__all__ = ["CircuitBreaker", "BREAKER_STATES", "breaker_state_code"]

#: state -> numeric code for the Prometheus gauge (closed sorts lowest
#: so dashboards can alert on max() per model)
BREAKER_STATES = ("closed", "half_open", "open")


def breaker_state_code(state: str) -> int:
    """closed=0, half_open=1, open=2 (the `breaker_state` gauge)."""
    return BREAKER_STATES.index(state)


class CircuitBreaker:
    """Per-replica three-state breaker; thread-safe, injectable clock."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self._lock = threading.Lock()
        self.threshold = int(threshold)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._clock = clock
        self._state = "closed"
        self._failures = 0          # consecutive, reset by any success
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0
        self.closes = 0             # heal transitions (half_open->closed)
        self.probes = 0

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def available(self) -> bool:
        """Non-consuming routing check: could a dispatch be granted now?
        (closed, or open with the cooldown elapsed, or half_open with a
        free probe slot.) Never transitions state or reserves the probe
        — use `try_acquire` for that."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return self._clock() - self._opened_at >= self.cooldown_s
            return not self._probe_inflight

    def try_acquire(self) -> bool:
        """Routing gate for one dispatch. Closed always grants; open
        grants nothing until the cooldown elapses, then moves to
        half_open and grants the single probe; half_open refuses while
        the probe is in flight. A granted half_open acquire MUST be
        paired with record_success/record_failure."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = "half_open"
                self._probe_inflight = True
                self.probes += 1
                return True
            # half_open: only the single probe flies
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            self.probes += 1
            return True

    # ------------------------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._state = "closed"
                self.closes += 1
            # success while open is a stale in-flight result: the
            # breaker opened on newer evidence, keep it open
            if self._state == "closed":
                self._failures = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self.opens += 1
                return
            if self._state == "open":
                return              # already open; cooldown keeps running
            self._failures += 1
            if self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self.opens += 1

    def force_open(self) -> None:
        """Ops/chaos hook: trip the breaker now (cooldown starts)."""
        with self._lock:
            if self._state != "open":
                self.opens += 1
            self._state = "open"
            self._opened_at = self._clock()
            self._probe_inflight = False

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "state": self._state,
                "state_code": breaker_state_code(self._state),
                "consecutive_failures": self._failures,
                "opens": self.opens,
                "closes": self.closes,
                "probes": self.probes,
            }
