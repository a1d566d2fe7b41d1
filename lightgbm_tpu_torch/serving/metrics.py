"""Per-model serving metrics: QPS, latency percentiles, cache, sheds.

The port's copy of lightgbm_tpu/serving/metrics.py.

A lock-guarded ring buffer of request latencies plus monotonic
counters; `snapshot()` renders a JSON-able dict (the schema documented
in docs/Serving.md). Device/binning phase totals ride the process-wide
`utils.timer.global_timer` under ``serve_*`` keys, so `python -c`
profiling and the training phases share one report.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..utils.timer import global_timer

__all__ = ["ModelMetrics", "PackMetrics"]

_PERCENTILES = (50.0, 95.0, 99.0)


class ModelMetrics:
    """Counters + bounded latency reservoir for one registered model."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = max(int(window), 16)
        self._lat_ms = np.zeros(self._window, np.float64)
        self._lat_n = 0          # total recorded (ring writes)
        self.requests = 0
        self.rows = 0
        self.batches = 0         # coalesced device batches
        self.bucket_hits = 0
        self.compile_count = 0
        self.shed_count = 0
        self.fallback_count = 0  # requests served by the host path
        self.errors = 0
        self.device_retries = 0  # device dispatches that needed a retry
        self.guard_trips = 0     # non-finite device outputs caught
        self.deadline_misses = 0  # SLO budget sheds + queue expiries
        self.failovers = 0       # batches re-routed to another replica
        self.swap_drains = 0     # requests host-drained by a hot-swap
        self._started = time.monotonic()
        self._first_request: Optional[float] = None
        self._last_request: Optional[float] = None

    # ------------------------------------------------------------------
    def record_request(self, rows: int, latency_s: float,
                       fallback: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            self.requests += 1
            self.rows += int(rows)
            if fallback:
                self.fallback_count += 1
            self._lat_ms[self._lat_n % self._window] = latency_s * 1e3
            self._lat_n += 1
            if self._first_request is None:
                self._first_request = now
            self._last_request = now

    def record_batch(self, bucket_hit: bool, compiled: bool) -> None:
        with self._lock:
            self.batches += 1
            if bucket_hit:
                self.bucket_hits += 1
            if compiled:
                self.compile_count += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed_count += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_retry(self) -> None:
        with self._lock:
            self.device_retries += 1

    def record_guard_trip(self) -> None:
        with self._lock:
            self.guard_trips += 1

    def record_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_misses += 1

    def record_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    def record_swap_drain(self, n: int = 1) -> None:
        with self._lock:
            self.swap_drains += int(n)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            n = min(self._lat_n, self._window)
            lats = np.sort(self._lat_ms[:n]) if n else np.zeros(0)
            span = None
            if self._first_request is not None and self.requests > 1:
                span = max(self._last_request - self._first_request, 1e-9)
            qps = (self.requests / span) if span else float(self.requests)
            rows_per_s = (self.rows / span) if span else float(self.rows)
            out = {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "qps": round(qps, 3),
                "rows_per_sec": round(rows_per_s, 3),
                "bucket_cache_hits": self.bucket_hits,
                "compile_count": self.compile_count,
                "shed_count": self.shed_count,
                "fallback_count": self.fallback_count,
                # degradation visibility (docs/Reliability.md):
                # "fallbacks" mirrors fallback_count under the unified
                # reliability-counter name
                "fallbacks": self.fallback_count,
                "device_retries": self.device_retries,
                "guard_trips": self.guard_trips,
                "deadline_misses": self.deadline_misses,
                "failovers": self.failovers,
                "swap_drains": self.swap_drains,
                "errors": self.errors,
                "uptime_sec": round(time.monotonic() - self._started, 3),
            }
            for p in _PERCENTILES:
                key = f"p{int(p)}_ms"
                out[key] = round(float(np.percentile(lats, p)), 3) \
                    if n else None
        return out


class PackMetrics:
    """Counters for one ForestPack's fused dispatch path (the
    ``lightgbm_tpu_multimodel`` Prometheus family, docs/
    Observability.md). Occupancy is packed rows over slot-grouped
    capacity — low occupancy means the resident members rarely have
    concurrent traffic and the pack is mostly padding."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fused_dispatches = 0     # kernel launches (rounds)
        self.packed_rows = 0          # real rows scored through the pack
        self.capacity_rows = 0        # slots * row_block summed
        self.slots_active_total = 0   # slots with rows, summed per round
        self.compile_count = 0        # pack bucket-cache misses
        self.rebuilds = 0             # pack republished (evict/hot-swap)
        self.rebuild_drains = 0       # futures host-drained by a rebuild
        self.device_retries = 0
        self.guard_trips = 0
        self.failovers = 0

    def record_dispatch(self, rows: int, capacity: int, slots: int,
                        compiled: bool) -> None:
        with self._lock:
            self.fused_dispatches += 1
            self.packed_rows += int(rows)
            self.capacity_rows += int(capacity)
            self.slots_active_total += int(slots)
            if compiled:
                self.compile_count += 1

    def record_rebuild(self, drained: int = 0) -> None:
        with self._lock:
            self.rebuilds += 1
            self.rebuild_drains += int(drained)

    # the replica fleet's retry/failover bookkeeping (replicas.dispatch)
    # records against the pack when the whole pack fails over
    def record_retry(self) -> None:
        with self._lock:
            self.device_retries += 1

    def record_guard_trip(self) -> None:
        with self._lock:
            self.guard_trips += 1

    def record_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    def snapshot(self) -> Dict:
        with self._lock:
            occupancy = (self.packed_rows / self.capacity_rows) \
                if self.capacity_rows else 0.0
            avg_slots = (self.slots_active_total / self.fused_dispatches) \
                if self.fused_dispatches else 0.0
            return {
                "fused_dispatches": self.fused_dispatches,
                "packed_rows": self.packed_rows,
                "capacity_rows": self.capacity_rows,
                "occupancy": round(occupancy, 4),
                "avg_slots_active": round(avg_slots, 3),
                "compile_count": self.compile_count,
                "rebuilds": self.rebuilds,
                "rebuild_drains": self.rebuild_drains,
                "device_retries": self.device_retries,
                "guard_trips": self.guard_trips,
                "failovers": self.failovers,
            }


def timer_totals() -> Dict[str, float]:
    """serve_* phase totals from the process-global timer."""
    return {k: round(v, 6) for k, v in global_timer.totals().items()
            if k.startswith("serve_")}
