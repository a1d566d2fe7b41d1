"""Per-iteration training telemetry: wall, phases, norms, counters.

Port of lightgbm_tpu/observability/telemetry.py. One record per boosting
iteration (or per fused block — the fused trainer's graphs replay a
block's trees in one dispatch, so a block lands as one record carrying
its iteration span). Records ride a bounded ring;
aggregates (iteration count, phase totals, total wall) accumulate
separately so a long run's summary never depends on ring capacity.

Reliability counters (device retries, fallbacks, guard trips,
checkpoint writes — reliability/counters.py) are folded in as per-record
DELTAS: each record carries only the counters that moved since the
previous record, so a degraded iteration is visible exactly where it
happened instead of as an end-of-run total.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

__all__ = ["TrainingTelemetry", "PHASE_KEYS"]

#: phase-timer keys recorded per iteration (utils/timer.py names).
#: `tree_train` is one tree's growth (histogram builds, split search and
#: routing, launched asynchronously: the on-device phases are not
#: separable host-side without a device profiler); `update_score` is the
#: apply (score-update) phase.
PHASE_KEYS = ("boosting", "bagging", "tree_train", "update_score",
              "linear_fit")


class TrainingTelemetry:
    """Bounded ring of per-iteration records + running aggregates."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(int(capacity), 16))
        self._last_counters: Optional[Dict[str, int]] = None
        self.iterations = 0
        self.trees = 0
        self.total_wall_s = 0.0
        self.phase_totals: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def record_iteration(self, iteration: int, wall_s: float, *,
                         phases: Optional[Dict[str, float]] = None,
                         trees: int = 1, iterations: int = 1,
                         fused: bool = False,
                         leaves: Optional[int] = None,
                         grad_norm: Optional[float] = None,
                         hess_norm: Optional[float] = None,
                         bagging_fraction: Optional[float] = None,
                         macs: Optional[int] = None,
                         counters: Optional[Dict[str, int]] = None
                         ) -> Dict:
        """Append one record. `iterations` > 1 marks a fused block
        covering [iteration, iteration + iterations). `counters` is an
        absolute snapshot (reliability.counters.snapshot()); the record
        stores the delta vs the previous record."""
        rec: Dict = {"iteration": int(iteration),
                     "wall_s": round(float(wall_s), 6)}
        if iterations != 1:
            rec["iterations"] = int(iterations)
        if fused:
            rec["fused"] = True
        if trees != 1:
            rec["trees"] = int(trees)
        if phases:
            rec["phases"] = {k: round(float(v), 6)
                             for k, v in phases.items() if v}
        if leaves is not None:
            rec["leaves"] = int(leaves)
        if grad_norm is not None:
            rec["grad_norm"] = float(grad_norm)
        if hess_norm is not None:
            rec["hess_norm"] = float(hess_norm)
        if bagging_fraction is not None and bagging_fraction != 1.0:
            rec["bagging_fraction"] = float(bagging_fraction)
        if macs:
            rec["estimated_macs"] = int(macs)
        with self._lock:
            if counters is not None:
                prev = self._last_counters or {}
                delta = {k: v - prev.get(k, 0) for k, v in counters.items()
                         if v - prev.get(k, 0)}
                if delta:
                    rec["counters"] = delta
                self._last_counters = dict(counters)
            self._ring.append(rec)
            self.iterations += int(iterations)
            self.trees += int(trees)
            self.total_wall_s += float(wall_s)
            for k, v in (phases or {}).items():
                if v:
                    self.phase_totals[k] = \
                        self.phase_totals.get(k, 0.0) + float(v)
        return rec

    # ------------------------------------------------------------------
    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._ring[-1]) if self._ring else None

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=max(int(capacity), 16))

    def snapshot(self) -> Dict:
        with self._lock:
            n = self.iterations
            out = {
                "iterations": n,
                "trees": self.trees,
                "total_wall_s": round(self.total_wall_s, 6),
                "mean_iter_s": round(self.total_wall_s / n, 6) if n else 0.0,
                "phase_totals": {k: round(v, 6)
                                 for k, v in self.phase_totals.items()},
                "records_buffered": len(self._ring),
            }
            if self._ring:
                out["last"] = dict(self._ring[-1])
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_counters = None
            self.iterations = 0
            self.trees = 0
            self.total_wall_s = 0.0
            self.phase_totals = {}
