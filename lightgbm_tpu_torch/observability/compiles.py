"""Compile accounting: count/seconds per compiled entry + cache hits.

Port of lightgbm_tpu/observability/compiles.py. The JAX package counts
XLA compiles; the port counts what takes their place:

- ``fused_train``: a fused trainer's build and CUDA graph capture
  (boosting/fused.py). The block that builds and captures a trainer is
  the entry's compile, its seconds the block's whole wall (build,
  capture and the block's first run, as the JAX package brackets a
  jitted entry's first dispatch); each later block that replays the
  graphs is a hit (registry.record_fused_block);
- ``nvcc_<stem>``: one per kernel library that learner/_cuda.build_all
  compiles with nvcc, its seconds from the start of the parallel build to
  that process's end.

As in the JAX package, a compile's seconds bracket the first dispatch
(trace + compile + first run), so the recorded figure bounds the real
compile time from above.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

__all__ = ["CompileAccounting"]


class CompileAccounting:
    """Thread-safe per-entry {compiles, hits, compile_seconds}."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}

    def record(self, entry: str, seconds: float = 0.0,
               compiled: bool = True) -> None:
        with self._lock:
            rec = self._entries.setdefault(
                entry, {"compiles": 0, "hits": 0, "compile_seconds": 0.0})
            if compiled:
                rec["compiles"] += 1
                rec["compile_seconds"] += float(seconds)
            else:
                rec["hits"] += 1

    @contextlib.contextmanager
    def track(self, entry: str, compiled: bool = True):
        """Bracket a dispatch; the wall is attributed as compile
        seconds when `compiled` (first sighting), else counted a hit."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(entry, time.perf_counter() - t0, compiled)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def totals(self) -> Dict:
        snap = self.snapshot()
        return {
            "compile_count": sum(v["compiles"] for v in snap.values()),
            "hit_count": sum(v["hits"] for v in snap.values()),
            "compile_seconds": round(
                sum(v["compile_seconds"] for v in snap.values()), 6),
        }

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
