"""Crash flight recorder: the last N events, flushed at the moment of death.

Port of lightgbm_tpu/observability/flightrec.py. A bounded, lock-guarded
ring of recent high-signal events:

- fault-site hits (reliability/faults.py) and non-finite guard trips
  (reliability/guards.py);
- checkpoint saves (reliability/checkpoint.py);
- an unhandled exception in `engine.train`;
- span closes, collective brackets and clock samples, whose producers
  (the span tracer, the collective watchdog) come with the observability
  registry and the distributed learners (ROADMAP A9 part 2's second half,
  A10); their `record_*` methods are here already.

On a fatal path (an injected ``rank_death`` before ``os._exit(86)``, a
non-finite guard trip, an unhandled exception in `engine.train`) the ring
is flushed as one atomic ``postmortem_<rank>.json`` bundle (a temp file,
then ``os.replace``), so a failure leaves a timeline instead of an exit
code. The bundle carries the reliability counters' snapshot; the JAX
package's ``collective`` and ``clock_skew`` entries come with the
registry.

Recording stays on whatever the rest of observability does (``flightrec``
defaults to true): these are rare, high-value records, and the last thing
a dying process writes must not depend on an enable flag. The recorder
never raises: forensics must not take down the exit path it documents.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "recorder", "POSTMORTEM_PREFIX",
           "FATAL_REASONS", "current_rank"]

POSTMORTEM_PREFIX = "postmortem_"

#: flush reasons on which the process is about to die for real: these
#: fall back to the working directory when no bundle directory is
#: configured (a bundle somewhere beats no bundle); other reasons flush
#: only when a directory was configured (flightrec_dir / checkpoint_dir)
FATAL_REASONS = ("watchdog_abort", "rank_death")


def current_rank() -> int:
    """This process's rank: torch.distributed's when a process group is
    initialised, else the launcher's LIGHTGBM_TPU_MACHINE_RANK, else 0.
    Never looks at JAX, and never initialises anything: the recorder must
    stay usable on every exit path."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
    try:
        return int(os.environ.get("LIGHTGBM_TPU_MACHINE_RANK", "0"))
    except ValueError:
        return 0


class FlightRecorder:
    """Bounded ring of recent events + atomic post-mortem flush."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(int(capacity), 16))
        self.enabled = True
        self.out_dir = ""
        self.dropped = 0
        self._flushes = 0
        self.last_flush_path = ""

    # -- configuration --------------------------------------------------
    def configure(self, *, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  out_dir: Optional[str] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None and \
                    self._ring.maxlen != max(int(capacity), 16):
                self._ring = collections.deque(
                    self._ring, maxlen=max(int(capacity), 16))
            if out_dir is not None:
                self.out_dir = str(out_dir)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self._flushes = 0
            self.last_flush_path = ""

    # -- recording ------------------------------------------------------
    def record(self, kind: str, name: str, **fields) -> None:
        """Append one event. `kind` groups the event family ("span",
        "collective", "fault", "guard", "clock", "io", "abort",
        "exception"); `name` is the span name, site or what. None fields
        are left out."""
        if not self.enabled:
            return
        rec: Dict = {"kind": kind, "name": name,
                     "t_wall": time.time(), "t_mono": time.monotonic()}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def record_span(self, name: str, start: float, duration: float,
                    depth: int, parent: Optional[str]) -> None:
        self.record("span", name, dur_ms=round(duration * 1e3, 3),
                    depth=depth, parent=parent)

    def record_collective(self, site: str, phase: str,
                          deadline_s: Optional[float] = None,
                          heartbeat_ages: Optional[Dict] = None,
                          wall_s: Optional[float] = None) -> None:
        """One side of a collective bracket: phase "enter" carries the
        armed deadline and the peers' heartbeat ages read at entry; phase
        "exit" the bracket's wall time."""
        ages = None
        if heartbeat_ages:
            ages = {str(r): round(float(a), 3)
                    for r, a in heartbeat_ages.items()}
        self.record("collective", site, phase=phase,
                    deadline_s=deadline_s, heartbeat_ages=ages,
                    wall_s=None if wall_s is None else round(wall_s, 6))

    def record_fault(self, site: str, mode: str) -> None:
        self.record("fault", site, mode=mode)

    def record_guard_trip(self, what: str, policy: str,
                          iteration: int) -> None:
        self.record("guard", what, policy=policy, iteration=int(iteration))

    def record_clock_sample(self, site: str, walls: List[float]) -> None:
        w = [float(v) for v in walls]
        skew = (max(w) - min(w)) if len(w) > 1 else 0.0
        self.record("clock", site, skew_s=round(skew, 6))

    def record_checkpoint(self, what: str, iteration: int,
                          path: str = "") -> None:
        self.record("io", what, iteration=int(iteration), path=path)

    def record_exception(self, where: str, exc: BaseException) -> None:
        self.record("exception", where, exc_type=type(exc).__name__,
                    exc=str(exc)[:500])

    # -- observation ----------------------------------------------------
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"enabled": int(self.enabled),
                    "events": len(self._ring),
                    "dropped": self.dropped,
                    "flushes": self._flushes}

    # -- the point of it all --------------------------------------------
    def flush(self, reason: str, out_dir: Optional[str] = None,
              extra: Optional[Dict] = None) -> Optional[str]:
        """Write the ring as ``postmortem_<rank>.json``, atomically.

        Destination: the `out_dir` argument, else the configured
        `out_dir`, else (only for FATAL_REASONS, where the process is
        about to die) the working directory. Returns the bundle's path, or
        None when disabled, with no destination, or when the write failed
        (the flush never raises: it runs on paths that must reach
        os._exit)."""
        if not self.enabled:
            return None
        try:
            dest = out_dir or self.out_dir
            if not dest:
                if reason not in FATAL_REASONS:
                    return None
                dest = os.getcwd()
            os.makedirs(dest, exist_ok=True)
            rank = current_rank()
            path = os.path.join(dest, f"{POSTMORTEM_PREFIX}{rank}.json")
            bundle: Dict = {
                "reason": reason,
                "rank": rank,
                "pid": os.getpid(),
                "wall_time": time.time(),
                "dropped": self.dropped,
                "events": self.events(),
            }
            try:        # best-effort context; never blocks the flush
                from ..reliability.counters import counters
                bundle["counters"] = counters.snapshot()
            except Exception:
                pass
            if extra:
                bundle.update(extra)
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(bundle, fh, indent=1)
                fh.write("\n")
            os.replace(tmp, path)
            with self._lock:
                self._flushes += 1
                self.last_flush_path = path
            print(f"lightgbm_tpu_torch: flight recorder flushed "
                  f"{len(bundle['events'])} events to {path} "
                  f"(reason: {reason})", file=sys.stderr, flush=True)
            return path
        except Exception:
            return None


#: process-wide singleton; every instrumented site records through it
recorder = FlightRecorder()
