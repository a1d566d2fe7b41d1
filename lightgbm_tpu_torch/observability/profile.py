"""Device profiler capture: device timelines for named spans.

Port of lightgbm_tpu/observability/profile.py on torch.profiler.
Host-side spans (observability/trace.py) time the *dispatch*; the device
work behind it (the hand-written kernels of csrc/, each replayed CUDA
graph's launches) only shows up in a device trace. This module brackets
a ``torch.profiler.profile`` capture (CPU and CUDA activities on the
card, CPU alone without one), started and stopped explicitly, around
spans whose name matches the ``profile_spans`` glob(s), with a hard
capture budget (``profile_max_captures``) so a long run collects a
handful of representative windows instead of gigabytes. A capture's
stop waits for the card and writes its Chrome trace to
``<profile_dir>/<span>_<nnn>/trace.json`` (chrome://tracing,
ui.perfetto.dev); the kernels are its ``"cat": "kernel"`` events.

Config surface (config.py): ``profile_spans`` (comma-separated
fnmatch globs, e.g. ``pipeline_block,grow_tree``), ``profile_dir``
(one subdirectory per capture; ``torch_profile`` by default, where the
JAX package writes ``jax_profile``), ``profile_max_captures``.

Degrades to a logged no-op wherever the profiler is unavailable (no
CUPTI, a second profiler already attached, a capture that fails): the
first failure disarms the profiler for the rest of the process, counts
``failed`` in the snapshot, and training continues untouched.
"""

from __future__ import annotations

import fnmatch
import os
import re
import threading
from contextlib import contextmanager
from typing import Tuple

from ..utils.log import Log

__all__ = ["SpanProfiler", "profiler", "TRACE_FILE"]


#: the Chrome trace file each capture directory holds
TRACE_FILE = "trace.json"

# the capture in progress: (torch.profiler.profile, its directory)
_live = None


def _start_trace(log_dir: str) -> None:
    """Start a torch.profiler capture whose trace goes to `log_dir`
    (the indirection the tests stub, as the JAX package's over
    jax.profiler.start_trace)."""
    global _live
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _live = (prof, log_dir)


def _stop_trace() -> None:
    """Stop the capture in progress once the card has drained, and write
    its Chrome trace into its directory."""
    global _live
    if _live is None:
        raise RuntimeError("no torch.profiler capture in progress")
    prof, log_dir = _live
    _live = None
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class SpanProfiler:
    """Budgeted torch.profiler bracketing for matching span names."""

    def __init__(self):
        self._lock = threading.Lock()
        self.armed = False          # fast-path flag: one attr read
        self.patterns: Tuple[str, ...] = ()
        self.out_dir = ""
        self.max_captures = 0
        self.captures = 0
        self._active = False        # one live capture at a time
        self._failed = False

    def configure(self, spans: str = "", out_dir: str = "",
                  max_captures: int = 4) -> None:
        with self._lock:
            self.patterns = tuple(
                p.strip() for p in str(spans or "").split(",") if p.strip())
            self.out_dir = str(out_dir or "")
            self.max_captures = max(0, int(max_captures))
            self.armed = bool(self.patterns and not self._failed and
                              self.max_captures > self.captures)

    def reset(self) -> None:
        with self._lock:
            self.armed = False
            self.patterns = ()
            self.out_dir = ""
            self.max_captures = 0
            self.captures = 0
            self._active = False
            self._failed = False

    # ------------------------------------------------------------------
    def matches(self, name: str) -> bool:
        return any(fnmatch.fnmatchcase(name, p) for p in self.patterns)

    def begin(self, name: str) -> bool:
        """Start a device trace for `name` if it matches, budget
        remains, and no capture is live. True iff a trace started —
        the caller owes a matching `end()`."""
        if not self.armed or not self.matches(name):
            return False
        with self._lock:
            if (self._active or self._failed or
                    self.captures >= self.max_captures):
                return False
            self._active = True
            self.captures += 1
            n = self.captures
            if self.captures >= self.max_captures:
                self.armed = False      # budget spent
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        log_dir = os.path.join(self.out_dir or "torch_profile",
                               f"{safe}_{n:03d}")
        try:
            os.makedirs(log_dir, exist_ok=True)
            _start_trace(log_dir)
        except Exception as exc:
            with self._lock:
                self._active = False
                self._failed = True
                self.armed = False
            Log.warning("span profiler unavailable (%s: %s); device "
                        "capture disabled for this process",
                        type(exc).__name__, exc)
            return False
        Log.info("span profiler: capturing %r -> %s (%d/%d)",
                 name, log_dir, n, self.max_captures)
        return True

    def end(self) -> None:
        try:
            _stop_trace()
        except Exception as exc:
            with self._lock:
                self._failed = True
                self.armed = False
            Log.warning("span profiler: stop_trace failed (%s: %s); "
                        "device capture disabled", type(exc).__name__, exc)
        finally:
            with self._lock:
                self._active = False

    @contextmanager
    def capture(self, name: str):
        """Bracket a region; yields True iff a device trace is live. The
        capture's stop waits for the card (_stop_trace), so its window
        covers the region's asynchronous device work; with no capture
        running the region's launches stay asynchronous."""
        started = self.begin(name)
        try:
            yield started
        finally:
            if started:
                self.end()

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": int(self.armed),
                    "captures": self.captures,
                    "max_captures": self.max_captures,
                    "failed": int(self._failed)}


#: process-wide singleton, configured from Config by the Booster
profiler = SpanProfiler()
