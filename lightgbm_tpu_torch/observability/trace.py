"""Structured spans: thread-safe nesting, ring buffer, trace export.

Port of lightgbm_tpu/observability/trace.py. A span is one timed region
with attributes. Nesting is tracked with a per-thread stack
(`threading.local`), so concurrent threads (the executor's host work, a
server's workers) interleave freely without corrupting each other's
parent/depth bookkeeping. Completed
spans land in one lock-guarded ring (`collections.deque(maxlen=...)`),
oldest-evicted, so tracing a long training run is O(ring) memory.

Export formats:
- JSONL: one span dict per line (jq/pandas-friendly);
- Chrome/Perfetto `trace_event` JSON ("ph": "X" complete events with
  microsecond ts/dur), loadable in chrome://tracing or ui.perfetto.dev.

The disabled path returns a shared no-op context manager — no
allocation, no clock read, one attribute check. Each closed span is
also tapped into the crash flight recorder (flightrec.py), so a
post-mortem bundle carries the recent timeline. Span times are host
clocks: on the card they time dispatch, not the device work behind it.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .flightrec import recorder as _flightrec
from .profile import profiler as _profiler

__all__ = ["Span", "Trace"]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """One live timed region; append itself to the ring on __exit__."""

    __slots__ = ("_trace", "name", "attrs", "start", "duration",
                 "depth", "parent")

    def __init__(self, trace: "Trace", name: str, attrs: Dict):
        self._trace = trace
        self.name = name
        self.attrs = attrs
        self.start = 0.0
        self.duration = 0.0
        self.depth = 0
        self.parent: Optional[str] = None

    def __enter__(self) -> "Span":
        stack = self._trace._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration = time.perf_counter() - self.start
        stack = self._trace._stack()
        # balanced exit is the overwhelmingly common case; an exception
        # unwinding several spans at once still pops each in turn
        if stack and stack[-1] is self:
            stack.pop()
        else:  # pragma: no cover - unbalanced enter/exit
            try:
                stack.remove(self)
            except ValueError:
                pass
        self._trace._append(self.name, self.start, self.duration,
                            self.depth, self.parent, self.attrs)
        return False


class Trace:
    """Span factory + completed-span ring. Thread-safe."""

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(int(capacity), 16))
        self._local = threading.local()
        # open-span stacks by thread id (the same list objects as the
        # threading.local stacks) so the watchdog's heartbeat thread can
        # name another thread's innermost open span
        self._open: Dict[int, List["Span"]] = {}
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()   # same instant, wall clock —
        self.dropped = 0          # spans evicted from the ring

    # ------------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing a region; no-op when disabled. When
        the device profiler is armed for this span name, the region is
        additionally bracketed in a torch.profiler capture."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(self, name, attrs)
        if _profiler.armed and _profiler.matches(name):
            return _ProfiledSpan(sp, name)
        return sp

    def add(self, name: str, start: float, duration: float, **attrs):
        """Record an already-measured region (hot-path hooks measure
        with their own perf_counter reads and call this once, keeping
        the instrumented loop free of context-manager plumbing).
        `start` is a time.perf_counter() timestamp."""
        if not self.enabled:
            return
        self._append(name, start, duration, 0, None, attrs)

    # ------------------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._open[threading.get_ident()] = stack
        return stack

    def innermost_open(self) -> Tuple[str, float]:
        """(name, age_s) of the most recently opened span still open on
        ANY thread; ("", 0.0) when nothing is open. Read cross-thread
        for the watchdog heartbeat payload: stacks are only appended/
        popped under the GIL, so a stale read costs at most one span of
        accuracy in a diagnostic."""
        with self._lock:
            stacks = list(self._open.values())
        best: Optional[Span] = None
        for stack in stacks:
            if stack:
                top = stack[-1]
                if best is None or top.start > best.start:
                    best = top
        if best is None:
            return "", 0.0
        return best.name, max(0.0, time.perf_counter() - best.start)

    def _append(self, name, start, duration, depth, parent, attrs):
        rec = {
            "name": name,
            "dur": duration,                 # seconds
            "tid": threading.get_ident(),
            "depth": depth,
        }
        if parent is not None:
            rec["parent"] = parent
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            # epoch read under the lock: reset() rebinds it concurrently
            rec["ts"] = start - self._epoch  # seconds since trace epoch
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
        # span-close tap for the crash flight recorder (bounded ring,
        # survives as the postmortem timeline — flightrec.py)
        _flightrec.record_span(name, start, duration, depth, parent)

    # ------------------------------------------------------------------
    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=max(int(capacity), 16))

    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()
            self._epoch_wall = time.time()

    @property
    def epoch_wall(self) -> float:
        """Wall-clock instant of the trace epoch: the anchor the
        cross-rank merge (observability/merge.py) uses to place this
        rank's perf_counter-relative timestamps on a shared timeline."""
        with self._lock:
            return self._epoch_wall

    # ------------------------------------------------------------------
    # export
    def to_chrome_trace(self, rank: Optional[int] = None,
                        clock_samples: Optional[List[Dict]] = None
                        ) -> Dict:
        """Chrome/Perfetto `trace_event` format: "X" complete events,
        microsecond timestamps (chrome://tracing, ui.perfetto.dev).
        With `rank`, the document gains rank-tagged process_name
        metadata and a ``lightgbm_tpu_meta`` block (rank, wall-clock
        epoch, piggybacked clock-offset samples) that
        ``python -m lightgbm_tpu_torch.observability merge`` consumes
        (the names are the JAX package's, so either package's merge
        reads either's dumps)."""
        pid = os.getpid()
        events = []
        if rank is not None:
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0,
                           "args": {"name": f"lightgbm_tpu rank {rank}"}})
        for rec in self.spans():
            ev = {
                "name": rec["name"],
                "ph": "X",
                "ts": round(rec["ts"] * 1e6, 3),
                "dur": round(rec["dur"] * 1e6, 3),
                "pid": pid,
                "tid": rec["tid"],
                "cat": "lightgbm_tpu",
            }
            args = dict(rec.get("attrs", ()))
            if "parent" in rec:
                args["parent"] = rec["parent"]
            if args:
                ev["args"] = args
            events.append(ev)
        doc: Dict = {"traceEvents": events, "displayTimeUnit": "ms"}
        if rank is not None:
            doc["lightgbm_tpu_meta"] = {
                "rank": int(rank),
                "epoch_wall": self.epoch_wall,
                "clock_samples": list(clock_samples or ()),
            }
        return doc

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(rec) for rec in self.spans())

    def dump(self, path: str, fmt: Optional[str] = None,
             rank: Optional[int] = None,
             clock_samples: Optional[List[Dict]] = None) -> str:
        """Write the ring to `path`. fmt: "jsonl" | "chrome"; default
        by extension (.jsonl -> JSONL, anything else -> Chrome JSON).
        Returns the format written."""
        if fmt is None:
            fmt = "jsonl" if str(path).endswith(".jsonl") else "chrome"
        with open(path, "w") as fh:
            if fmt == "jsonl":
                fh.write(self.to_jsonl())
                fh.write("\n")
            else:
                json.dump(self.to_chrome_trace(
                    rank=rank, clock_samples=clock_samples), fh)
                fh.write("\n")
        return fmt


class _ProfiledSpan:
    """A Span whose region is additionally captured by the device
    profiler (observability/profile.py). Entering starts the
    torch.profiler capture first so it covers the whole span."""

    __slots__ = ("_span", "_name", "_started")

    def __init__(self, span: Span, name: str):
        self._span = span
        self._name = name
        self._started = False

    def __enter__(self) -> Span:
        self._started = _profiler.begin(self._name)
        return self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        out = self._span.__exit__(*exc)
        if self._started:
            _profiler.end()
        return out
