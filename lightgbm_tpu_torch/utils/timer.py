"""Named-phase accumulating timers.

Port of lightgbm_tpu/utils/timer.py. Reference: Common::Timer /
FunctionTimer RAII profiling accumulators (include/LightGBM/utils/
common.h:973,1037; printed at exit under USE_TIMETAG) plus one
process-global registry `global_timer` (src/boosting/gbdt.cpp:20).

These are host clocks: on the card they time the host's side of a phase,
its launches and whatever waits it makes, not the device work queued
behind them (kernels run asynchronously). For the device side,
observability/profile.py brackets torch.profiler captures around named
spans (``profile_spans=`` globs, e.g. ``pipeline_block,grow_tree``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

__all__ = ["Timer", "global_timer"]


class Timer:
    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timeit(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - start
            self._count[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._acc[name] += seconds
        self._count[name] += 1

    def totals(self) -> Dict[str, float]:
        return dict(self._acc)

    def report(self) -> str:
        lines = ["LightGBM-TPU phase timings:"]
        for name in sorted(self._acc, key=self._acc.get, reverse=True):
            lines.append(f"  {name}: {self._acc[name]:.3f}s "
                         f"(x{self._count[name]})")
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()
        self._count.clear()


global_timer = Timer()
