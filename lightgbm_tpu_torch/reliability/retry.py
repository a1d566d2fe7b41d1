"""Capped-exponential-backoff retry for device dispatch boundaries.

Port of lightgbm_tpu/reliability/retry.py. A transient device fault (a
launch that failed, an injected fault) is worth a couple of retries
before a dispatch degrades to its fall-back (fused -> per-iteration,
GBDT.train_many_dispatch) or raises (the growth dispatch, GBDT._grow).
The policy is deliberately tiny: a fixed attempt budget, exponential
backoff with a cap, no jitter (deterministic for tests; the backoff only
lets a wedged runtime drain). An error that persists (a sticky CUDA
error) raises again on every attempt and propagates.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type

from ..utils.log import Log
from .counters import counters

__all__ = ["retry_call"]


def retry_call(fn: Callable, *args,
               attempts: int = 3,
               backoff_ms: float = 50.0,
               backoff_max_ms: float = 2000.0,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               site: str = "",
               on_retry: Callable[[], None] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on failure retry up to `attempts`
    total calls with capped exponential backoff. Each retry increments
    the ``device_retries`` counter and calls `on_retry` (before the
    backoff). The final failure propagates so the caller's degradation
    path still runs."""
    attempts = max(1, int(attempts))
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if attempt == attempts - 1:
                raise
            counters.inc("device_retries")
            if on_retry is not None:
                on_retry()
            delay = min(backoff_ms * (2.0 ** attempt), backoff_max_ms) / 1e3
            Log.warning(
                f"retry {attempt + 1}/{attempts - 1}"
                f"{' at ' + site if site else ''} after {type(exc).__name__}:"
                f" {exc} (backoff {delay * 1e3:.0f}ms)")
            if delay > 0:
                sleep(delay)
