"""Micro-batching request queue with admission control.

The port's copy of lightgbm_tpu/serving/batcher.py.

Concurrent small predict requests are coalesced into one device call:
a background worker drains the queue, packing requests until
`max_batch_size` rows are gathered or `max_wait_ms` has elapsed since
the oldest queued request. One device batch then serves them all and
each caller's Future gets its slice back — per-request launch overhead
amortizes across the coalesced batch (the same motivation as the
reference's row-parallel Predictor, but across *requests* instead of
rows).

Two scheduling policies pick WHICH queued requests form the batch:

- ``fifo``: the historical prefix packer — requests dispatch strictly
  in arrival order, and one large request at the head stalls every
  small one behind it until it fits.
- ``slo`` (continuous batching): requests are packed in
  remaining-SLO-budget order with skip-and-fill — a request too large
  for the remaining batch capacity is *skipped*, and later smaller
  requests fill the gap, so small tight-budget requests interleave
  with large ones instead of queueing behind them. Requests without a
  deadline sort as infinite budget (pure FIFO among themselves), and a
  starvation guard promotes anything waiting longer than
  ``_STARVE_FACTOR`` coalescing windows to the front so a large
  request can never be skipped forever. `interleave_count` counts
  requests that jumped a skipped earlier-scheduled one.

Admission control: once `max_queue` requests are waiting, new arrivals
are shed immediately with `OverloadError` instead of growing the queue
without bound — a bounded queue keeps tail latency bounded too.

SLO budgets (the top rung of the degradation ladder, docs/Serving.md):
a request may carry a *deadline*. At submit the batcher projects the
queue wait from an online linear model of batch service time,
``s(rows) = base + rows * slope`` (EMA moments, `_ServiceModel`) — if
the projection already overshoots the remaining budget the request is
shed NOW with `DeadlineExceeded`, while the caller can still answer it
cheaply (host predict), instead of letting it queue, expire, and waste
a device slot. The rows term matters on shared (multi-model pack)
queues: one member's huge batches must not inflate the projection for
another member's 8-row requests — a scalar batch-wall EMA did exactly
that and over-shed small requests. In ``slo`` mode the projection also
counts only queued rows whose budget is at least as tight as the
incoming request's, since looser work is scheduled behind it. Requests
that expire anyway (service time spiked after admission) are expired
at dispatch time, again with `DeadlineExceeded`, never silently
dropped.

`pause()`/`resume()` freeze the worker between batches; tests use this
to enqueue a deterministic set of requests and observe exactly one
coalesced device batch. `clock` is injectable for deterministic
scheduler/admission tests.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np

from ..utils.log import Log

__all__ = ["MicroBatcher", "OverloadError", "BatcherClosed",
           "DeadlineExceeded", "SCHEDULERS"]


class OverloadError(RuntimeError):
    """Request shed by admission control (queue depth exceeded)."""


class DeadlineExceeded(RuntimeError):
    """Request's SLO budget cannot be met by the device queue.

    Raised at submit when the projected queue wait overshoots the
    remaining budget, or set on the future when a queued request
    expires before dispatch. The server's deadline policy decides what
    the caller sees: ``fallback`` answers via host predict, ``fail``
    propagates this error."""


class BatcherClosed(RuntimeError):
    """A queued request's batcher shut down before dispatching it.

    Distinct from a device failure: the request itself is fine, the
    queue is just going away. The server catches this and drains the
    request through the host-predict fallback instead of dropping it
    (and without degrading the model entry)."""


class _Request:
    __slots__ = ("bins", "future", "t_enqueue", "deadline", "slot")

    def __init__(self, bins: np.ndarray,
                 deadline: Optional[float] = None,
                 slot: Optional[int] = None,
                 now: Optional[float] = None):
        self.bins = bins
        self.future: Future = Future()
        self.t_enqueue = time.monotonic() if now is None else now
        self.deadline = deadline      # absolute monotonic, or None
        self.slot = slot              # pack slot (multi-model batchers)


class _ServiceModel:
    """Online linear model of device batch service time:
    ``s(rows) = base + rows * slope``, fit from EMA first/second
    moments of (rows, wall) observations.

    Replaces the scalar batch-wall EMA: on a queue shared by models of
    very different sizes (a `ForestPack`), one member's 1024-row
    batches would drive a scalar EMA to the large-batch wall and the
    admission projection would shed every small-model request sharing
    the device — even though an 8-row dispatch is far cheaper. The
    slope is clamped non-negative (more rows never *predicts* faster)
    and falls back to the plain EMA mean while the observed row sizes
    are degenerate (no variance to fit a slope from)."""

    def __init__(self, seed_s: float, alpha: float = 0.3):
        self._alpha = float(alpha)
        self._base = float(seed_s)
        self._slope = 0.0
        self._er: Optional[float] = None   # EMA rows
        self._edt = float(seed_s)          # EMA wall seconds
        self._erdt = 0.0                   # EMA rows*wall
        self._er2 = 0.0                    # EMA rows^2

    def update(self, rows: int, dt: float) -> None:
        a = self._alpha
        r = float(rows)
        if self._er is None:
            self._er, self._edt = r, float(dt)
            self._erdt, self._er2 = r * dt, r * r
        else:
            self._er += a * (r - self._er)
            self._edt += a * (dt - self._edt)
            self._erdt += a * (r * dt - self._erdt)
            self._er2 += a * (r * r - self._er2)
        var = self._er2 - self._er * self._er
        cov = self._erdt - self._er * self._edt
        if var > 1e-9 and cov > 0.0:
            self._slope = cov / var
            self._base = max(self._edt - self._slope * self._er, 0.0)
        else:
            self._slope = 0.0
            self._base = self._edt

    def projected(self, rows: int) -> float:
        return self._base + self._slope * float(rows)


#: schedulers accepted by MicroBatcher (docs/Serving.md "Continuous
#: batching"): prefix FIFO packing vs remaining-budget skip-and-fill
SCHEDULERS = ("fifo", "slo")


class MicroBatcher:
    """Coalescing queue in front of one model's device predictor.

    `run_batch([N, F] bins) -> [N, num_outputs]` is the only downstream
    dependency; the batcher never touches a device itself.
    """

    #: slo-mode starvation guard: a request waiting longer than this
    #: many coalescing windows goes to the front regardless of budget
    _STARVE_FACTOR = 20.0

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 max_batch_size: int = 1024, max_wait_ms: float = 2.0,
                 max_queue: int = 128, name: str = "model",
                 scheduler: str = "fifo",
                 clock: Callable[[], float] = time.monotonic):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"scheduler must be one of {SCHEDULERS}, got "
                f"'{scheduler}'")
        self._run_batch = run_batch
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.name = name
        self.scheduler = scheduler
        self._clock = clock
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._paused = False
        self._closed = False
        self.shed_count = 0
        self.deadline_shed_count = 0   # budget-projection sheds at submit
        self.deadline_expired_count = 0  # expired while queued
        self.batch_count = 0
        self.coalesced_requests = 0
        self.interleave_count = 0      # requests that jumped a skipped one
        # rows-aware service-time model, seeds the queue-wait
        # projection before the first batch completes
        self._svc = _ServiceModel(max(self.max_wait_ms, 1.0) / 1e3)
        self._worker = threading.Thread(
            target=self._loop, name=f"serve-batcher-{name}", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, bins: np.ndarray,
               deadline: Optional[float] = None,
               slot: Optional[int] = None) -> Future:
        """Queue one request's binned rows; resolves to its raw scores.

        `deadline` is an absolute `time.monotonic()` instant. When the
        projected queue wait (`_projected_wait_locked`) would already
        blow the budget, the request is shed here with
        `DeadlineExceeded` so the caller can still answer it on time
        via the host path. `slot` tags the request for multi-model
        pack batchers (ignored by the plain dispatch)."""
        req = _Request(bins, deadline, slot, now=self._clock())
        with self._lock:
            if self._closed:
                raise BatcherClosed(
                    f"batcher '{self.name}' is closed")
            if len(self._queue) >= self.max_queue:
                self.shed_count += 1
                raise OverloadError(
                    f"serving queue for '{self.name}' is full "
                    f"({self.max_queue} requests waiting)")
            if deadline is not None:
                wait_s = self._projected_wait_locked(len(bins), deadline)
                if req.t_enqueue + wait_s > deadline:
                    self.deadline_shed_count += 1
                    raise DeadlineExceeded(
                        f"serving queue for '{self.name}': projected "
                        f"wait {wait_s * 1e3:.1f}ms exceeds remaining "
                        f"budget "
                        f"{(deadline - req.t_enqueue) * 1e3:.1f}ms")
            self._queue.append(req)
            self._wake.notify()
        return req.future

    def _projected_wait_locked(self, incoming_rows: int,
                               deadline: Optional[float] = None) -> float:
        """Estimated seconds before a request submitted now gets its
        result: device batches ahead of it × the rows-aware service
        model, plus the coalescing window it may itself sit out. In
        ``slo`` mode only queued requests whose budget is at least as
        tight count as "ahead" — looser and deadline-free work is
        scheduled behind the incoming request, so it cannot delay it.

        An EMPTY queue always projects just the coalescing window: the
        service estimate only refreshes when batches actually dispatch,
        so shedding idle-queue requests on a stale estimate (e.g. one
        poisoned by a cold-start compile) would starve the model of the
        very samples that correct it. Caller holds _lock."""
        if self.scheduler == "slo" and deadline is not None:
            ahead = sum(len(r.bins) for r in self._queue
                        if r.deadline is not None and
                        r.deadline <= deadline)
        else:
            ahead = sum(len(r.bins) for r in self._queue)
        if ahead == 0:
            return self.max_wait_ms / 1e3
        rows = ahead + int(incoming_rows)
        batches_ahead = max(
            (rows + self.max_batch_size - 1) // self.max_batch_size, 1)
        per_batch = min(rows, self.max_batch_size)
        return batches_ahead * self._svc.projected(per_batch) + \
            self.max_wait_ms / 1e3

    def pause(self) -> None:
        """Freeze the worker between batches (deterministic tests)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._wake.notify()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self, timeout: float = 5.0,
              drain_queued: bool = True) -> int:
        """Shut the worker down; returns how many queued requests were
        resolved with `BatcherClosed` (the hot-swap `swap_drains`
        accounting).

        ``drain_queued=True`` (plain shutdown) lets the worker dispatch
        whatever is already queued before exiting. ``drain_queued=False``
        (hot-swap) pops the queue immediately so no queued request runs
        against the outgoing forest — each future gets `BatcherClosed`
        and the server re-answers it through the host path of the OLD
        entry (same binning, no torn model)."""
        if drain_queued:
            with self._lock:
                self._closed = True
                self._paused = False
                self._wake.notify()
        else:
            with self._lock:
                pulled, self._queue = self._queue, []
                self._closed = True
                self._paused = False
                self._wake.notify()
            for req in pulled:
                if not req.future.done():
                    req.future.set_exception(BatcherClosed(
                        f"batcher '{self.name}' closed before "
                        f"dispatching this request"))
        self._worker.join(timeout=timeout)
        # with drain_queued=True the worker drains the queue on close
        # (the take condition includes _closed), so leftovers only
        # exist when the join timed out — a wedged device dispatch.
        # Resolve them with BatcherClosed so upstream can re-route each
        # request through the host fallback instead of hanging or
        # dropping its caller.
        with self._lock:
            leftovers, self._queue = self._queue, []
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(BatcherClosed(
                    f"batcher '{self.name}' closed before dispatching "
                    f"this request"))
        drained = len(leftovers)
        if not drain_queued:
            drained += len(pulled)
        return drained

    # ------------------------------------------------------------------
    def _schedule_order_locked(self, now: float) -> List[_Request]:
        """Queue in dispatch-priority order. ``fifo``: arrival order.
        ``slo``: starved requests first, then tightest remaining
        budget (deadline-free = infinite budget), FIFO tie-break.
        Caller holds _lock."""
        if self.scheduler == "fifo":
            return list(self._queue)
        starve_s = self._STARVE_FACTOR * self.max_wait_ms / 1e3

        def key(r: _Request):
            starved = (now - r.t_enqueue) >= starve_s
            budget = (r.deadline - now) if r.deadline is not None \
                else float("inf")
            return (not starved, budget, r.t_enqueue)

        return sorted(self._queue, key=key)

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a coalescible batch is ready (or closed)."""
        with self._lock:
            while True:
                if self._closed and not self._queue:
                    return None
                if self._queue and not self._paused:
                    now = self._clock()
                    oldest = min(r.t_enqueue for r in self._queue)
                    order = self._schedule_order_locked(now)
                    rows = 0
                    take: List[_Request] = []
                    skipped = False
                    interleaves = 0
                    for req in order:
                        if take and rows + len(req.bins) > \
                                self.max_batch_size:
                            if self.scheduler == "fifo":
                                break       # strict prefix packing
                            skipped = True  # skip-and-fill: later,
                            continue        # smaller requests may fit
                        if skipped:
                            interleaves += 1
                        rows += len(req.bins)
                        take.append(req)
                        if rows >= self.max_batch_size:
                            break
                    waited_ms = (now - oldest) * 1e3
                    if (rows >= self.max_batch_size or self._closed or
                            waited_ms >= self.max_wait_ms):
                        taken = {id(r) for r in take}
                        self._queue = [r for r in self._queue
                                       if id(r) not in taken]
                        self.interleave_count += interleaves
                        return take
                    # more coalescing headroom: sleep out the window
                    self._wake.wait(
                        timeout=(self.max_wait_ms - waited_ms) / 1e3)
                    continue
                self._wake.wait(timeout=0.1)

    def _expire_overdue(self, batch: List[_Request]) -> List[_Request]:
        """Resolve requests whose deadline already passed (admission's
        projection was optimistic) with `DeadlineExceeded`; the rest
        dispatch. Never silently drops a future."""
        now = self._clock()
        live: List[_Request] = []
        expired = 0
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                expired += 1
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        f"request expired in '{self.name}' queue "
                        f"({(now - req.t_enqueue) * 1e3:.1f}ms waited)"))
            else:
                live.append(req)
        if expired:
            with self._lock:
                self.deadline_expired_count += expired
        return live

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as exc:
            # worker death is a serving fatal: every queued caller
            # would hang. Post-mortem it, then resolve everything with
            # BatcherClosed so upstream host-drains each request.
            from ..observability.flightrec import recorder
            recorder.record_exception(
                f"serving_batcher_worker[{self.name}]", exc)
            recorder.flush("exception")
            Log.warning(f"serving batcher worker for '{self.name}' "
                        f"died: {exc}")
            with self._lock:
                self._closed = True
                leftovers, self._queue = self._queue, []
            for req in leftovers:
                if not req.future.done():
                    req.future.set_exception(BatcherClosed(
                        f"batcher '{self.name}' worker died before "
                        f"dispatching this request"))
            raise

    def _dispatch(self, batch: List[_Request]) -> None:
        """Run one coalesced batch and resolve its futures (worker
        thread). Subclasses override to change the dispatch shape —
        the pack batcher (serving/multimodel.py) groups requests by
        slot into one fused multi-model launch."""
        bins = batch[0].bins if len(batch) == 1 else \
            np.concatenate([r.bins for r in batch], axis=0)
        raw = self._run_batch(bins)
        lo = 0
        for req in batch:
            hi = lo + len(req.bins)
            req.future.set_result(raw[lo:hi])
            lo = hi

    def _loop_inner(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            batch = self._expire_overdue(batch)
            if not batch:
                continue
            self.batch_count += 1
            self.coalesced_requests += len(batch)
            rows = sum(len(r.bins) for r in batch)
            t0 = time.monotonic()
            try:
                self._dispatch(batch)
            except Exception as exc:  # surface to callers, keep serving
                Log.warning(f"serving batch for '{self.name}' failed: "
                            f"{exc}")
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
            except BaseException:
                # worker is dying (KeyboardInterrupt/SystemExit): this
                # batch was already popped from the queue, so resolve
                # its futures here before _loop's post-mortem handler
                # deals with the rest of the queue
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(BatcherClosed(
                            f"batcher '{self.name}' worker died while "
                            f"dispatching this request"))
                raise
            finally:
                dt = time.monotonic() - t0
                with self._lock:
                    self._svc.update(rows, dt)
