"""Serving chaos + load harness: prove the degradation ladder under fire.

The port's copy of lightgbm_tpu/testing/chaos_serve.py, training with
the port (`dyadic_booster`, on the device `device_type` names). What
the serving tests and chip_smoke.py's serving phase drive:

1. a **dyadic booster** — a real trained model whose leaf values are
   rewritten to multiples of 2^-10 with bounded magnitude, so every
   partial sum is exactly representable in BOTH f32 (device) and f64
   (host). Raw scores from the device path are then *bit-identical* to
   `Booster.predict(X, raw_score=True)`, which turns "no torn model,
   no wrong answer under chaos" into `np.array_equal`, not a
   tolerance;
2. **load generation** — closed-loop (k workers, back-to-back) and
   open-loop (target-QPS arrival schedule, rampable across stages),
   both with heavy-tailed request sizes (bounded Pareto), hammering
   `Server.predict` / `predict_async` from many threads;
3. **chaos** — while the load runs, the fault registry kills replica
   dispatches (`serving_replica_predict`), a breaker is forced open,
   and the model is hot-swapped mid-ramp; the ledger then proves zero
   requests dropped or hung, every answer bit-identical to host
   predict, and the breaker observed opening, probing and re-closing.

Every request lands in a `RequestRecord` ledger row — outcome, row
slice, latency, answer — so assertions are exact accounting, not
sampling.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["dyadic_booster", "dyadic_copy", "heavy_tailed_sizes",
           "RequestRecord",
           "LoadResult", "run_closed_loop", "run_open_loop",
           "verify_bit_identical", "DYADIC_BITS"]

#: leaf values are quantized to multiples of 2**-DYADIC_BITS; with
#: magnitudes < 2**4 and < 2**10 trees, every partial raw-score sum
#: needs at most 4+10+10 = 24 mantissa bits — exact in f32 AND f64,
#: so accumulation order cannot change a single bit
DYADIC_BITS = 10

_LEAF_LINE = re.compile(r"^(leaf_value=)(.*)$", re.M)


def _quantize(tok: str) -> str:
    q = 2.0 ** -DYADIC_BITS
    v = np.clip(round(float(tok) / q) * q, -8.0, 8.0)
    return repr(float(v))


def dyadic_copy(booster):
    """A Booster loaded from `booster`'s model text with every leaf value
    rewritten to a dyadic rational (a multiple of 2^-10, |v| <= 8): its
    device raw scores are bit-identical to its host raw predict."""
    txt = booster.model_to_string()

    def _requantize(m: re.Match) -> str:
        vals = m.group(2).split()
        return m.group(1) + " ".join(_quantize(v) for v in vals)

    from ..basic import Booster
    return Booster(model_str=_LEAF_LINE.sub(_requantize, txt))


def dyadic_booster(n: int = 1200, f: int = 8, trees: int = 12,
                   seed: int = 3, num_leaves: int = 15,
                   device_type: str = "cuda"):
    """Train a regression booster with the port on `device_type`, then
    rewrite its leaf values to dyadic rationals (dyadic_copy).

    Returns (booster, X): device raw scores for any subset of X are
    bit-identical to `booster.predict(..., raw_score=True)` (f32 and
    f64 accumulation both being exact), so chaos assertions can demand
    equality instead of tolerance."""
    from .. import Dataset, train
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = X[:, 0] * 1.5 - 0.7 * X[:, 1] + 0.3 * rng.randn(n)
    bst = train({"objective": "regression", "num_leaves": num_leaves,
                 "verbosity": -1, "boost_from_average": False,
                 "min_data_in_leaf": 10, "device_type": device_type},
                Dataset(X, label=y), num_boost_round=trees)
    return dyadic_copy(bst), X


def heavy_tailed_sizes(rng: np.random.RandomState, count: int,
                       max_rows: int = 64) -> np.ndarray:
    """Bounded-Pareto request sizes: mostly tiny, occasionally near
    `max_rows` — the batch mix that stresses coalescing + bucketing."""
    sizes = 1 + (rng.pareto(1.3, size=count) * 2.0).astype(np.int64)
    return np.clip(sizes, 1, max_rows)


# ----------------------------------------------------------------------
@dataclass
class RequestRecord:
    idx: int
    lo: int                        # row slice [lo, hi) into the X pool
    hi: int
    outcome: str = "pending"       # ok | shed | deadline | error | hang
    latency_ms: float = 0.0
    value: Optional[np.ndarray] = None
    error: str = ""
    model: str = ""                # multi-model load: which name served it
    t_issue: float = 0.0           # perf_counter() when it was issued


@dataclass
class LoadResult:
    records: List[RequestRecord] = field(default_factory=list)
    wall_s: float = 0.0

    def by_outcome(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.outcome] = out.get(r.outcome, 0) + 1
        return out

    @property
    def issued(self) -> int:
        return len(self.records)

    @property
    def completed(self) -> int:
        """Requests that got a definitive answer or protocol error —
        anything except pending/hang counts as accounted for."""
        return sum(1 for r in self.records
                   if r.outcome not in ("pending", "hang"))

    @property
    def dropped(self) -> int:
        """Requests left hanging or unresolved: the chaos tests demand
        exactly zero of these."""
        return self.issued - self.completed

    def ok_records(self) -> List[RequestRecord]:
        return [r for r in self.records if r.outcome == "ok"]

    def qps(self) -> float:
        return (len(self.ok_records()) / self.wall_s) \
            if self.wall_s > 0 else 0.0

    def latency_percentiles(self) -> Dict[str, float]:
        lats = [r.latency_ms for r in self.ok_records()]
        if not lats:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
        arr = np.asarray(lats)
        return {f"p{p}_ms": round(float(np.percentile(arr, p)), 3)
                for p in (50, 95, 99)}


def _issue(server, name: str, X: np.ndarray, rec: RequestRecord,
           raw_score: bool, timeout_s: float) -> None:
    from ..serving import DeadlineExceeded, OverloadError
    t0 = rec.t_issue = time.perf_counter()
    try:
        rec.value = server.predict(rec.model or name, X[rec.lo:rec.hi],
                                   raw_score=raw_score,
                                   timeout=timeout_s)
        rec.outcome = "ok"
    except OverloadError:
        rec.outcome = "shed"
    except DeadlineExceeded:
        rec.outcome = "deadline"
    except TimeoutError:
        rec.outcome = "hang"       # the one outcome chaos must forbid
    except Exception as exc:       # noqa: BLE001 — ledger, not handler
        rec.outcome = "error"
        rec.error = f"{type(exc).__name__}: {exc}"
    rec.latency_ms = (time.perf_counter() - t0) * 1e3


def run_closed_loop(server, name: str, X: np.ndarray, *,
                    n_requests: int = 200, workers: int = 4,
                    max_rows: int = 64, raw_score: bool = True,
                    timeout_s: float = 30.0, seed: int = 0,
                    mid_run=None) -> LoadResult:
    """`workers` threads issue back-to-back predicts until `n_requests`
    are done. `mid_run(k)` (optional) is called once, by the thread
    that runs this function, after ~k/2 requests — the chaos hook
    (force a breaker open, hot-swap, arm faults) runs while traffic is
    live."""
    rng = np.random.RandomState(seed)
    sizes = heavy_tailed_sizes(rng, n_requests, max_rows)
    starts = rng.randint(0, max(len(X) - max_rows, 1), size=n_requests)
    records = [RequestRecord(i, int(starts[i]),
                             int(starts[i] + sizes[i]))
               for i in range(n_requests)]
    next_idx = [0]
    lock = threading.Lock()
    fired = threading.Event()

    def _worker():
        while True:
            with lock:
                if next_idx[0] >= n_requests:
                    return
                i = next_idx[0]
                next_idx[0] += 1
            if mid_run is not None and i >= n_requests // 2 and \
                    not fired.is_set():
                if not fired.is_set():
                    fired.set()
                    mid_run(i)
            _issue(server, name, X, records[i], raw_score, timeout_s)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=_worker, daemon=True)
               for _ in range(max(workers, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s * 2)
    res = LoadResult(records=records,
                     wall_s=time.perf_counter() - t0)
    return res


def run_open_loop(server, name: str, X: np.ndarray, *,
                  stages: Sequence[Tuple[float, float]],
                  max_rows: int = 64, raw_score: bool = True,
                  timeout_s: float = 30.0, seed: int = 0,
                  mid_run=None,
                  names: Optional[Sequence[str]] = None) -> LoadResult:
    """Open-loop load: requests arrive on a fixed schedule regardless
    of completion (the honest way to measure tail latency — a closed
    loop self-throttles when the server slows). `stages` is a QPS ramp
    of (qps, duration_s) pairs. `mid_run(stage_index)` fires at each
    stage boundary past the first. `names` spreads the load uniformly
    over several served models (multi-model/pack benches); each
    record's `model` field says which one answered it."""
    rng = np.random.RandomState(seed)
    records: List[RequestRecord] = []
    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    idx = 0
    for si, (qps, duration_s) in enumerate(stages):
        if si and mid_run is not None:
            mid_run(si)
        n = max(int(qps * duration_s), 1)
        gaps = np.full(n, 1.0 / max(qps, 1e-9))
        sizes = heavy_tailed_sizes(rng, n, max_rows)
        starts = rng.randint(0, max(len(X) - max_rows, 1), size=n)
        picks = rng.randint(0, len(names), size=n) \
            if names else np.zeros(n, np.int64)
        stage_t0 = time.perf_counter()
        for k in range(n):
            rec = RequestRecord(idx, int(starts[k]),
                                int(starts[k] + sizes[k]),
                                model=names[picks[k]] if names else "")
            idx += 1
            records.append(rec)
            th = threading.Thread(
                target=_issue, args=(server, name, X, rec, raw_score,
                                     timeout_s), daemon=True)
            th.start()
            threads.append(th)
            # pace arrivals against the wall clock, not per-request
            # sleep drift
            target = stage_t0 + float(np.sum(gaps[:k + 1]))
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
    for th in threads:
        th.join(timeout=timeout_s * 2)
    return LoadResult(records=records,
                      wall_s=time.perf_counter() - t_start)


def verify_bit_identical(result: LoadResult, booster,
                         X: np.ndarray, boosters=None) -> int:
    """Every 'ok' answer must equal the host predict of the same rows,
    bit for bit (requires a `dyadic_booster` model and raw_score=True
    load). Multi-model loads pass `boosters` ({name: booster}) so each
    record checks against ITS model. Returns how many records were
    checked; raises AssertionError with the first mismatch otherwise."""
    checked = 0
    for rec in result.ok_records():
        ref_bst = boosters[rec.model] if boosters and rec.model \
            else booster
        ref = ref_bst.predict(X[rec.lo:rec.hi], raw_score=True)
        assert np.array_equal(np.asarray(rec.value), ref), (
            f"request {rec.idx} rows [{rec.lo},{rec.hi}) "
            f"model '{rec.model}' diverged from host predict")
        checked += 1
    return checked
