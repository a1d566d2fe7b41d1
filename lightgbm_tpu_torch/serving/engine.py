"""Shape-bucketed device predictor: a bounded set of batch shapes.

The port's copy of lightgbm_tpu/serving/engine.py. In the JAX package
`predict_binned_forest` is jit-compiled per (batch-shape, forest-shape)
pair, so an unconstrained request stream would recompile on every new
size. The port compiles nothing per shape: its forest sum is one launch
of the hand-written kernel csrc/serve_forest.cu, built once. It keeps the
JAX package's power-of-two row buckets all the same, for three reasons:
the snapshot's fields (`buckets_compiled`, `compile_count`,
`bucket_cache_hits`) and the `max_compilations` bound mean what they
mean in the JAX package; a padded batch costs the kernel nothing for its
pad rows (they walk nothing); and every dispatch has one of a bounded set
of shapes, so the caching allocator reuses the same few blocks.

The engine pads every batch up to a power-of-two row bucket in
[min_bucket, max_bucket]: a model is hit by at most
``ceil(log2(max_bucket)) + 1`` distinct shapes, whatever the traffic
looks like. Batches larger than max_bucket are chunked. Pad rows are
marked by the row count the kernel is given (rows from `rows` on are
pad): they come out 0.0 and the real rows are bit-identical to the
unpadded call.

The bucket cache is also the COUNTER the JAX package keeps: a first-seen
(model, bucket) pair is recorded as `compiled` (in the JAX package, an
XLA compilation of the serving predictor; here, the first dispatch of
that shape), a repeat as a hit. Both counts surface in the metrics
snapshot, and observe=True folds them into the compile accounting and
the span trace as the JAX package does.

Each batch is three steps: the bins to the card (a plain copy of the
host array: concurrent batches of two replicas each copy their own, so
nothing is shared), one kernel launch, then the [bucket, K] scores back
to the host, which is the batch's one sync.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..observability import registry as _obs
from ..utils.timer import global_timer
from .forest import DeviceForest

__all__ = ["BucketedPredictor", "next_bucket", "max_compilations"]


def next_bucket(n: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two bucket >= n, clamped to [min_bucket,
    max_bucket]."""
    b = max(min_bucket, 1)
    while b < n and b < max_bucket:
        b <<= 1
    return min(b, max_bucket)


def max_compilations(max_bucket: int) -> int:
    """Upper bound on first-seen buckets per model after warmup."""
    return int(np.ceil(np.log2(max(max_bucket, 2)))) + 1


class BucketedPredictor:
    """Device dispatch through the bucket cache. Thread-safe."""

    def __init__(self, min_bucket: int = 16, max_bucket: int = 1024):
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_bucket")
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self._seen: Dict[Tuple[int, int], int] = {}   # (forest id, bucket)
        self._lock = threading.Lock()
        self.compile_count = 0
        self.hit_count = 0
        self.device_batches = 0

    # ------------------------------------------------------------------
    def counters_for(self, forest: DeviceForest) -> Dict[str, int]:
        with self._lock:
            buckets = [b for (fid, b) in self._seen if fid == id(forest)]
        return {"buckets_compiled": len(buckets),
                "max_compilations": max_compilations(self.max_bucket)}

    def _record(self, forest: DeviceForest, bucket: int) -> bool:
        """Count the dispatch; True when the bucket was already warm."""
        with self._lock:
            key = (id(forest), bucket)
            hit = key in self._seen
            if hit:
                self._seen[key] += 1
                self.hit_count += 1
            else:
                self._seen[key] = 1
                self.compile_count += 1
            self.device_batches += 1
            return hit

    # ------------------------------------------------------------------
    def predict_raw(self, forest: DeviceForest, bins: np.ndarray,
                    metrics=None) -> np.ndarray:
        """[N, F] serving bins -> [N, num_outputs] raw f32 scores.

        `metrics` (serving.metrics.ModelMetrics, optional) receives a
        record_batch per device dispatch: hit = bucket already warm,
        compiled = first sighting of (model, bucket)."""
        from ..learner.predict import predict_binned_forest
        from ..reliability import faults

        # registered fault site: the serving device-dispatch boundary
        # (retry + host-fallback handling live in serving/server.py)
        faults.inject("serving_device_predict")

        n = bins.shape[0]
        if n == 0:
            return np.zeros((0, forest.num_outputs), np.float32)
        device = forest.device
        outs = []
        lo = 0
        while lo < n:
            hi = min(lo + self.max_bucket, n)
            chunk = bins[lo:hi]
            rows = hi - lo
            bucket = next_bucket(rows, self.min_bucket, self.max_bucket)
            if rows < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - rows, chunk.shape[1]),
                                     chunk.dtype)])
            hit = self._record(forest, bucket)
            if metrics is not None:
                metrics.record_batch(bucket_hit=hit, compiled=not hit)
            _t0 = time.perf_counter()
            with global_timer.timeit("serve_device_predict"):
                raw = predict_binned_forest(
                    forest.stacked, forest.tree_class,
                    torch.from_numpy(np.ascontiguousarray(chunk)).to(device),
                    forest.num_bins, forest.missing_is_nan,
                    num_outputs=forest.num_outputs, rows=rows)
                raw = raw.cpu().numpy()    # device -> host sync
            if _obs.enabled:
                # a bucket-cache miss is the first dispatch of this shape
                # (the JAX package's compilation of the serving predictor
                # for it: module docstring); fold it into the unified
                # compile accounting + span trace
                _dt = time.perf_counter() - _t0
                _obs.compiles.record(f"serving_predict_b{bucket}", _dt,
                                     compiled=not hit)
                _obs.trace.add("serve_device_predict", _t0, _dt,
                               bucket=bucket, rows=rows)
            outs.append(raw[:rows])
            lo = hi
        return np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
