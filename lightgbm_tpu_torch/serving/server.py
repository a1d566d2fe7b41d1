"""The serving facade: registry + replicas + micro-batcher + metrics.

The port's copy of lightgbm_tpu/serving/server.py. It serves on the card
unless it is asked for the CPU (`device_type="cpu"`); without a card and
without that it raises, as training does (`boosting.gbdt.resolve_device`),
and it never carries on on the CPU by itself.

    server = Server(max_batch_size=512, max_wait_ms=2.0, slo_ms=10.0)
    server.load_model("clf", booster=bst)          # one-time device load
    probs = server.predict("clf", X)               # == bst.predict(X)
    server.hot_swap("clf", booster=bst2)           # under live traffic
    print(json.dumps(server.metrics_snapshot()))

Request path: `predict` bins the rows on the host (cheap integer
quantization), submits them to the model entry's `MicroBatcher` with
the request's SLO deadline, and blocks on the Future; the batcher
worker coalesces concurrent requests into one dispatch that the
entry's `ReplicaSet` routes to the least-loaded healthy replica.
Responses are converted to output space host-side, so results match
`Booster.predict` (device accumulation is f32; see tests for the
tolerance contract, and the padded-row test for the bit-identity of
bucket padding itself).

Degradation ladder (docs/Serving.md): deadline shed at admission ->
per-replica capped-backoff retries -> breaker opens on consecutive
failures and traffic fails over to the next replica -> every replica
open means host predict answers. No rung drops a request, and the
breakers self-heal (half-open probe, auto-close) — there is no sticky
degraded flag anymore.

The host rung is the CPU server's only (`host_fallback`, ROADMAP C29).
On the card a failed launch is sticky and the host would hide a broken
kernel behind correct-looking answers, so there: a dispatch error
reaches the caller (counted in `errors`) without retry or failover; a
model the kernel cannot serve is refused at load; every breaker open
raises `NoReplicaAvailable`; a request past its deadline under
"fallback" is answered late by the device; and a hot swap drains the
old queue through the old forest on the device.

Hot-swap: `hot_swap` builds the new entry completely (replicas placed,
batcher running), publishes it atomically, then drains the OLD entry's
queue — each queued future resolves `BatcherClosed` and is re-answered
through the old entry's host path (same binning, no torn model, no
drop). In-flight device batches finish against the old tensors, which
stay alive until the last reference drops.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from ..reliability import counters, faults
from ..utils.log import Log, LightGBMError
from ..utils.timer import global_timer
from .batcher import (SCHEDULERS, BatcherClosed, DeadlineExceeded,
                      MicroBatcher, OverloadError)
from .engine import BucketedPredictor, max_compilations
from .metrics import timer_totals
from .registry import ModelEntry, ModelRegistry
from .replicas import NoReplicaAvailable, ReplicaSet

__all__ = ["Server", "OverloadError", "DeadlineExceeded"]

#: what the caller sees when a request's SLO budget cannot be met:
#: "fallback" answers it via host predict (still counted as a
#: deadline miss), "fail" raises DeadlineExceeded fast
DEADLINE_POLICIES = ("fallback", "fail")


class Server:
    """Device-resident inference server for LightGBM boosters.

    `device_type` "cuda" (the default; "gpu" and "cuda_exp" are aliases)
    serves from the card's kernels, "cpu" from their plain versions on
    the CPU. `host_fallback` (default: True on the CPU, False on the
    card, where True is refused) says whether host predict answers when
    the device path cannot (module docstring; ROADMAP C29)."""

    def __init__(self, *, max_batch_size: int = 1024,
                 max_wait_ms: float = 2.0, max_queue: int = 128,
                 min_bucket: int = 16, max_bucket: int = 1024,
                 max_models: int = 8, retry_attempts: int = 3,
                 retry_backoff_ms: float = 50.0,
                 retry_backoff_max_ms: float = 2000.0,
                 slo_ms: float = 0.0, deadline_policy: str = "fallback",
                 n_replicas: int = 1, breaker_threshold: int = 3,
                 breaker_cooldown_ms: float = 250.0,
                 scheduler: str = "slo", pack_size: int = 8,
                 device_type: str = "cuda",
                 host_fallback: Optional[bool] = None):
        from ..boosting.gbdt import resolve_device
        # raises without a card unless device_type is "cpu"
        self.device = resolve_device(device_type)
        on_card = self.device.type == "cuda"
        if host_fallback is None:
            host_fallback = not on_card
        if host_fallback and on_card:
            raise ValueError("host_fallback: a server on the card never "
                             "answers from the host")
        self.host_fallback = bool(host_fallback)
        if deadline_policy not in DEADLINE_POLICIES:
            raise ValueError(
                f"deadline_policy must be one of {DEADLINE_POLICIES}")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}")
        if pack_size < 1:
            raise ValueError("pack_size must be >= 1")
        self.engine = BucketedPredictor(min_bucket=min_bucket,
                                        max_bucket=max_bucket)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_max_ms = float(retry_backoff_max_ms)
        self.slo_ms = float(slo_ms)          # 0 disables deadlines
        self.deadline_policy = deadline_policy
        self.n_replicas = int(n_replicas)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.scheduler = scheduler
        self.pack_size = int(pack_size)
        self.registry = ModelRegistry(
            max_models=max_models,
            replica_factory=self._build_replicas,
            batcher_factory=self._build_batcher,
            pack_batcher_factory=self._build_pack_batcher,
            device=self.device, host_fallback=self.host_fallback)
        self._lock = threading.Lock()
        self._closed = False
        self._metrics_server = None

    @classmethod
    def from_config(cls, config) -> "Server":
        """Build from a Config carrying the serve_*/retry_* parameters
        and device_type."""
        return cls(max_batch_size=config.serve_max_batch_size,
                   max_wait_ms=config.serve_max_wait_ms,
                   max_queue=config.serve_max_queue,
                   min_bucket=config.serve_min_bucket,
                   max_bucket=config.serve_max_bucket,
                   max_models=config.serve_max_models,
                   retry_attempts=config.retry_max_attempts,
                   retry_backoff_ms=config.retry_backoff_ms,
                   retry_backoff_max_ms=config.retry_backoff_max_ms,
                   slo_ms=config.serve_slo_ms,
                   deadline_policy=config.serve_deadline_policy,
                   n_replicas=config.serve_replicas,
                   breaker_threshold=config.serve_breaker_threshold,
                   breaker_cooldown_ms=config.serve_breaker_cooldown_ms,
                   scheduler=config.serve_scheduler,
                   pack_size=config.serve_pack_size,
                   device_type=config.device_type)

    # ------------------------------------------------------------------
    # registry factories: each entry owns its replica fleet + batcher
    def _build_replicas(self, forest, name: str) -> ReplicaSet:
        return ReplicaSet.build(
            forest, self.n_replicas, name=name,
            breaker_threshold=self.breaker_threshold,
            breaker_cooldown_ms=self.breaker_cooldown_ms,
            device=self.device, contain_errors=self.host_fallback)

    def _build_batcher(self, entry: ModelEntry) -> MicroBatcher:
        return MicroBatcher(
            self._make_runner(entry),
            max_batch_size=self.max_batch_size,
            max_wait_ms=self.max_wait_ms,
            max_queue=self.max_queue, name=entry.name,
            scheduler=self.scheduler)

    def _build_pack_batcher(self, pe):
        from .multimodel import PackBatcher
        return PackBatcher(
            self._make_pack_runner(pe),
            max_batch_size=self.max_batch_size,
            max_wait_ms=self.max_wait_ms,
            max_queue=self.max_queue, name=pe.name,
            scheduler=self.scheduler)

    def _make_runner(self, entry: ModelEntry):
        # closes over the ENTRY, not the name: a hot-swap can never
        # route this batcher's queued bins to a different forest
        def run(bins: np.ndarray) -> np.ndarray:
            if entry.replicas is None or len(entry.replicas) == 0:
                raise NoReplicaAvailable(
                    f"model '{entry.name}' has no device replicas")
            return entry.replicas.dispatch(
                self.engine, bins, metrics=entry.metrics,
                retry_attempts=self.retry_attempts,
                retry_backoff_ms=self.retry_backoff_ms,
                retry_backoff_max_ms=self.retry_backoff_max_ms)
        return run

    def _make_pack_runner(self, pe):
        # closes over the PackEntry: a pack rebuild publishes a new
        # entry with a new batcher+runner, so queued (slot, bins) can
        # never score against a different pack layout
        from .multimodel import dispatch_pack

        def run(reqs) -> np.ndarray:
            if pe.replicas is None or len(pe.replicas) == 0:
                raise NoReplicaAvailable(
                    f"pack '{pe.name}' has no device replicas")

            def attempt(rep):
                return dispatch_pack(self.engine, rep.forest, reqs,
                                     metrics_by_slot=pe.slot_metrics,
                                     pack_metrics=pe.metrics)

            return pe.replicas.dispatch(
                self.engine, None, metrics=pe.metrics,
                attempt_fn=attempt,
                retry_attempts=self.retry_attempts,
                retry_backoff_ms=self.retry_backoff_ms,
                retry_backoff_max_ms=self.retry_backoff_max_ms)
        return run

    # ------------------------------------------------------------------
    # lifecycle
    def load_model(self, name: str, booster=None,
                   model_file: Optional[str] = None,
                   model_str: Optional[str] = None) -> ModelEntry:
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
        with global_timer.timeit("serve_model_load"):
            entry = self.registry.load(name, booster=booster,
                                       model_file=model_file,
                                       model_str=model_str)
        return entry

    def load_pack(self, pack_name: str, members):
        """Load several models as fused multi-model packs.

        `members` is a sequence of ``(name, booster)`` pairs (or
        ``(name, {"model_file": ...})`` dicts). Members are packed in
        chunks of at most `pack_size`; chunk ``i > 0`` gets the pack
        name ``f"{pack_name}/{i}"``. Each member still answers
        `predict(name, ...)` under its own name — packing only changes
        HOW the device dispatch happens (one fused launch for the
        whole pack instead of one per model). Returns the member
        entries in input order."""
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
        members = list(members)
        entries = []
        with global_timer.timeit("serve_model_load"):
            for i in range(0, len(members), self.pack_size):
                chunk = members[i:i + self.pack_size]
                nm = pack_name if i == 0 else \
                    f"{pack_name}/{i // self.pack_size}"
                entries.extend(self.registry.load_pack(nm, chunk))
        return entries

    def hot_swap(self, name: str, booster=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> ModelEntry:
        """Zero-downtime model swap under live traffic.

        Builds the replacement entry fully (device replicas placed,
        fresh breakers closed, batcher worker running), publishes it
        atomically, then closes the old entry's batcher WITHOUT
        dispatching its queue — those futures resolve `BatcherClosed`
        and the server re-answers each through the OLD entry's host
        path (`swap_drains` in metrics); without the host rung (the
        card) the old worker dispatches them through the OLD forest
        before it stops. New requests route to the new
        entry the moment it is published; in-flight device batches
        finish against the old arrays. No request is dropped or served
        by a torn model."""
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
        if name not in self.registry:
            raise LightGBMError(f"model '{name}' is not loaded")
        with global_timer.timeit("serve_hot_swap"):
            # registered fault site: a swap that dies mid-way must
            # leave the old entry serving (docs/Reliability.md)
            faults.inject("serving_hot_swap")
            entry, prev = self.registry._load_prepared(
                name, booster=booster, model_file=model_file,
                model_str=model_str)
            # registered fault site, the other side of the commit
            # point: the NEW entry is already published, so a kill here
            # must leave the new model serving with the old batcher's
            # queue drained by the recovery path, never a torn registry
            faults.inject("serving_hot_swap_commit")
            drained = self.registry._drain_replaced(prev)
        Log.info(f"serving: hot-swapped '{name}' to v{entry.version} "
                 f"({drained} queued requests drained)")
        return entry

    def refresh_model(self, name: str, booster=None,
                      model_file: Optional[str] = None,
                      model_str: Optional[str] = None) -> ModelEntry:
        """Swap in a new model version (alias of `hot_swap`; breakers
        start closed on the new entry's replicas)."""
        return self.hot_swap(name, booster=booster,
                             model_file=model_file, model_str=model_str)

    def evict_model(self, name: str) -> bool:
        return self.registry.evict(name)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            msrv, self._metrics_server = self._metrics_server, None
        if msrv is not None:
            msrv.close()
        for name in self.registry.names():
            self.registry.evict(name)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # request path
    def predict(self, name: str, X, raw_score: bool = False,
                timeout: Optional[float] = None,
                slo_ms: Optional[float] = None) -> np.ndarray:
        """Score one request; blocks until its coalesced batch lands.

        Matches `Booster.predict(X, raw_score=raw_score)` output shape
        and values. Raises OverloadError when shed by admission
        control; DeadlineExceeded when the SLO budget is blown and the
        deadline policy is "fail"."""
        try:
            return self.predict_async(name, X, raw_score=raw_score,
                                      slo_ms=slo_ms) \
                .result(timeout=timeout)
        except (OverloadError, DeadlineExceeded, LightGBMError):
            raise                       # protocol outcomes, not crashes
        except Exception as exc:
            # serving fatal: an unhandled error escaping the request
            # path gets a post-mortem like training fatals do
            from ..observability.flightrec import recorder
            recorder.record_exception(f"serving.predict[{name}]", exc)
            recorder.flush("exception")
            raise

    def predict_async(self, name: str, X, raw_score: bool = False,
                      slo_ms: Optional[float] = None) -> Future:
        """Non-blocking predict: a Future of the converted scores.

        `slo_ms` overrides the server-wide SLO budget for this request
        (0 disables the deadline)."""
        entry = self.registry.get(name)
        t0 = time.perf_counter()
        budget_ms = self.slo_ms if slo_ms is None else float(slo_ms)
        deadline = (time.monotonic() + budget_ms / 1e3) \
            if budget_ms > 0 else None
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        out: Future = Future()
        if entry.degraded:
            # unsupported forest, or every replica breaker open with
            # cooldowns pending: the bottom rung answers directly (on
            # the card unsupported forests are refused at load)
            if not self.host_fallback:
                entry.metrics.record_error()
                raise NoReplicaAvailable(
                    f"model '{name}': every replica's breaker is open")
            self._host_resolve(entry, X, raw_score, t0, out)
            return out
        with global_timer.timeit("serve_bin_rows"):
            bins = entry.forest.bin_rows(X)
        try:
            self._submit(entry, X, bins, raw_score, t0, out, deadline)
        except DeadlineExceeded:
            # admission projection says the queue cannot make the
            # budget: answer NOW per policy instead of queueing a
            # request that would expire
            entry.metrics.record_deadline_miss()
            if self.deadline_policy == "fail":
                raise
            if self.host_fallback:
                self._host_resolve(entry, X, raw_score, t0, out)
            else:
                # the card's "fallback": the device answers it late
                self._submit(entry, X, bins, raw_score, t0, out, None)
        except BatcherClosed:
            # lost the race with a concurrent hot-swap/evict closing
            # this entry's batcher: the entry in hand still answers
            if self.host_fallback:
                self._host_resolve(entry, X, raw_score, t0, out)
                return out
            # on the card the published entry answers; an evicted name
            # raises LightGBMError here
            if self.registry.get(name) is entry:
                raise
            return self.predict_async(name, X, raw_score=raw_score,
                                      slo_ms=slo_ms)
        return out

    def _submit(self, entry: ModelEntry, X: np.ndarray, bins: np.ndarray,
                raw_score: bool, t0: float, out: Future, deadline) -> None:
        """Queue `bins` on the entry's batcher (a pack member's: the
        pack's) and resolve `out` from the coalesced batch's raw
        scores. Raises what `submit` raises."""
        name = entry.name
        # pack members share the PACK's slot-aware queue; solo models
        # keep their own
        batcher = entry.batcher if entry.pack is None \
            else entry.pack.batcher
        if batcher is None:
            if not self.host_fallback:
                raise NoReplicaAvailable(
                    f"model '{name}' has no device batcher")
            self._host_resolve(entry, X, raw_score, t0, out)
            return
        try:
            raw_future = batcher.submit(
                bins, deadline=deadline,
                slot=entry.pack_slot if entry.pack is not None else None)
        except OverloadError:
            entry.metrics.record_shed()
            raise

        def _device_error(exc: BaseException) -> None:
            # the card's server: what failed on the device is the
            # caller's to see, never re-answered by the host (C29)
            entry.metrics.record_error()
            Log.warning(f"serving model '{name}': device predict failed "
                        f"({type(exc).__name__}: {exc})")
            out.set_exception(exc)

        def _finish(fut: Future) -> None:
            try:
                raw = fut.result()
            except BatcherClosed as exc:
                # hot-swap/shutdown drain: the queue went away, the
                # model is fine — answer through THIS entry's host
                # path (same binning as the queued bins; no torn model).
                # On the card the old worker dispatched the queue, so
                # only a wedged worker's leftovers land here
                if not self.host_fallback:
                    _device_error(exc)
                    return
                Log.info(
                    f"serving model '{name}': draining request through "
                    f"host predict on batcher shutdown")
                self._host_resolve(entry, X, raw_score, t0, out)
                return
            except DeadlineExceeded as exc:
                # expired while queued (service time spiked after
                # admission let it in)
                entry.metrics.record_deadline_miss()
                if self.deadline_policy == "fail":
                    out.set_exception(exc)
                    return
                if self.host_fallback:
                    self._host_resolve(entry, X, raw_score, t0, out)
                    return
                try:
                    # the card's "fallback": queued again, no deadline
                    self._submit(entry, X, bins, raw_score, t0, out, None)
                except Exception as exc2:
                    _device_error(exc2)
                return
            except Exception as exc:
                if not self.host_fallback:
                    _device_error(exc)
                    return
                if isinstance(exc, NoReplicaAvailable):
                    # every replica breaker refused this batch: the
                    # host answers while the cooldowns run; breakers
                    # will probe and self-heal on the next dispatches
                    self._host_resolve(entry, X, raw_score, t0, out)
                    return
                # unexpected failure past retries+failover: the host
                # still answers, and it is counted as an error
                entry.metrics.record_error()
                Log.warning(
                    f"serving model '{name}': device predict failed "
                    f"({exc}); falling back to host predict")
                self._host_resolve(entry, X, raw_score, t0, out)
                return
            try:
                if entry.pack is not None:
                    # the fused kernel scores into the pack's padded
                    # output width; this member's columns come first
                    raw = raw[:, :entry.forest.num_outputs]
                res = entry.forest.convert_raw(raw, raw_score=raw_score)
            except Exception as exc:
                out.set_exception(exc)
                return
            entry.metrics.record_request(len(X), time.perf_counter() - t0)
            out.set_result(res)
        raw_future.add_done_callback(_finish)

    def _host_resolve(self, entry: ModelEntry, X: np.ndarray,
                      raw_score: bool, t0: float, out: Future) -> None:
        """Serve via Booster/HostModel predict (CPU fallback path)."""
        try:
            with global_timer.timeit("serve_host_fallback"):
                res = entry.booster.predict(X, raw_score=raw_score)
        except Exception as exc:
            entry.metrics.record_error()
            out.set_exception(exc)
            return
        entry.metrics.record_request(len(X), time.perf_counter() - t0,
                                     fallback=True)
        counters.inc("fallbacks")
        out.set_result(res)

    # test/ops hook: the model's queue (pause/resume/queue_depth);
    # pack members answer with the pack's shared queue
    def batcher(self, name: str) -> MicroBatcher:
        entry = self.registry.get(name)
        return entry.batcher if entry.pack is None \
            else entry.pack.batcher

    # test/ops hook: the model's replica fleet (breakers, failovers)
    def replicas(self, name: str) -> ReplicaSet:
        entry = self.registry.get(name)
        return entry.replicas if entry.pack is None \
            else entry.pack.replicas

    # ------------------------------------------------------------------
    # metrics
    def metrics_snapshot(self, name: Optional[str] = None) -> Dict:
        """JSON-able snapshot: per-model request metrics + per-replica
        breaker state + engine-wide bucket-cache counters + serve_*
        timer phase totals."""
        names = [name] if name is not None else self.registry.names()
        models = {}
        for nm in names:
            entry = self.registry.get(nm)
            snap = entry.metrics.snapshot()
            snap.update(self.engine.counters_for(entry.forest))
            snap["version"] = entry.version
            snap["degraded"] = entry.degraded
            snap["device_resident"] = entry.forest.supported
            if entry.pack is not None:
                snap["pack"] = entry.pack.name
                snap["pack_slot"] = entry.pack_slot
            if entry.replicas is not None:
                rsnap = entry.replicas.snapshot()
                snap["replica_count"] = rsnap["replica_count"]
                snap["breaker_open_replicas"] = \
                    rsnap["breaker_open_replicas"]
                snap["replicas"] = rsnap["replicas"]
            batcher = entry.batcher
            if batcher is not None:
                snap["queue_depth"] = batcher.queue_depth()
                snap["coalesced_batches"] = batcher.batch_count
                snap["coalesced_requests"] = batcher.coalesced_requests
                snap["deadline_shed_count"] = batcher.deadline_shed_count
                snap["deadline_expired_count"] = \
                    batcher.deadline_expired_count
            models[nm] = snap
        packs = {}
        for pname, pe in self.registry.packs().items():
            psnap = pe.metrics.snapshot()
            psnap["version"] = pe.version
            psnap["members"] = list(pe.member_names())
            psnap["num_slots"] = pe.pack.num_slots
            psnap["num_trees"] = pe.pack.num_trees
            if pe.replicas is not None:
                rsnap = pe.replicas.snapshot()
                psnap["replica_count"] = rsnap["replica_count"]
                psnap["breaker_open_replicas"] = \
                    rsnap["breaker_open_replicas"]
            if pe.batcher is not None:
                psnap["inflight"] = pe.batcher.queue_depth()
                psnap["coalesced_batches"] = pe.batcher.batch_count
                psnap["interleaves"] = pe.batcher.interleave_count
                psnap["deadline_shed_count"] = \
                    pe.batcher.deadline_shed_count
                psnap["deadline_expired_count"] = \
                    pe.batcher.deadline_expired_count
            packs[pname] = psnap
        return {
            "models": models,
            "packs": packs,
            "engine": {
                "pack_rebuilds": self.registry.pack_rebuilds,
                "compile_count": self.engine.compile_count,
                "bucket_cache_hits": self.engine.hit_count,
                "device_batches": self.engine.device_batches,
                "min_bucket": self.engine.min_bucket,
                "max_bucket": self.engine.max_bucket,
                "max_compilations_per_model":
                    max_compilations(self.engine.max_bucket),
            },
            "timers": timer_totals(),
        }

    def save_metrics(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.metrics_snapshot(), fh, indent=2)
            fh.write("\n")

    def prometheus_text(self) -> str:
        """Prometheus text-exposition (0.0.4) body: per-model request
        metrics (label model="<name>"), per-replica breaker gauges
        (labels model=, replica=), engine-wide bucket-cache counters,
        serve timers, plus the process-global observability registry
        (training telemetry, compiles, MFU, reliability)."""
        from ..observability import registry as _obs
        from ..observability.export import render_prometheus
        snap = self.metrics_snapshot()
        sections = []
        for nm, m in snap["models"].items():
            reps = m.pop("replicas", [])
            sections.append((m, "lightgbm_tpu_serving_model",
                             {"model": nm}))
            for rep in reps:
                sections.append((
                    {"breaker_state": rep["state_code"],
                     "breaker_opens": rep["opens"],
                     "breaker_closes": rep["closes"],
                     "breaker_probes": rep["probes"],
                     "inflight": rep["inflight"],
                     "dispatches": rep["dispatches"],
                     "failures": rep["failures"]},
                    "lightgbm_tpu_serving_replica",
                    {"model": nm, "replica": str(rep["replica"])}))
        for pname, p in snap.get("packs", {}).items():
            p = dict(p)
            p.pop("members", None)
            sections.append((p, "lightgbm_tpu_multimodel",
                             {"pack": pname}))
        sections.append((snap["engine"], "lightgbm_tpu_serving_engine",
                         None))
        return render_prometheus(sections) + _obs.prometheus_text()

    def start_metrics_server(self, port: int = 0,
                             host: str = "127.0.0.1"):
        """Expose GET /metrics (Prometheus text), /healthz and
        /snapshot (JSON metrics_snapshot) on a daemon thread; port 0
        binds an ephemeral port. Returns the MetricsHTTPServer (its
        `.port`/`.url` carry the bound address); closed with the
        Server. Idempotent — a second call returns the running one."""
        from ..observability.export import MetricsHTTPServer
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._metrics_server is None:
                self._metrics_server = MetricsHTTPServer(
                    self.prometheus_text, self.metrics_snapshot,
                    host=host, port=port)
                Log.info("serving metrics at %s",
                         self._metrics_server.url)
            srv = self._metrics_server
        return srv
