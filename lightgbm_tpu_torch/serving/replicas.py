"""Replica fleet: one model's DeviceForest on several local devices.

The port's copy of lightgbm_tpu/serving/replicas.py: serving that scales
past a single card and survives one of them failing. A `ReplicaSet`
places a loaded `DeviceForest` on the server's devices (`place_on`, a
`.to(device)` of the stacked tensors, which are never written after the
build, so replicas share nothing mutable) and routes each coalesced
batch to the least-loaded replica whose circuit breaker grants the
dispatch (`breaker.py`).

The devices are the server's: `cuda:i` for every i below
`torch.cuda.device_count()` when it serves on the card, else the CPU.
Replica i goes on device i modulo their number, so on one card two
replicas share the same tensors (and the bucket cache stays warm across
them), as the JAX package shares them on a one-device host. Each replica
launches on its own device: the engine hands the kernel wrappers tensors
of the replica's device, and `_cuda.call` switches to it for the launch
(a batcher worker thread's current device is cuda:0).

Failure handling is the degradation ladder's middle rungs: a replica
dispatch gets the standard capped-backoff retries; if it still fails
(or returns non-finite scores — a deterministic forest would reproduce
those on every retry, so they fail the replica immediately), the
replica's breaker records the failure and the batch FAILS OVER to the
next available replica. Only when every replica is open/refused does
`NoReplicaAvailable` escape to the server, which serves the batch via
host predict. An open breaker heals itself: after the cooldown the
next batch is routed to it as a half-open probe, and one clean device
dispatch closes it again.

On the card's server (`contain_errors=False`, ROADMAP C29) only an
injected fault takes those rungs. A real dispatch error (a failed
launch, which CUDA makes sticky, or non-finite scores from the kernel)
is not retried and does not fail over: it records a breaker failure and
propagates to the caller, so a broken kernel is never hidden.

The dispatch boundary is a registered fault site
(``serving_replica_predict``, docs/Reliability.md) so the chaos
harness can kill any replica's device path and watch the breaker
open, the traffic fail over, and the probe re-close it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reliability import retry_call
from ..utils.log import Log
from ..utils.timer import global_timer
from .forest import DeviceForest

__all__ = ["Replica", "ReplicaSet", "NoReplicaAvailable",
           "NonFiniteScores", "local_devices"]


def local_devices(device) -> List[torch.device]:
    """The devices replicas go on: every card (`cuda:i`) for a CUDA
    device, else [the CPU]."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class NoReplicaAvailable(RuntimeError):
    """Every replica's breaker refused the dispatch (all open, or the
    half-open probes are taken). The server answers via host predict —
    the bottom rung of the degradation ladder."""


class NonFiniteScores(RuntimeError):
    """Device predict returned NaN/inf raw scores. Deterministic
    forests reproduce this on retry, so it fails the replica (breaker
    failure + failover) instead of burning the retry budget."""


class Replica:
    """One device-resident copy of the forest + its breaker + load."""

    def __init__(self, index: int, forest: DeviceForest, device,
                 breaker) -> None:
        self.index = index
        self.forest = forest
        self.device = device
        self.breaker = breaker
        self._lock = threading.Lock()
        self._inflight = 0
        self.dispatches = 0
        self.failures = 0

    def _acquire_slot(self) -> None:
        with self._lock:
            self._inflight += 1
            self.dispatches += 1

    def _release_slot(self, ok: bool) -> None:
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)
            if not ok:
                self.failures += 1

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def snapshot(self) -> Dict:
        snap = self.breaker.snapshot()
        with self._lock:
            snap.update(replica=self.index, device=str(self.device),
                        inflight=self._inflight,
                        dispatches=self.dispatches,
                        failures=self.failures)
        return snap


class ReplicaSet:
    """Least-loaded, breaker-gated routing across replicas.

    `forest` may be a single DeviceForest or a multimodel.ForestPack —
    anything carrying `supported` and `place_on(device)`; the fleet is
    agnostic to what one dispatch scores."""

    def __init__(self, replicas: List[Replica], name: str = "model",
                 contain_errors: bool = True):
        self.name = name
        self._replicas = tuple(replicas)   # immutable after build
        # False: only InjectedFault is retried and failed over (C29)
        self.contain_errors = bool(contain_errors)
        self._lock = threading.Lock()
        self.failovers = 0

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, forest: DeviceForest, n_replicas: int, *,
              name: str = "model", breaker_threshold: int = 3,
              breaker_cooldown_ms: float = 250.0,
              clock=time.monotonic, device=None,
              contain_errors: bool = True) -> "ReplicaSet":
        """Replicate `forest` onto the local devices of `device`'s kind
        (default: where the forest lives): every card for a CUDA device,
        the CPU for the CPU. ``n_replicas <= 0`` means one replica per
        local device. Unsupported forests get an empty set (the server
        never routes them to the device)."""
        from .breaker import CircuitBreaker
        if not forest.supported:
            return cls([], name=name, contain_errors=contain_errors)
        devices = local_devices(forest.device if device is None
                                else device)
        if n_replicas <= 0:
            n_replicas = len(devices)
        replicas: List[Replica] = []
        for i in range(max(int(n_replicas), 1)):
            dev = devices[i % len(devices)]
            # the forest itself where it already lives there (replica 0
            # on the server's device, and every replica of a one-card
            # host: identical placement, and the bucket cache stays warm
            # across replicas), else a copy on dev
            rep_forest = forest.place_on(dev)
            breaker = CircuitBreaker(threshold=breaker_threshold,
                                     cooldown_s=breaker_cooldown_ms / 1e3,
                                     clock=clock)
            replicas.append(Replica(i, rep_forest, dev, breaker))
        return cls(replicas, name=name, contain_errors=contain_errors)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._replicas)

    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    def any_available(self) -> bool:
        """Would a new request reach the device path right now? Non-
        consuming: breaker probes are only reserved at dispatch."""
        return any(r.breaker.available() for r in self._replicas)

    def open_count(self) -> int:
        return sum(1 for r in self._replicas
                   if r.breaker.state != "closed")

    def _pick_locked(self, exclude) -> Optional[Replica]:
        candidates = sorted(
            (r for r in self._replicas if r.index not in exclude),
            key=lambda r: (r.inflight(), r.index))
        for rep in candidates:
            if rep.breaker.try_acquire():
                return rep
        return None

    # ------------------------------------------------------------------
    def dispatch(self, engine, bins: np.ndarray, *, metrics=None,
                 retry_attempts: int = 3, retry_backoff_ms: float = 50.0,
                 retry_backoff_max_ms: float = 2000.0,
                 attempt_fn=None) -> np.ndarray:
        """Route one coalesced batch: least-loaded breaker-granted
        replica, capped-backoff retries on it, breaker bookkeeping,
        failover to the next replica on final failure. Raises
        `NoReplicaAvailable` when every replica refuses — the caller's
        host-fallback rung takes over.

        `attempt_fn(replica) -> raw` overrides what one attempt runs
        (the fused pack dispatch passes `multimodel.dispatch_pack`
        here); the default scores `bins` through the bucketed engine.
        Either way the attempt runs inside this retry/breaker/failover
        bracket and its per-dispatch fault site."""
        from ..reliability import faults
        from ..reliability.faults import InjectedFault

        retry_on = (Exception,) if self.contain_errors else (InjectedFault,)
        tried: set = set()
        failed_over = False
        while True:
            with self._lock:
                rep = self._pick_locked(tried)
            if rep is None:
                raise NoReplicaAvailable(
                    f"serving model '{self.name}': no replica available "
                    f"({len(self._replicas)} total, "
                    f"{self.open_count()} breaker-open)")
            if failed_over:
                with self._lock:
                    self.failovers += 1
                if metrics is not None:
                    metrics.record_failover()
                Log.warning(
                    f"serving model '{self.name}': failing over to "
                    f"replica {rep.index}")
            rep._acquire_slot()
            ok = False
            try:
                site = f"serving_replica_predict[{self.name}:{rep.index}]"

                def _one_attempt(_rep=rep):
                    # registered fault site: the per-replica device
                    # dispatch boundary (chaos kills land here)
                    faults.inject("serving_replica_predict")
                    if attempt_fn is not None:
                        return attempt_fn(_rep)
                    return engine.predict_raw(_rep.forest, bins,
                                              metrics=metrics)

                with global_timer.timeit("serve_replica_dispatch"):
                    raw = retry_call(
                        _one_attempt,
                        attempts=retry_attempts,
                        backoff_ms=retry_backoff_ms,
                        backoff_max_ms=retry_backoff_max_ms,
                        site=site, retry_on=retry_on,
                        on_retry=(metrics.record_retry
                                  if metrics is not None else None))
                if not np.all(np.isfinite(raw)):
                    raise NonFiniteScores(
                        f"replica {rep.index} of '{self.name}' returned "
                        f"non-finite scores")
                ok = True
            except NonFiniteScores as exc:
                from ..reliability import counters
                counters.inc("guard_trips")
                if metrics is not None:
                    metrics.record_guard_trip()
                rep.breaker.record_failure()
                Log.warning(f"serving model '{self.name}': {exc}; "
                            f"breaker records failure on replica "
                            f"{rep.index}")
                if not self.contain_errors:
                    raise
                tried.add(rep.index)
                failed_over = True
                continue
            except Exception as exc:
                rep.breaker.record_failure()
                if not (self.contain_errors or
                        isinstance(exc, InjectedFault)):
                    raise
                Log.warning(
                    f"serving model '{self.name}': replica {rep.index} "
                    f"device predict failed ({exc}); breaker "
                    f"{rep.breaker.state}")
                tried.add(rep.index)
                failed_over = True
                continue
            finally:
                rep._release_slot(ok)
            rep.breaker.record_success()
            return raw

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            failovers = self.failovers
        reps = [r.snapshot() for r in self._replicas]
        return {
            "replicas": reps,
            "replica_count": len(self._replicas),
            "breaker_open_replicas": sum(
                1 for r in reps if r["state"] != "closed"),
            "failovers": failovers,
        }
