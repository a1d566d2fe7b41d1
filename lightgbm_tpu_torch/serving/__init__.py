"""Device-resident inference serving engine.

The port's copy of lightgbm_tpu/serving: loads a trained (or
file-loaded) Booster once into stacked device tensors, places it on the
server's devices, and serves request streams through a shape-bucketed
predictor (one launch of csrc/serve_forest.cu a batch on the card) with
micro-batching, SLO-budgeted admission control, per-replica self-healing
circuit breakers, failover, zero-downtime hot-swap, host fallback,
multi-model packs and a per-model metrics surface. See `Server`.
"""

from .batcher import (BatcherClosed, DeadlineExceeded, MicroBatcher,
                      OverloadError)
from .breaker import BREAKER_STATES, CircuitBreaker, breaker_state_code
from .engine import BucketedPredictor, max_compilations, next_bucket
from .forest import DeviceForest, FeatureBinner, build_device_forest
from .metrics import ModelMetrics
from .registry import ModelEntry, ModelRegistry
from .replicas import NoReplicaAvailable, Replica, ReplicaSet
from .server import Server

__all__ = [
    "Server", "ModelRegistry", "ModelEntry", "ModelMetrics",
    "MicroBatcher", "OverloadError", "BatcherClosed",
    "DeadlineExceeded", "CircuitBreaker", "BREAKER_STATES",
    "breaker_state_code", "Replica", "ReplicaSet",
    "NoReplicaAvailable", "BucketedPredictor",
    "DeviceForest", "FeatureBinner", "build_device_forest",
    "next_bucket", "max_compilations",
]
