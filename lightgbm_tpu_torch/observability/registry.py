"""Process-global observability registry: one surface over the parts.

Port of lightgbm_tpu/observability/registry.py. The registry COMPOSES
the pre-existing fragments instead of replacing them: `registry.timer`
IS utils.timer.global_timer and `registry.counters` IS
reliability.counters.counters (same objects, so every existing call site
keeps working and feeds the unified snapshot), plus the components owned
here — the span trace, the per-iteration training telemetry, compile
accounting and device-utilization (MFU) accounting.

Everything is off by default. `enable()` flips one flag; instrumented
hot paths check `registry.enabled` (a single attribute read + branch)
and do nothing else when off.

The `record_train_iteration` / `record_fused_block` helpers keep the
gbdt.py hook sites to a couple of lines: they derive trees-per-
iteration, fold in reliability-counter deltas, and mirror the iteration
into the span trace. The MAC estimate for MFU is 0 on every port path
(tree_macs_for: its histogram kernels are scatter-shaped, ROADMAP C21),
so MFU reads as unavailable rather than invented. The collective, clock
skew, membership, freshness, streaming and distributed hooks are here
for the modules that will call them (the distributed learners,
streaming, serving and the continuous loop); the level-pipeline hook
waits for the lagged fix-up loop (ROADMAP B2).
"""

from __future__ import annotations

import collections as _collections
import threading
from typing import Dict, List, Optional

import numpy as np

from ..reliability.counters import counters as _rel_counters
from ..utils.timer import global_timer as _global_timer
from .compiles import CompileAccounting
from .export import render_prometheus
from .flightrec import current_rank, recorder as _flightrec
from .mfu import DeviceUtilization
from .profile import profiler as _profiler
from .telemetry import PHASE_KEYS, TrainingTelemetry
from .trace import Trace

__all__ = ["ObservabilityRegistry", "registry"]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ObservabilityRegistry:
    """One process-global surface over tracing/telemetry/MFU/compiles
    plus the shared timer and reliability counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.record_norms = False   # host-sync stats (norms, leaves)
        self.trace = Trace()
        self.training = TrainingTelemetry()
        self.compiles = CompileAccounting()
        self.mfu = DeviceUtilization()
        # pipelined-executor aggregates (pipeline/executor.py): how much
        # of the block walls the overlapped host work covered
        self._pipeline = {"blocks": 0, "iterations": 0,
                          "host_seconds": 0.0, "wall_seconds": 0.0}
        # level-pipelined grower aggregates (the JAX package's
        # learner/grower_pipeline.py; the port's waits, ROADMAP B2):
        # staged per-level dispatch counts, the speculative fixup
        # dispatches that turned out to be no-ops, and early stops from
        # the lagged done poll
        self._level_pipeline = {"trees": 0, "stage_dispatches": 0,
                                "fixup_dispatched": 0,
                                "fixup_speculative": 0, "early_stops": 0,
                                "wall_seconds": 0.0}
        # streamed-ingestion aggregates (streaming/loader.py): chunk and
        # byte volume per pass plus the frozen sketch sample size
        self._streaming = {"chunks": 0, "rows": 0, "bytes": 0,
                           "wall_seconds": 0.0, "sample_rows": 0,
                           "exact": 0}
        # histogram-backend resolution (boosting/gbdt.py
        # _resolved_hist_backend): the pinned choice + autotune timings
        self._hist_backend = {"choice": "", "autotuned": False,
                              "timings_ms": {}}
        # collective-watchdog aggregates (reliability/watchdog.py):
        # guarded brackets, deadline overruns, aborts and the worst
        # peer heartbeat age observed while diagnosing
        self._collective = {"guarded": 0, "wall_seconds": 0.0,
                            "timeouts": 0, "aborts": 0,
                            "heartbeat_age_max_s": 0.0, "world": 0}
        # cross-rank clock-offset samples piggybacked on guarded
        # collectives (parallel/comm.py): aggregates for /metrics plus
        # a bounded sample ring the trace dump embeds for the merge CLI
        self._clock_skew = {"samples": 0, "last_skew_s": 0.0,
                            "max_skew_s": 0.0}
        self._clock_samples: "collections.deque" = \
            _collections.deque(maxlen=512)
        # distributed-training aggregates (distributed/): crossbar mesh
        # setup (world size, reduce-scatter feature shard width) and the
        # binning sketch volume merged through mapper_sync
        self._distributed = {"world": 0, "feature_shard_width": 0,
                             "setup_wall_seconds": 0.0,
                             "sketch_rows": 0, "sketch_merges": 0}
        # continuous-loop freshness watchdog (continuous/trainer.py):
        # data-to-serving latency of the live generation plus the loop's
        # incident counters — torn publishes discarded on recovery and
        # poison windows quarantined after crash-looping
        self._freshness = {"generation": 0, "publishes": 0,
                           "data_to_serve_s": 0.0,
                           "max_data_to_serve_s": 0.0,
                           "staleness_slo_s": 0.0, "slo_alarm": 0,
                           "slo_breaches": 0, "torn_publishes": 0,
                           "quarantined_windows": 0}
        # elastic membership (distributed/elastic.py): the epoch/world
        # this rank currently believes, shrink/join commits observed,
        # and the wall spent rebuilding shards after a resize
        self._membership = {"epoch": 0, "world": 0, "resizes": 0,
                            "shrinks": 0, "joins": 0,
                            "reshard_wall_s": 0.0, "resharded_loads": 0}
        # shared singletons, NOT copies — existing call sites in
        # serving/, reliability/ and the phase timeits keep writing to
        # the same objects this registry reads.
        self.timer = _global_timer
        self.counters = _rel_counters

    # -- lifecycle ------------------------------------------------------
    def enable(self, ring: Optional[int] = None,
               norms: Optional[bool] = None) -> None:
        with self._lock:
            self.enabled = True
            self.trace.enabled = True
            if ring:
                self.trace.set_capacity(ring)
                self.training.set_capacity(ring)
            if norms is not None:
                self.record_norms = bool(norms)

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self.trace.enabled = False

    def configure_from_config(self, cfg) -> None:
        """Wire the whole observability surface from a resolved Config
        (Booster.__init__): registry enable flag, flight-recorder ring
        and bundle directory (falling back to the checkpoint directory
        so multihost post-mortems land on shared storage), and the
        device span profiler."""
        if cfg.observe:
            self.enable(ring=cfg.observe_ring,
                        norms=cfg.observe_norms)
        _flightrec.configure(
            enabled=bool(cfg.flightrec),
            capacity=int(cfg.flightrec_ring),
            out_dir=cfg.flightrec_dir or cfg.checkpoint_dir or "")
        if cfg.profile_spans:
            _profiler.configure(spans=cfg.profile_spans,
                                out_dir=cfg.profile_dir,
                                max_captures=cfg.profile_max_captures)

    def reset(self) -> None:
        """Clear observability-owned state. The shared timer and
        reliability counters are left alone — they predate this
        subsystem and other code depends on their accumulation."""
        self.trace.reset()
        self.training.reset()
        self.compiles.reset()
        self.mfu.reset()
        with self._lock:
            self._pipeline = {"blocks": 0, "iterations": 0,
                              "host_seconds": 0.0, "wall_seconds": 0.0}
            self._level_pipeline = {"trees": 0, "stage_dispatches": 0,
                                    "fixup_dispatched": 0,
                                    "fixup_speculative": 0,
                                    "early_stops": 0, "wall_seconds": 0.0}
            self._streaming = {"chunks": 0, "rows": 0, "bytes": 0,
                               "wall_seconds": 0.0, "sample_rows": 0,
                               "exact": 0}
            self._hist_backend = {"choice": "", "autotuned": False,
                                  "timings_ms": {}}
            self._collective = {"guarded": 0, "wall_seconds": 0.0,
                                "timeouts": 0, "aborts": 0,
                                "heartbeat_age_max_s": 0.0, "world": 0}
            self._clock_skew = {"samples": 0, "last_skew_s": 0.0,
                                "max_skew_s": 0.0}
            self._clock_samples = _collections.deque(maxlen=512)
            self._distributed = {"world": 0, "feature_shard_width": 0,
                                 "setup_wall_seconds": 0.0,
                                 "sketch_rows": 0, "sketch_merges": 0}
            self._freshness = {"generation": 0, "publishes": 0,
                               "data_to_serve_s": 0.0,
                               "max_data_to_serve_s": 0.0,
                               "staleness_slo_s": 0.0, "slo_alarm": 0,
                               "slo_breaches": 0, "torn_publishes": 0,
                               "quarantined_windows": 0}
            self._membership = {"epoch": 0, "world": 0, "resizes": 0,
                                "shrinks": 0, "joins": 0,
                                "reshard_wall_s": 0.0,
                                "resharded_loads": 0}

    # -- exporters ------------------------------------------------------
    def level_pipeline_snapshot(self) -> Dict:
        with self._lock:
            p = dict(self._level_pipeline)
        disp = p["fixup_dispatched"]
        frac = p["fixup_speculative"] / disp if disp > 0 else 0.0
        return {"trees": p["trees"],
                "stage_dispatches": p["stage_dispatches"],
                "fixup_dispatched": disp,
                "fixup_speculative": p["fixup_speculative"],
                "speculative_frac": round(frac, 4),
                "early_stops": p["early_stops"],
                "wall_seconds": round(p["wall_seconds"], 6)}

    def pipeline_snapshot(self) -> Dict:
        with self._lock:
            p = dict(self._pipeline)
        frac = min(1.0, p["host_seconds"] / p["wall_seconds"]) \
            if p["wall_seconds"] > 0 else 0.0
        return {"blocks": p["blocks"], "iterations": p["iterations"],
                "host_seconds": round(p["host_seconds"], 6),
                "wall_seconds": round(p["wall_seconds"], 6),
                "overlap_frac": round(frac, 4)}

    def streaming_snapshot(self) -> Dict:
        with self._lock:
            s = dict(self._streaming)
        rps = s["rows"] / s["wall_seconds"] if s["wall_seconds"] > 0 else 0.0
        return {"chunks": s["chunks"], "rows": s["rows"],
                "bytes": s["bytes"], "sample_rows": s["sample_rows"],
                "exact": s["exact"],
                "wall_seconds": round(s["wall_seconds"], 6),
                "rows_per_sec": round(rps, 1)}

    def hist_backend_snapshot(self) -> Dict:
        """The pinned histogram backend as a flat exportable mapping.
        The string `choice` rides the JSON snapshot; the
        Prometheus exporter skips strings, so the choice is ALSO
        one-hot encoded (is_mxu/is_pallas/is_scatter) for scrapers."""
        with self._lock:
            hb = dict(self._hist_backend)
        out: Dict = {"choice": hb["choice"],
                     "autotuned": bool(hb["autotuned"])}
        for name in ("mxu", "pallas", "scatter"):
            out["is_" + name] = int(hb["choice"] == name)
        for name, ms in sorted((hb.get("timings_ms") or {}).items()):
            out[str(name) + "_ms"] = round(float(ms), 3)
        return out

    def collective_snapshot(self) -> Dict:
        with self._lock:
            c = dict(self._collective)
        c["wall_seconds"] = round(c["wall_seconds"], 6)
        c["heartbeat_age_max_s"] = round(c["heartbeat_age_max_s"], 3)
        return c

    def distributed_snapshot(self) -> Dict:
        with self._lock:
            d = dict(self._distributed)
        d["setup_wall_seconds"] = round(d["setup_wall_seconds"], 6)
        return d

    def freshness_snapshot(self) -> Dict:
        with self._lock:
            f = dict(self._freshness)
        f["data_to_serve_s"] = round(f["data_to_serve_s"], 6)
        f["max_data_to_serve_s"] = round(f["max_data_to_serve_s"], 6)
        return f

    def membership_snapshot(self) -> Dict:
        with self._lock:
            m = dict(self._membership)
        m["reshard_wall_s"] = round(m["reshard_wall_s"], 6)
        return m

    def clock_skew_snapshot(self) -> Dict:
        with self._lock:
            s = dict(self._clock_skew)
        s["last_skew_s"] = round(s["last_skew_s"], 6)
        s["max_skew_s"] = round(s["max_skew_s"], 6)
        return s

    def clock_samples(self) -> List[Dict]:
        """The bounded ring of piggybacked clock-offset samples
        ({"site", "walls"}) that the chrome trace dump embeds for
        ``python -m lightgbm_tpu_torch.observability merge``."""
        with self._lock:
            return list(self._clock_samples)

    def snapshot(self) -> Dict:
        return {
            "enabled": self.enabled,
            "clock_skew": self.clock_skew_snapshot(),
            "collective": self.collective_snapshot(),
            "distributed": self.distributed_snapshot(),
            "freshness": self.freshness_snapshot(),
            "membership": self.membership_snapshot(),
            "flightrec": _flightrec.snapshot(),
            "profiler": _profiler.snapshot(),
            "hist_backend": self.hist_backend_snapshot(),
            "pipeline": self.pipeline_snapshot(),
            "level_pipeline": self.level_pipeline_snapshot(),
            "streaming": self.streaming_snapshot(),
            "training": self.training.snapshot(),
            "compiles": {"entries": self.compiles.snapshot(),
                         **self.compiles.totals()},
            "device_utilization": self.mfu.snapshot(),
            "counters": self.counters.snapshot(),
            "timers": {k: round(float(v), 6)
                       for k, v in self.timer.totals().items()},
            "trace": {"spans_buffered": len(self.trace),
                      "dropped": self.trace.dropped},
        }

    def prometheus_text(self) -> str:
        snap = self.snapshot()
        training = dict(snap["training"])
        training.pop("last", None)   # unbounded-cardinality record
        return render_prometheus([
            ({"enabled": snap["enabled"]}, "lightgbm_tpu_observability",
             None),
            (training, "lightgbm_tpu_training", None),
            (snap["compiles"], "lightgbm_tpu_compiles", None),
            (snap["device_utilization"], "lightgbm_tpu_device", None),
            (snap["counters"], "lightgbm_tpu_reliability", None),
            (snap["collective"], "lightgbm_tpu_collective", None),
            (snap["distributed"], "lightgbm_tpu_distributed", None),
            (snap["freshness"], "lightgbm_tpu_freshness", None),
            (snap["membership"], "lightgbm_tpu_membership", None),
            (snap["clock_skew"], "lightgbm_tpu_clock_skew", None),
            (snap["flightrec"], "lightgbm_tpu_flightrec", None),
            (snap["hist_backend"], "lightgbm_tpu_hist_backend", None),
            (snap["pipeline"], "lightgbm_tpu_pipeline", None),
            (snap["level_pipeline"], "lightgbm_tpu_level_pipeline", None),
            (snap["streaming"], "lightgbm_tpu_streaming", None),
            (snap["timers"], "lightgbm_tpu_timer_seconds", None),
            (snap["trace"], "lightgbm_tpu_trace", None),
        ])

    def dump_trace(self, path: str, fmt: Optional[str] = None) -> str:
        return self.trace.dump(path, fmt, rank=current_rank(),
                               clock_samples=self.clock_samples())

    # -- training hooks (called from boosting/gbdt.py) ------------------
    def record_hist_autotune(self, choice: str, timings_ms: Dict,
                             autotuned: bool) -> None:
        """Pin the resolved histogram backend (+ per-backend autotune
        timings, ms). Recorded even when disabled — this is one-shot
        startup configuration, not per-iteration telemetry, read
        regardless of the enable flag."""
        with self._lock:
            self._hist_backend = {
                "choice": str(choice), "autotuned": bool(autotuned),
                "timings_ms": {str(k): float(v)
                               for k, v in (timings_ms or {}).items()}}

    # -- collective-watchdog hooks (reliability/watchdog.py) ------------
    # recorded even when disabled, like record_hist_autotune: watchdog
    # events are rare, high-value incident forensics — the last thing
    # the run prints before aborting must not depend on an enable flag
    def record_collective_guard(self, wall_seconds: float) -> None:
        with self._lock:
            self._collective["guarded"] += 1
            self._collective["wall_seconds"] += float(wall_seconds)

    def record_collective_timeout(self) -> None:
        with self._lock:
            self._collective["timeouts"] += 1

    def record_collective_abort(self) -> None:
        with self._lock:
            self._collective["aborts"] += 1

    def record_heartbeat_age(self, age_s: float) -> None:
        with self._lock:
            self._collective["heartbeat_age_max_s"] = max(
                self._collective["heartbeat_age_max_s"], float(age_s))

    def record_collective_world(self, world: int) -> None:
        with self._lock:
            self._collective["world"] = int(world)

    # -- elastic-membership hooks (distributed/elastic.py) --------------
    # recorded even when disabled, like the watchdog hooks: a resize is
    # an incident, and the metrics tail is the only record a
    # reincarnated process has of the world it came from
    def record_membership(self, epoch: int, world: int) -> None:
        """This rank's current membership belief (set at distributed
        init and again after every epoch adoption)."""
        with self._lock:
            self._membership["epoch"] = int(epoch)
            self._membership["world"] = int(world)

    def record_membership_resize(self, kind: str, epoch: int,
                                 world: int, joined: int = 0) -> None:
        """One committed membership change: `kind` is "shrink" or
        "join"; `world`/`epoch` are the NEW values the record names."""
        with self._lock:
            m = self._membership
            m["resizes"] += 1
            if kind == "shrink":
                m["shrinks"] += 1
            m["joins"] += int(joined)
            m["epoch"] = int(epoch)
            m["world"] = int(world)

    def record_membership_reshard(self, wall_s: float) -> None:
        """One topology-flexible checkpoint load (W-rank bundle read by
        a W'-rank world): the elasticity cost the bench sentinel
        watches."""
        with self._lock:
            self._membership["resharded_loads"] += 1
            self._membership["reshard_wall_s"] += float(wall_s)

    def record_clock_sample(self, site: str, walls) -> None:
        """One piggybacked clock-offset sample from a guarded collective
        (parallel/comm.py): every rank's pre-collective wall stamp, one
        float per rank, moved by the SAME allgather as the payload.
        Recorded even when disabled, like the other collective hooks —
        skew forensics must survive the enable flag."""
        w = [float(v) for v in walls]
        if not w:
            return
        skew = (max(w) - min(w)) if len(w) > 1 else 0.0
        with self._lock:
            self._clock_skew["samples"] += 1
            self._clock_skew["last_skew_s"] = skew
            self._clock_skew["max_skew_s"] = max(
                self._clock_skew["max_skew_s"], skew)
            self._clock_samples.append({"site": str(site), "walls": w})
        _flightrec.record_clock_sample(site, w)

    # -- continuous-loop hooks (continuous/trainer.py) ------------------
    # recorded even when disabled, like the watchdog hooks: the
    # freshness SLO alarm and the loop's incident counters (torn
    # publishes, quarantines) are the forensics the chaos protocol
    # reads from metrics alone — they must not depend on an enable flag
    def record_freshness_publish(self, generation: int,
                                 data_to_serve_s: float,
                                 slo_s: float = 0.0) -> None:
        """One published generation: `data_to_serve_s` is the wall from
        first row of the window entering ingest to the hot-swap landing
        (data-to-serving latency). `slo_s` > 0 arms the staleness
        alarm: the gauge latches 1 whenever the latest publish blew the
        budget and clears on the next in-budget one."""
        lat = float(data_to_serve_s)
        breach = int(slo_s > 0 and lat > float(slo_s))
        with self._lock:
            f = self._freshness
            f["generation"] = int(generation)
            f["publishes"] += 1
            f["data_to_serve_s"] = lat
            f["max_data_to_serve_s"] = max(f["max_data_to_serve_s"], lat)
            f["staleness_slo_s"] = float(slo_s)
            f["slo_alarm"] = breach
            f["slo_breaches"] += breach

    def record_freshness_recover(self, generation: int) -> None:
        """Loop recovery re-read the GENERATION marker: seed the live
        generation gauge so a restarted process that publishes nothing
        (exhausted stream, serve-only restart) still reports the
        generation it is actually serving, not 0. Publish counters are
        untouched — only publishes move them."""
        with self._lock:
            f = self._freshness
            f["generation"] = max(f["generation"], int(generation))

    def record_freshness_torn_publish(self, generation: int) -> None:
        """A half-built generation found ahead of the marker on
        recovery — the torn-publish twin of streaming's torn
        stream-state pairs — detected and discarded."""
        with self._lock:
            self._freshness["torn_publishes"] += 1

    def record_freshness_quarantine(self, window: int) -> None:
        """A poison window skipped after crash-looping the cycle past
        its retry budget."""
        with self._lock:
            self._freshness["quarantined_windows"] += 1

    def tree_macs_for(self, gbdt) -> int:
        """Analytic per-tree MAC estimate for this booster: 0 on every
        port path. The JAX package counts MACs only for its one-hot MXU
        matmul histograms and returns 0 for its scatter kernels, whose
        cost is partition- not matmul-shaped; every port histogram kernel
        is scatter-shaped (route, partition, shared-memory atomics), so
        MFU reads as unavailable rather than invented (ROADMAP C21)."""
        return 0

    def phase_deltas(self, before: Dict[str, float]) -> Dict[str, float]:
        """Per-iteration phase walls from two global_timer snapshots."""
        now = self.timer.totals()
        return {k: now.get(k, 0.0) - before.get(k, 0.0)
                for k in PHASE_KEYS if now.get(k, 0.0) > before.get(k, 0.0)}

    def record_train_iteration(self, gbdt, iteration: int, t0: float,
                               wall_s: float,
                               phases: Optional[Dict[str, float]] = None,
                               gradients=None, hessians=None,
                               tree=None) -> None:
        if not self.enabled:
            return
        trees = int(getattr(gbdt, "num_tree_per_iteration", 1))
        macs = self.tree_macs_for(gbdt) * trees
        extra: Dict = {}
        if self.record_norms:
            # host copies of the iteration's gradients and the fresh
            # tree's leaf count: norms-gated, like the JAX package's
            if gradients is not None:
                extra["grad_norm"] = float(np.linalg.norm(_host(gradients)))
            if hessians is not None:
                extra["hess_norm"] = float(np.linalg.norm(_host(hessians)))
            if tree is not None:
                extra["leaves"] = int(_host(tree.num_leaves))
        self.training.record_iteration(
            iteration, wall_s, phases=phases, trees=trees,
            bagging_fraction=float(gbdt.config.bagging_fraction),
            macs=macs or None, counters=self.counters.snapshot(), **extra)
        if macs:
            self.mfu.add(macs, wall_s, trees)
        self.trace.add("train_iter", t0, wall_s, iteration=int(iteration))

    def record_fused_block(self, gbdt, iteration: int, k: int, t0: float,
                           wall_s: float, was_built: bool) -> None:
        """One record for a k-iteration fused trainer dispatch (one
        record a block: the graphs replay its trees in one dispatch). The
        dispatch that builds a trainer and captures its graphs is its
        compilation — counted under entry "fused_train" with the
        bracketing semantics of compiles.py; each replayed block is a
        hit."""
        if not self.enabled:
            return
        kcls = int(getattr(gbdt, "num_tree_per_iteration", 1))
        trees = int(k) * kcls
        macs = self.tree_macs_for(gbdt) * trees
        self.compiles.record("fused_train",
                             wall_s if was_built else 0.0,
                             compiled=was_built)
        self.training.record_iteration(
            iteration, wall_s, trees=trees, iterations=int(k), fused=True,
            bagging_fraction=float(gbdt.config.bagging_fraction),
            macs=macs or None, counters=self.counters.snapshot())
        if macs:
            self.mfu.add(macs, wall_s, trees)
        self.trace.add("fused_block", t0, wall_s, iterations=int(k),
                       compiled=bool(was_built))

    def record_pipeline_block(self, iteration: int, k: int, t0: float,
                              wall_s: float, host_s: float,
                              overlap_frac: float) -> None:
        """One pipelined-executor block: wall_s spans dispatch to metric
        sync, host_s is the overlapped host window inside it (previous
        block's tree unpacking + scheduling). Training compute itself is
        already recorded by record_fused_block — this layer only
        accounts the overlap."""
        if not self.enabled:
            return
        with self._lock:
            p = self._pipeline
            p["blocks"] += 1
            p["iterations"] += int(k)
            p["host_seconds"] += float(host_s)
            p["wall_seconds"] += float(wall_s)
        self.trace.add("pipeline_block", t0, wall_s, iteration=int(iteration),
                       iterations=int(k),
                       host_ms=round(float(host_s) * 1e3, 3),
                       overlap_frac=round(float(overlap_frac), 4))

    def record_level_pipeline(self, iteration: int, t0: float,
                              wall_s: float, stages: int,
                              fixup_dispatched: int,
                              fixup_speculative: int,
                              stopped_early: bool) -> None:
        """One level-pipelined tree (learner/grower_pipeline.py):
        `stages` staged programs dispatched, of the fixups
        `fixup_speculative` were in flight past the (lagged) done flag
        and executed as identity no-ops. Training compute is recorded
        elsewhere — this layer accounts the dispatch overlap so a
        merged trace shows where speculation paid or wasted."""
        if not self.enabled:
            return
        with self._lock:
            p = self._level_pipeline
            p["trees"] += 1
            p["stage_dispatches"] += int(stages)
            p["fixup_dispatched"] += int(fixup_dispatched)
            p["fixup_speculative"] += int(fixup_speculative)
            p["early_stops"] += int(bool(stopped_early))
            p["wall_seconds"] += float(wall_s)
        self.trace.add("level_pipeline", t0, wall_s,
                       iteration=int(iteration), stages=int(stages),
                       fixup=int(fixup_dispatched),
                       speculative=int(fixup_speculative))

    def record_streaming_chunk(self, phase: str, chunk_index: int,
                               t0: float, wall_s: float, rows: int,
                               nbytes: int) -> None:
        """One ingested chunk from streaming/loader.py: `phase` is
        "sketch" (pass 1) or "bin" (pass 2); wall_s covers the chunk's
        host work including any overlapped parse it absorbed."""
        if not self.enabled:
            return
        with self._lock:
            s = self._streaming
            s["chunks"] += 1
            if phase == "bin":   # pass 2 re-streams the same rows
                s["rows"] += int(rows)
            s["bytes"] += int(nbytes)
            s["wall_seconds"] += float(wall_s)
        self.trace.add("streaming_chunk", t0, wall_s, phase=str(phase),
                       chunk=int(chunk_index), rows=int(rows),
                       bytes=int(nbytes))

    def record_streaming_sketch(self, sample_rows: int,
                                exact: bool) -> None:
        """The frozen pass-1 reservoir: its row count and whether it
        held the whole stream (exact => bit-parity boundaries)."""
        if not self.enabled:
            return
        with self._lock:
            self._streaming["sample_rows"] = int(sample_rows)
            self._streaming["exact"] = int(bool(exact))

    def record_distributed_setup(self, world: int,
                                 feature_shard_width: int,
                                 wall_seconds: float) -> None:
        """Crossbar mesh resolution (boosting/gbdt.py _setup_parallel):
        device-mesh world size, the reduce-scatter feature shard width
        (0 = psum full-histogram aggregation), and the setup wall."""
        if not self.enabled:
            return
        with self._lock:
            d = self._distributed
            d["world"] = int(world)
            d["feature_shard_width"] = int(feature_shard_width)
            d["setup_wall_seconds"] += float(wall_seconds)

    def record_distributed_sketch(self, rows: int) -> None:
        """One per-rank sketch merged through the distributed-binning
        mapper_sync (distributed/binning.py)."""
        if not self.enabled:
            return
        with self._lock:
            d = self._distributed
            d["sketch_rows"] += int(rows)
            d["sketch_merges"] += 1


#: process-global singleton; `lightgbm_tpu_torch.observability.registry`.
registry = ObservabilityRegistry()
