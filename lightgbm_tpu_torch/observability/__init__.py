"""Unified observability: spans, telemetry, MFU, compiles, exporters.

Port of lightgbm_tpu/observability/. One process-global registry
(`registry`) subsumes the fragments that grew separately —
`utils.timer.global_timer` (phase totals) and `reliability.counters`
(degradation counters) — and adds what they cannot express:

- structured spans (`registry.trace.span("grow_tree", iter=i)`) with
  thread-safe nesting, an in-memory ring, and JSONL / Chrome-Perfetto
  `trace_event` export (`registry.dump_trace(path)`);
- per-iteration training telemetry (iteration wall time, phase split,
  grad/hess norms, leaves grown, bagging fraction, reliability-counter
  deltas) hooked into `boosting/gbdt.py`, one record a fused block, and
  the pipelined executor's block records (`pipeline/executor.py`);
- device-utilization accounting (mfu.py): the JAX package's MAC model
  of its matmul histograms; 0 on every port path, whose histogram
  kernels are scatter-shaped, so MFU reads as unavailable (ROADMAP C21);
- compile accounting: a fused trainer's build and graph capture
  (`fused_train`) and each nvcc build of a kernel library
  (`nvcc_<stem>`);
- exporters: `registry.snapshot()` JSON dict, Prometheus text format
  (`prometheus_text`, served by `MetricsHTTPServer` at /metrics),
  `dump_trace(path)`;
- a crash flight recorder (`recorder`, flightrec.py): bounded ring of
  recent spans / fault hits / guard trips, flushed as an atomic
  ``postmortem_<rank>.json`` on fatal paths;
- budgeted device-profiler capture (`profiler`, profile.py) bracketing
  torch.profiler captures around spans matching ``profile_spans``;
- cross-rank trace merge (merge.py, ``python -m
  lightgbm_tpu_torch.observability merge <dir>``).

The JAX package's bench regression sentinel (regress.py) waits for the
port's benchmark (ROADMAP A9).

The registry is disabled by default; every instrumentation site is a
single `if registry.enabled:` branch, so the off path costs one
attribute read. Enable with the `observe` parameter (config.py; a
training Booster calls `configure_from_config`), `registry.enable()`, or
the module-level `enable()`. Host timers and spans time dispatch: on the
card the kernels run asynchronously behind them, so only a fused block's
record (which waits for the card when observe is on) and a profiler
capture cover device work.
"""

from __future__ import annotations

from . import mfu
from .compiles import CompileAccounting
from .export import MetricsHTTPServer, prometheus_lines
from .flightrec import (FATAL_REASONS, POSTMORTEM_PREFIX, FlightRecorder,
                        current_rank, recorder)
from .merge import merge_traces
from .profile import SpanProfiler, profiler
from .registry import ObservabilityRegistry, registry
from .telemetry import TrainingTelemetry
from .trace import Span, Trace

__all__ = [
    "registry", "ObservabilityRegistry", "Trace", "Span",
    "TrainingTelemetry", "CompileAccounting", "MetricsHTTPServer",
    "prometheus_lines", "mfu", "span", "snapshot", "dump_trace",
    "prometheus_text", "enable", "disable",
    "FlightRecorder", "recorder", "SpanProfiler", "profiler",
    "merge_traces", "POSTMORTEM_PREFIX", "FATAL_REASONS", "current_rank",
    "configure_from_config",
]

# module-level conveniences bound to the process-global registry
span = registry.trace.span
snapshot = registry.snapshot
dump_trace = registry.dump_trace
prometheus_text = registry.prometheus_text
enable = registry.enable
disable = registry.disable


def configure_from_config(cfg) -> None:
    """Wire the whole observability surface from a resolved Config (a
    training Booster's __init__): observe, observe_ring and
    observe_norms; the flight recorder's flightrec, flightrec_ring and
    bundle directory (flightrec_dir, else checkpoint_dir, else none);
    and the span profiler (profile_spans, profile_dir,
    profile_max_captures). registry.configure_from_config does it, as in
    the JAX package. A Booster loaded from a model text leaves all of it
    as it is; the JAX package re-arms it from every Booster, so a resumed
    run's base model (train(resume_from=)) clears the bundle directory
    there."""
    registry.configure_from_config(cfg)
