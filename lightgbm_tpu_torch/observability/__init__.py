"""Observability: the crash flight recorder (flightrec.py).

Port of the part of lightgbm_tpu/observability/ that the reliability
layer writes to. The registry (span tracing, telemetry, the profiler and
the exports: ROADMAP A9 part 2's second half) is not ported yet; until it
is, configure_from_config wires the recorder alone from a Booster's
config, as the JAX package's registry.configure_from_config does
(lightgbm_tpu/observability/registry.py:135-148). The registry takes this
function over when it lands.
"""

from .flightrec import (FATAL_REASONS, POSTMORTEM_PREFIX, FlightRecorder,
                        current_rank, recorder)

__all__ = ["FlightRecorder", "recorder", "POSTMORTEM_PREFIX",
           "FATAL_REASONS", "current_rank", "configure_from_config"]


def configure_from_config(cfg) -> None:
    """Arm the flight recorder from a resolved Config (the training
    Booster's __init__): flightrec, flightrec_ring, and the bundle
    directory flightrec_dir, else checkpoint_dir (so a post-mortem lands
    beside the run's bundles), else none (a non-fatal flush then writes
    nothing). A Booster loaded from a model text leaves the recorder as
    it is; the JAX package re-arms it from every Booster, so a resumed
    run's base model (train(resume_from=)) clears the bundle directory
    there."""
    recorder.configure(
        enabled=bool(cfg.flightrec),
        capacity=int(cfg.flightrec_ring),
        out_dir=cfg.flightrec_dir or cfg.checkpoint_dir or "")
