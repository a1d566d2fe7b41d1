"""Pipelined training executor (port of lightgbm_tpu/pipeline/).

Double-buffers the fused block dispatch (boosting/fused.py): while block k
runs, the host appends block k-1's stacked trees, and only then syncs
block k's per-iteration metric arrays for the callback/early-stop
protocol (device_eval.py reduces them on the device). Models are
byte-identical to the non-pipelined block loop in engine.train
(pipeline=false, the parity oracle). Engaged by engine.train when
`pipeline=true` (the default) and the run already dispatches blocks.
"""

from .executor import PipelineStats, run_pipelined
from .scheduler import AdaptiveBlockScheduler

__all__ = ["AdaptiveBlockScheduler", "PipelineStats", "run_pipelined"]
