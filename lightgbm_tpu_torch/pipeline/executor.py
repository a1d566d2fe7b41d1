"""Double-buffered training loop: overlap host work with device blocks.

Port of lightgbm_tpu/pipeline/executor.py. The non-pipelined block loop
in engine.train alternates strictly: dispatch a fused block, wait,
append its stacked trees, evaluate, run callbacks, repeat. This executor
reorders the same steps so the host step of appending a block's trees
(GBDT.finalize_block) runs after the next block is dispatched:

    dispatch block k  ──────────────────────┐ device busy
    launch block k's metric reductions      │
    finalize block k-1's trees  <── overlap │ host busy
    sync block k's metrics  ────────────────┘ the block's one sync
    callbacks j = 0..b-1 (early stop may raise)

Nothing is speculative: block k+1 is never dispatched before block k's
early-stop decisions, so the executor trains the byte-identical model of
the non-pipelined loop, which pipeline=false keeps as the parity oracle
(tests/test_torch_pipeline.py). An early stop inside a block follows the
engine's protocol: finalize this block's trees, restore the block-final
valid scores, roll the trees after the stop back, pin the valid scores to
the stopping iteration's trajectory point, re-raise.

Metric values come from device reductions when every metric has one
(device_eval.py): the block's sync then copies a [b, n_metrics] tensor a
valid set instead of the score trajectories; else from the host metrics,
as in the engine loop (GBDT.valid_traj_point, one trajectory copy a
block).

In the port the overlap window is small: the fused trainer reads `done`
before each fix-up pass of every tree (boosting/fused.py), so
update_batch_dispatch returns only after the block's last tree has grown,
and the window holds only the previous block's finalize (ROADMAP B2).
PipelineStats records what overlapped. A block whose fused dispatch
fails every attempt comes back trained per iteration
(GBDT.train_many_dispatch), with its k-point trajectory, and runs through
the same steps. Not ported yet (ROADMAP A9 part 2, second half: they come
with the observability registry): the JAX executor's observability hook
(registry.record_pipeline_block) and its profiler.capture bracket around
a block.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..callback import EarlyStopException
from .device_eval import build_device_eval
from .scheduler import AdaptiveBlockScheduler

__all__ = ["PipelineStats", "run_pipelined"]


class PipelineStats:
    """Per-run pipeline accounting, attached to the booster's GBDT as
    `_pipeline_stats` on every run."""

    def __init__(self):
        self.blocks = 0
        self.iterations = 0
        self.block_sizes: List[int] = []
        self.host_ms: List[float] = []      # overlapped host work / block
        self.device_ms: List[float] = []    # dispatch->results wall / block

    def add(self, k: int, host_ms: float, device_ms: float) -> None:
        self.blocks += 1
        self.iterations += int(k)
        self.block_sizes.append(int(k))
        self.host_ms.append(float(host_ms))
        self.device_ms.append(float(device_ms))

    @property
    def overlap_frac(self) -> float:
        """Fraction of total block wall covered by overlapped host work
        (0 = fully serial)."""
        wall = sum(self.device_ms)
        if wall <= 0:
            return 0.0
        return min(1.0, sum(self.host_ms) / wall)

    def as_dict(self) -> dict:
        return {
            "blocks": self.blocks,
            "iterations": self.iterations,
            "block_sizes": list(self.block_sizes),
            "host_ms": [round(v, 3) for v in self.host_ms],
            "device_ms": [round(v, 3) for v in self.device_ms],
            "overlap_frac": round(self.overlap_frac, 4),
        }


def run_pipelined(booster, *, start_iter: int, num_boost_round: int,
                  base_block: int, run_callbacks: Callable[[int, List], None],
                  has_valid: bool, stopping_rounds: int = 0) -> List:
    """Train [start_iter, num_boost_round) pipelined; returns the last
    evaluation_result_list. Raises EarlyStopException (and any callback
    exception) with the booster in the state the non-pipelined block loop
    would leave it in, so engine.train's handlers run unchanged."""
    gb = booster.gbdt
    cfg = booster.config
    sched = AdaptiveBlockScheduler(
        base_block, adaptive=bool(cfg.pipeline_adaptive_blocks),
        target_ms=float(cfg.pipeline_target_block_ms),
        max_block=int(cfg.pipeline_max_block),
        stopping_rounds=int(stopping_rounds or 0))
    dev = build_device_eval(booster) \
        if has_valid and cfg.pipeline_device_eval else None
    stats = PipelineStats()
    gb._pipeline_stats = stats
    pending: Optional[dict] = None
    evlist: List = []
    i = start_iter
    try:
        while i < num_boost_round:
            b = sched.next_block(num_boost_round - i)
            # a block that builds the fused trainer captures its graphs
            was_built = gb._fused_run is None
            t0 = time.perf_counter()
            handle = booster.update_batch_dispatch(b)
            traj = gb._fused_valid_traj
            mx = dev.dispatch(traj) \
                if dev is not None and traj is not None else None
            t1 = time.perf_counter()
            # ---- overlapped host window: the previous block's trees
            if pending is not None:
                booster.finalize_block(pending)
                pending = None
            t2 = time.perf_counter()
            # ---- the block's sync: the small metric tensors in device
            # mode; in host mode the trajectory comes over when the
            # metrics first read it below
            mhost = [None if a is None else a.cpu().numpy() for a in mx] \
                if mx is not None else None
            t3 = time.perf_counter()
            stats.add(b, (t2 - t1) * 1e3, (t3 - t0) * 1e3)
            # ---- the per-iteration metric/callback protocol (the engine
            # block loop's; early-stop decisions gate the next dispatch)
            finalized = False
            try:
                if traj is not None and has_valid:
                    try:
                        for j in range(b):
                            if mhost is not None:
                                evlist = dev.evlist_at(mhost, j)
                            else:
                                gb.valid_traj_point(j)
                                evlist = booster.eval_valid()
                            run_callbacks(i + j, evlist)
                    except EarlyStopException:
                        # this block's trees must exist before rollback
                        # pops them; then the engine's restore protocol
                        booster.finalize_block(handle)
                        finalized = True
                        gb.valid_traj_point(b - 1, host=False)
                        for _ in range(b - 1 - j):
                            booster.rollback_one_iter()
                        gb.valid_traj_point(j, host=False)
                        raise
                elif has_valid:
                    # as engine.train: without a trajectory, evaluate at
                    # the block's end
                    evlist = booster.eval_valid()
                    run_callbacks(i + b - 1, evlist)
                else:
                    for j in range(b):
                        evlist = []
                        run_callbacks(i + j, evlist)
            except BaseException:
                # any other exit: trees hold the whole block, so must
                # scores
                if not finalized:
                    booster.finalize_block(handle)
                    if traj is not None:
                        gb.valid_traj_point(b - 1, host=False)
                raise
            # host-eval mode left the valid scores at traj[b-1], the
            # block-final state; device mode never moved them off it
            pending = handle
            i += b
            sched.observe(b, t3 - t0, compiled=was_built)
    finally:
        if pending is not None:
            booster.finalize_block(pending)
    return evlist
