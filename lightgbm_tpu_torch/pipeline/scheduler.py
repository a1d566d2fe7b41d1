"""Adaptive block sizing for the pipelined executor.

Copy of lightgbm_tpu/pipeline/scheduler.py for the PyTorch/CUDA port.
Block partitioning is a pure dispatch-cadence choice: the fused trainer
advances scores iteration-exactly and the per-iteration callback protocol
runs for every inner iteration of whatever block it landed in, so any
partition of the remaining iterations trains the identical model and
stops at the identical iteration (tests/test_torch_pipeline.py pins
this). That freedom is what makes measured-rate sizing safe.

The tradeoff being tuned: larger blocks amortize more host round-trips
but coarsen the early-stop sync cadence (iterations past the stopping
point inside the final block are trained and rolled back). The scheduler
starts from the configured fused_block_size, learns the steady-state
iteration rate from completed blocks (a block in which the fused trainer
was built and its graphs captured is excluded: a capture is not a
training rate), and grows the block toward pipeline_target_block_ms per
dispatch, never crossing an early_stopping_rounds boundary and never
exceeding pipeline_max_block.
"""

from __future__ import annotations

__all__ = ["AdaptiveBlockScheduler"]


class AdaptiveBlockScheduler:
    def __init__(self, base_block: int, *, adaptive: bool = True,
                 target_ms: float = 250.0, max_block: int = 200,
                 stopping_rounds: int = 0):
        self.base = max(1, int(base_block))
        self.adaptive = bool(adaptive)
        self.target_s = float(target_ms) / 1e3
        self.max_block = max(1, int(max_block))
        self.stopping_rounds = max(0, int(stopping_rounds))
        self._rate = None  # iterations/sec EMA over post-capture blocks

    @property
    def rate(self):
        return self._rate

    def next_block(self, remaining: int) -> int:
        k = self.base
        if self.adaptive and self._rate is not None:
            # never shrink below the configured base: the user asked for
            # at least that much amortization per dispatch
            k = max(self.base, int(self._rate * self.target_s))
        if self.stopping_rounds:
            # align with the early-stop window: at most one stopping
            # span of overrun compute sits past the decision point
            k = min(k, self.stopping_rounds)
        return max(1, min(k, self.max_block, int(remaining)))

    def observe(self, k: int, wall_s: float, compiled: bool = False) -> None:
        if compiled or wall_s <= 0:
            return
        r = k / wall_s
        self._rate = r if self._rate is None else 0.5 * self._rate + 0.5 * r
