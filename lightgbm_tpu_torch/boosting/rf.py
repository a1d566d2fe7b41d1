"""Random forest (boosting="rf"): bagged trees, no shrinkage, averaged.

Port of lightgbm_tpu/boosting/rf.py (reference src/boosting/rf.hpp:25-217).
Bagging is required (bagging_freq > 0, bagging_fraction < 1). Every tree
is fitted to the gradients at the constant boost-from-average score, which
is kept apart from the trees (no bias is folded into tree 0); the training
and valid scores hold the plain sum of the trees, and the metrics see
score / iterations + the init score, as in the JAX package; with k
trees an iteration each class keeps its own init score. The model
text says average_output, so the host model predicts the trees' mean.
RF runs one iteration a dispatch (GBDT._fused_eligible) and train_one_iter
reads each tree's leaf count: the stall poll is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .gbdt import GBDT

__all__ = ["RF"]


class RF(GBDT):
    def __init__(self, config, train_set, objective, device,
                 train_metrics=None):
        if config.bagging_freq <= 0 or config.bagging_fraction >= 1.0:
            Log.fatal("Random forest needs bagging_freq > 0 and "
                      "bagging_fraction < 1.0")
        super().__init__(config, train_set, objective, device,
                         train_metrics=train_metrics)
        self.shrinkage_rate = 1.0
        self._init_scores = [0.0] * self.num_tree_per_iteration

    @property
    def _init_score(self) -> float:
        """The first class's init score (the only one with one tree an
        iteration)."""
        return self._init_scores[0]

    def _boost_from_average(self, cls: int) -> float:
        """The average is taken once and kept for the gradients and the
        metrics (rf.hpp:49-70); nothing is added to the scores or folded
        into a tree."""
        if not self._boosted_from_average[cls] and \
                self.config.boost_from_average:
            self._init_scores[cls] = self.objective.boost_from_score(cls)
            self._boosted_from_average[cls] = True
        return 0.0

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        if (gradients is None or hessians is None) and \
                self.objective is not None:
            # the gradients at the constant init score (rf.hpp:89-108)
            for cls in range(self.num_tree_per_iteration):
                self._boost_from_average(cls)
            base = torch.empty_like(self.train_score)
            if base.dim() == 1:
                base.fill_(self._init_scores[0])
            else:
                for cls, v in enumerate(self._init_scores):
                    base[cls].fill_(v)
            gradients, hessians = self._gradients(base)
        return super().train_one_iter(gradients, hessians)

    def _eval(self, score: np.ndarray, metrics: list) -> dict:
        """The metrics of the averaged score: the trees' sum over the
        iterations (at least one), plus each class's init score, in
        f32."""
        init = np.asarray(self._init_scores, np.float32)
        avg = score / max(self.iter_, 1) + (init[0] if score.ndim == 1
                                             else init)
        return super()._eval(avg, metrics)
