"""DART (boosting="dart"): dropout of trees and normalization.

Port of lightgbm_tpu/boosting/dart.py (reference src/boosting/dart.hpp:
23-211). Each iteration selects trees to drop (by drop_rate, weighted by
tree weight unless uniform_drop, at most max_drop, one forced unless
skip_drop says otherwise; numpy RandomState(drop_seed), the JAX package's
draws), takes their outputs off the training and valid scores, trains a
tree on the gradients of what is left, then scales the new tree by
1 / (k + 1) and the dropped ones by k / (k + 1) (xgboost_dart_mode: the
new tree's shrinkage is learning_rate / (k + 1) and the dropped trees
scale by k / (k + learning_rate)) and puts them back. Tree outputs are
re-predicted over the training bins and each valid set by
learner/predict.predict_binned_tree (on the card kernel V at one tree);
every score move is the tree's values times the factor, then one f32 add,
the JAX package's order; with k trees an iteration an iteration is
dropped, scaled and put back class by class, each tree on its class's
column. The trees carry their weights in their leaf values, so the model
text and predict need nothing else. DART runs one iteration a dispatch
(GBDT._fused_eligible).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..learner.predict import predict_binned_tree
from ..utils.log import Log
from .gbdt import GBDT

__all__ = ["DART"]


class DART(GBDT):
    def __init__(self, config, train_set, objective, device,
                 train_metrics=None):
        super().__init__(config, train_set, objective, device,
                         train_metrics=train_metrics)
        self.tree_weights: List[float] = []
        self.drop_indices: List[int] = []
        #: trees dropped over all iterations so far
        self.num_dropped = 0
        self._random = np.random.RandomState(config.drop_seed)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._select_dropping_trees()
        self._drop_trees()
        stop = super().train_one_iter(gradients, hessians)
        self._normalize()
        return stop

    def _select_dropping_trees(self) -> None:
        """reference dart.hpp:95-125 DroppingTrees."""
        cfg = self.config
        num_iters_done = len(self.trees) // self.num_tree_per_iteration
        self.drop_indices = []
        if num_iters_done == 0:
            return
        if cfg.uniform_drop:
            for i in range(num_iters_done):
                if self._random.rand() < cfg.drop_rate:
                    self.drop_indices.append(i)
        else:
            w = np.asarray(self.tree_weights[:num_iters_done])
            p = w / max(w.sum(), 1e-15)
            for i in range(num_iters_done):
                if self._random.rand() < cfg.drop_rate * p[i] * \
                        num_iters_done:
                    self.drop_indices.append(i)
        if len(self.drop_indices) > cfg.max_drop > 0:
            self._random.shuffle(self.drop_indices)
            self.drop_indices = sorted(self.drop_indices[:cfg.max_drop])
        if not self.drop_indices and \
                self._random.rand() >= cfg.skip_drop:
            self.drop_indices = [self._random.randint(num_iters_done)]
        self.num_dropped += len(self.drop_indices)

    def _apply_tree_to_scores(self, idx: int, factor: float,
                              bins_u=None) -> None:
        """Tree idx's outputs times factor onto its class's training and
        valid scores."""
        tree = self.trees[idx]
        cls = self.tree_class[idx]
        if bins_u is None:
            bins_u = self._train_bins_unpacked()
        self._set_class_score(cls, self._class_score(cls) +
                              predict_binned_tree(
                                  tree, bins_u, self.num_bins_d,
                                  self.missing_is_nan_d) * factor)
        for i in range(len(self.valid_sets)):
            vals = predict_binned_tree(tree, self.valid_bins[i],
                                       self.num_bins_d,
                                       self.missing_is_nan_d) * factor
            score = self.valid_scores[i]
            if self.num_tree_per_iteration > 1:
                score = score.clone()
                score[:, cls] = self.valid_scores[i][:, cls] + vals
            else:
                score = score + vals
            self._set_valid(i, score)

    def _drop_trees(self) -> None:
        # one unpack of packed bins an iteration, not one a dropped tree
        bins_u = self._train_bins_unpacked() if self.drop_indices else None
        k = self.num_tree_per_iteration
        for it in self.drop_indices:
            for cls in range(k):
                self._apply_tree_to_scores(it * k + cls, -1.0, bins_u)
        lr = float(self.config.learning_rate)
        self.shrinkage_rate = lr / max(1.0, 1.0 + len(self.drop_indices)) \
            if self.config.xgboost_dart_mode else lr

    def _normalize(self) -> None:
        """reference dart.hpp:127-181 Normalize."""
        cfg = self.config
        k_drop = len(self.drop_indices)
        if cfg.xgboost_dart_mode:
            new_factor = 1.0    # folded into the shrinkage (_drop_trees)
            old_factor = k_drop / (k_drop + float(cfg.learning_rate)) \
                if k_drop > 0 else 1.0
        else:
            new_factor = 1.0 / (k_drop + 1.0)
            old_factor = k_drop / (k_drop + 1.0)
        bins_u = self._train_bins_unpacked() \
            if (new_factor != 1.0 or
                (self.drop_indices and old_factor != 1.0)) else None
        k = self.num_tree_per_iteration
        if new_factor != 1.0:
            # the new trees went onto the scores whole: take off the part
            # their weight removes
            for idx in range(len(self.trees) - k, len(self.trees)):
                self._apply_tree_to_scores(idx, new_factor - 1.0, bins_u)
                tree = self.trees[idx]
                self.trees[idx] = tree._replace(
                    leaf_value=tree.leaf_value * new_factor)
        self.tree_weights.append(new_factor)
        # the dropped iterations back in at old_factor
        for it in self.drop_indices:
            for idx in range(it * k, it * k + k):
                self._apply_tree_to_scores(idx, old_factor, bins_u)
                tree = self.trees[idx]
                self.trees[idx] = tree._replace(
                    leaf_value=tree.leaf_value * old_factor)
            self.tree_weights[it] *= old_factor
        if self.drop_indices:
            Log.debug("DART: dropped %d trees", len(self.drop_indices))
