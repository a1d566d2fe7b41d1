"""GBDT training loop: TrainOneIter and the learner-side scores.

Port of the serial, exact-histogram path of lightgbm_tpu/boosting/gbdt.py
(reference src/boosting/gbdt.cpp:266-572): objective gradients on the
device, one tree per iteration from learner/grower_mxu.grow_tree_mxu,
shrinkage, and the score update through the node_values kernel.

Every iteration reads the new tree's leaf count on the host (the JAX
package lags that poll to spare a remote accelerator round trips); a tree
that made no split is kept as a constant tree and update() returns True,
as in the reference. The JAX package's pipelined and fused multi-tree
executors produce byte-identical models to this per-iteration loop, so
the port runs the loop whatever `pipeline` says.

`check_supported` refuses every parameter value whose code is not ported,
naming the ROADMAP.md port-queue item that will bring it.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import Config
from ..data import BinnedDataset
from ..learner.grower import TreeArrays
from ..learner.grower_mxu import grow_tree_mxu
from ..learner.histogram_mxu import node_values
from ..learner.split import SplitHyperParams
from ..objectives import ObjectiveFunction
from ..utils.log import Log

__all__ = ["GBDT", "check_supported", "resolve_device"]


def resolve_device(device_type: str) -> torch.device:
    """The training device: the card unless the caller asks for "cpu".
    Without a CUDA device the port refuses rather than fall back."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type in ("cuda", "gpu", "cuda_exp"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lightgbm_tpu_torch trains on a CUDA device and none is "
                "available; pass device_type='cpu' to train on the CPU")
        return torch.device("cuda")
    raise ValueError(f"device_type={device_type!r}: lightgbm_tpu_torch "
                     "runs on 'cuda' or 'cpu'")


def _unsupported(cfg: Config) -> List[tuple]:
    """(param, ROADMAP.md port-queue item) for every non-default value
    whose code this port does not have yet."""
    bagging = cfg.bagging_freq > 0 and (
        cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0 or
        cfg.neg_bagging_fraction < 1.0)
    return [(name, item) for name, item, hit in [
        ("use_quantized_grad", "P2", cfg.use_quantized_grad),
        ("bagging_fraction/bagging_freq", "P6", bagging),
        ("boosting=" + str(cfg.boosting), "P6", cfg.boosting != "gbdt"),
        ("num_class", "P7", cfg.num_class > 1),
        ("level_pipeline", "P9", cfg.level_pipeline),
        ("hist_backend=" + str(cfg.hist_backend), "P4",
         cfg.hist_backend in ("pallas", "scatter")),
        ("feature_fraction", "P13", cfg.feature_fraction < 1.0),
        ("feature_fraction_bynode", "P13", cfg.feature_fraction_bynode < 1.0),
        ("extra_trees", "P13", cfg.extra_trees),
        ("monotone_constraints", "P13",
         bool(cfg.monotone_constraints) and
         any(v != 0 for v in cfg.monotone_constraints)),
        ("interaction_constraints", "P13", bool(cfg.interaction_constraints)),
        ("forcedsplits_filename", "P13", bool(cfg.forcedsplits_filename)),
        ("cegb_*", "P13",
         cfg.cegb_penalty_split > 0 or
         cfg.cegb_penalty_feature_lazy is not None or
         cfg.cegb_penalty_feature_coupled is not None),
        ("linear_tree", "P13", cfg.linear_tree),
        ("gpu_use_dp=false", "P13", not cfg.gpu_use_dp),
        ("use_pallas=false", "P13", not cfg.use_pallas),
        ("guard_nonfinite", "P13", cfg.guard_nonfinite != "off"),
        ("tree_learner=" + str(cfg.tree_learner), "P14",
         cfg.tree_learner != "serial" or cfg.num_machines > 1),
    ] if hit]


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for parameter values the port cannot
    train yet; it never runs something else in their place."""
    bad = _unsupported(cfg)
    if bad:
        raise NotImplementedError(
            "not ported to lightgbm_tpu_torch yet: " +
            ", ".join(f"{name} (ROADMAP.md port queue {item})"
                      for name, item in bad))


class GBDT:
    """Gradient Boosted Decision Trees trainer (reference gbdt.h:35)."""

    def __init__(self, config: Config, train_set: BinnedDataset,
                 objective: ObjectiveFunction, device: torch.device):
        check_supported(config)
        self.config = config
        self.objective = objective
        self.device = device
        self.shrinkage_rate = float(config.learning_rate)
        self.num_tree_per_iteration = 1
        self.iter_ = 0
        self.trees: List[TreeArrays] = []
        self.tree_class: List[int] = []
        self._setup_train(train_set)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        dev = self.device
        self.num_data = ds.num_data
        self.bmax = int(ds.num_bins.max()) if ds.num_features else 2
        if self.bmax > 256:
            raise NotImplementedError(
                "max_bin > 256 needs the portable grower, not ported to "
                "lightgbm_tpu_torch yet (ROADMAP.md port queue P13)")
        self.bins = torch.as_tensor(ds.bins, device=dev).contiguous()
        self.num_bins_d = torch.as_tensor(ds.num_bins, device=dev)
        self.missing_is_nan_d = torch.as_tensor(ds.missing_types == 2,
                                                device=dev)
        self.is_cat_d = torch.as_tensor(ds.is_categorical, device=dev)
        self.train_score = torch.zeros(self.num_data, dtype=torch.float32,
                                       device=dev)
        self._has_init_score = ds.metadata.init_score is not None
        if self._has_init_score:
            self.train_score = torch.as_tensor(
                ds.metadata.init_score.reshape(-1), dtype=torch.float32,
                device=dev)
        # no bagging: every row counts once in the count channel
        self._cnt = torch.ones(self.num_data, dtype=torch.float32,
                               device=dev)
        self._feature_mask = torch.ones(ds.num_features, dtype=torch.float32,
                                        device=dev)
        self.hp = SplitHyperParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_gain_to_split=cfg.min_gain_to_split,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            max_delta_step=cfg.max_delta_step,
            path_smooth=cfg.path_smooth, cat_l2=cfg.cat_l2,
            cat_smooth=cfg.cat_smooth,
            max_cat_threshold=cfg.max_cat_threshold,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            min_data_per_group=cfg.min_data_per_group,
            has_categorical=bool(ds.is_categorical.any()))
        self._boosted_from_average = False
        self.objective.init(ds.metadata, ds.num_data, dev)

    def _const_hessian(self) -> float:
        """Constant-hessian fast path (reference IsConstantHessian,
        objective_function.h:42): per-row hessians are const x the count
        weight, so the kernels drop the hessian channel. User weights ride
        the hessian but not the count, so they turn it off."""
        if self.objective.is_constant_hessian and \
                self.objective.weight is None:
            return float(self.objective.constant_hessian_value)
        return 0.0

    def _grow(self, grad, hess):
        cfg = self.config
        return grow_tree_mxu(
            self.bins, grad, hess, self._cnt, self._feature_mask,
            self.num_bins_d, self.missing_is_nan_d, self.is_cat_d,
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth, hp=self.hp,
            bmax=self.bmax, tail_split_cap=cfg.tail_split_cap,
            hist_subtraction=cfg.hist_subtraction,
            overshoot=cfg.growth_overshoot,
            bridge_gate=cfg.growth_bridge_gate,
            const_hessian=self._const_hessian())

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference TrainOneIter gbdt.cpp:371-449).
        Returns True if training cannot continue (no split made)."""
        cfg = self.config
        init_score = self._boost_from_average()
        grad, hess = self.objective.get_gradients(self.train_score)
        tree, row_node = self._grow(grad, hess)
        if int(tree.num_leaves) > 1:
            # shrinkage (tree.cpp Shrinkage), then the learner-side score
            # update (score_updater.hpp:21-110) through node_values
            tree = tree._replace(
                leaf_value=tree.leaf_value * self.shrinkage_rate)
            self.train_score = self.train_score + \
                node_values(row_node, tree.leaf_value)
            if abs(init_score) > 1e-35:
                # AddBias (gbdt.cpp:416-417): fold the init score into
                # the first tree's leaves
                tree = tree._replace(leaf_value=torch.where(
                    tree.split_feature < 0, tree.leaf_value + init_score,
                    tree.leaf_value))
            finished = False
        else:
            value = 0.0
            if not self.trees:
                value = init_score
                if not cfg.boost_from_average and not self._has_init_score:
                    value = self.objective.boost_from_score(0)
                    self.train_score = self.train_score + value
            tree = self._constant_tree(value)
            finished = True
        self.trees.append(tree)
        self.tree_class.append(0)
        self.iter_ += 1
        return finished

    def _constant_tree(self, value: float) -> TreeArrays:
        m1 = 2 * self.config.num_leaves
        dev = self.device
        zf = torch.zeros(m1, dtype=torch.float32, device=dev)
        zi = torch.zeros(m1, dtype=torch.int32, device=dev)
        zb = torch.zeros(m1, dtype=torch.bool, device=dev)
        neg = torch.full((m1,), -1, dtype=torch.int32, device=dev)
        leaf_value = zf.clone()
        leaf_value[0] = value
        is_leaf = zb.clone()
        is_leaf[0] = True
        return TreeArrays(
            split_feature=neg, threshold_bin=zi, default_left=zb, is_cat=zb,
            cat_bitset=torch.zeros((m1, (self.bmax + 31) // 32),
                                   dtype=torch.int64, device=dev),
            left=neg, right=neg, parent=neg, leaf_value=leaf_value,
            sum_grad=zf, sum_hess=zf, count=zf, gain=zf, depth=zi,
            is_leaf=is_leaf,
            num_nodes=torch.tensor(1, dtype=torch.int32, device=dev),
            num_leaves=torch.tensor(1, dtype=torch.int32, device=dev))

    def _boost_from_average(self) -> float:
        """BoostFromAverage (gbdt.cpp:335-344): the first iteration starts
        every score from the objective's average."""
        if (self.trees or self._boosted_from_average or
                self._has_init_score or not self.config.boost_from_average):
            return 0.0
        init = self.objective.boost_from_score(0)
        if abs(init) > 1e-35:
            self.train_score = self.train_score + init
            Log.info("Start training from score %f", init)
            self._boosted_from_average = True
            return init
        return 0.0

    def current_iteration(self) -> int:
        return self.iter_
