"""GBDT training loop: TrainOneIter and the learner-side scores.

Port of the serial, exact-histogram path of lightgbm_tpu/boosting/gbdt.py
(reference src/boosting/gbdt.cpp:266-572): objective gradients on the
device, one tree per iteration from learner/grower_mxu.grow_tree_mxu,
shrinkage, and the score update through the node_values kernel. With
use_quantized_grad each tree grows on gradients quantized under the JAX
package's per-tree key, fold_in(PRNGKey(extra_seed), iteration), the key
extra_trees and feature_fraction_bynode draw from too; feature_fraction
masks each tree's features by a permutation under
fold_in(PRNGKey(feature_fraction_seed), iteration). Monotone constraints
(basic method) and interaction constraints are mapped to used-feature
order. _mxu_grow_kwargs is the single source of the grower's settings; the
booster never sets use_scan_kernel, as in the JAX package (the fused
split-scan kernel is reached through grow_tree_mxu itself).

The histogram backend (hist_backend) is resolved once, before the first
tree, as in the JAX package: "auto" times the mxu kernels against the
slot-grouped scatter kernel on the card in the quantized posture and pins
the faster. Bin matrices whose every feature fits a nibble are stored
4-bit packed where the JAX package packs them (bin_pack_4bit).

train_one_iter reads each new tree's leaf count on the host; a tree that
made no split is kept as a constant tree and update() returns True, as in
the reference. train_one_iter(grad, hess) trains on a caller's gradients
(a custom objective; set_custom_objective drops the const-hessian gate).

Validation sets (add_valid) are binned with the training set's mappers and
scored on the device by learner/predict.py (the kernel
csrc/predict_binned.cu on the card): add_valid replays the existing trees,
train_one_iter adds each new tree, rollback_one_iter subtracts the last
tree from the training and valid scores, and train_many scores a block's
stacked trees over each valid set once, leaving the per-iteration
trajectory (_fused_valid_traj) that engine.train evaluates every inner
iteration from, as the JAX package's block dispatch does. Metrics run on
the host (metrics.py); a score comes to the host once for every
evaluation, a block's trajectory once a block.

train_many runs K iterations through the fused trainer
(boosting/fused.py: CUDA graphs on the card, the same programs eagerly on
the CPU), byte-identical to K train_one_iter calls: a stalled tree
becomes the same constant tree on the device, and the stall poll is
lagged, as in the JAX package (each block's last leaf count is copied
back without waiting and read when a later block crosses a poll
boundary). Iteration 0 always runs train_one_iter, which owns
boost-from-average. The JAX package's pipelined executor produces the
same models as block dispatch, so the port ignores `pipeline`; its
retry-and-fall-back around a fused dispatch (reliability, ROADMAP A9) is
not ported: a failed dispatch raises.

Row sampling (the JAX package's gbdt.py:925-975, reference
gbdt.cpp:183-264 and goss.hpp): each tree grows on a sample of the rows
drawn by _sample. Bagging (bagging_fraction, or pos_/neg_bagging_fraction
by the objective's label, every bagging_freq iterations) zeroes the
gradients, hessians and count of the rows out of the bag; the mask is a
stateless function of the resample iteration, under
fold_in(PRNGKey(bagging_seed), it - it % bagging_freq), kept between
boundaries. GOSS (boosting="goss") keeps the rows whose |g| x h reaches
the top_k-th largest (top_k = max(1, int(N x top_rate)), in the total
order of lax.top_k), and of the rest those whose uniform under the next
key of the booster's stream (split of PRNGKey(seed)) falls below
other_rate / (1 - top_rate), their gradients and hessians amplified by
(1 - top_rate) / other_rate; it turns the const-hessian gate off. Both ride
the fused trainer: bagging recomputes its mask from the device iteration,
GOSS reads keys the host draws from the same stream before each block.
create_boosting picks GBDT, RF (boosting/rf.py) or DART (boosting/dart.py),
which run one iteration a dispatch, as in the JAX package.

Multiclass objectives (num_model_per_iteration = num_class = k > 1) grow k
trees an iteration on the gradients of one objective call, each tree's
values added into its class's score (the JAX package's gbdt.py:1018-1024,
reference gbdt.cpp:371): the training score and the gradients are
class-major, [k, N], so each class's row is the contiguous [N] the growth
kernels take; validation scores are [N, k], the layout of kernel V's
class mode (a thread a row holds its k scores). Boost-from-average, the
constant first trees, rollback and the stall poll work per class; the
trees are kept in the model text's order, iteration-major, class-minor
(tree_class). Objectives that renew their leaves (L1, Huber, Fair,
quantile, MAPE) set each leaf to a weighted percentile of its rows'
residuals after growth (learner/renew.py), before shrinkage, and run one
iteration a dispatch, as in the JAX package.

`check_supported` refuses every parameter value whose code is not ported,
naming the ROADMAP.md port-queue item that will bring it.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import math

import numpy as np
import torch

from .. import rng
from ..config import Config
from ..data import BinnedDataset
from ..learner.grower import TreeArrays
from ..learner.grower_mxu import (Grower, _kernel_cap,
                                  autotune_hist_backend)
from ..learner.histogram_mxu import (fits_v2, node_values, pack_bins_4bit,
                                     unpack_bins_4bit)
from ..learner.predict import (class_score_add, predict_binned_tree,
                               stacked_score_traj)
from ..learner.renew import renew_tree_output
from ..learner.split import SplitHyperParams
from ..objectives import ObjectiveFunction, gradients_at
from ..utils.log import Log

__all__ = ["GBDT", "check_supported", "create_boosting", "resolve_device"]

# train_many reads a block's stall state every this many iterations (the
# JAX package's _stop_poll_every)
_STOP_POLL_EVERY = 8


def _feature_mask(it, *, f: int, fraction: float, seed: int,
                  device: torch.device) -> torch.Tensor:
    """Iteration `it`'s feature_fraction mask [F] f32: the first
    max(1, round(F * fraction)) features of a permutation under
    fold_in(PRNGKey(seed), it), as the JAX package draws it. it: an int,
    or a device int32 scalar (the fused trainer's iteration, which its
    graphs replay)."""
    if fraction >= 1.0:
        return torch.ones(f, dtype=torch.float32, device=device)
    key = rng.fold_in(rng.PRNGKey(seed, device), it)
    kf = max(1, int(round(f * fraction)))
    mask = torch.zeros(f, dtype=torch.float32, device=device)
    return mask.index_fill_(0, rng.permutation(key, f)[:kf]
                            .to(torch.int64), 1.0)


def _tree_key(it, *, seed: int, device: torch.device) -> torch.Tensor:
    """The JAX package's per-tree key, fold_in(PRNGKey(seed), it); it: an
    int or a device int32 scalar."""
    return rng.fold_in(rng.PRNGKey(seed, device), it)


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX package's weak-typed Python floats
    meet f32 arrays: comparisons and products then agree in any
    precision."""
    return float(np.float32(x))


def _bag_mask(it, *, n: int, seed: int, freq: int, fraction,
              device: torch.device) -> torch.Tensor:
    """The bagging mask [N] f32 at iteration `it` (an int, or the fused
    trainer's device int32 scalar): that of its resample boundary
    it - it % freq, 1 where a uniform under fold_in(PRNGKey(seed),
    boundary) falls below `fraction` (a float, or [N] f32 of
    pos_/neg_bagging_fraction by label), as the JAX package's _bagging and
    fused bag_fn draw it."""
    key = rng.fold_in(rng.PRNGKey(seed, device), it - it % freq)
    return (rng.uniform(key, n) < fraction).to(torch.float32)


def _bag_sample(grad, hess, it, key=None, **settings):
    """Bagging as a sampler: (grad x mask, hess x mask, mask)."""
    mask = _bag_mask(it, **settings)
    return grad * mask, hess * mask, mask


def _goss_settings(n: int, top_rate: float, other_rate: float) -> dict:
    """_goss_sample's settings for n rows, as the JAX package's _goss
    derives them."""
    return dict(top_k=max(1, int(n * top_rate)),
                rest_frac=_f32(other_rate / max(1.0 - top_rate, 1e-9)),
                amplify=_f32((1.0 - top_rate) / other_rate))


def _goss_sample(grad, hess, it=None, key=None, *, top_k: int,
                 rest_frac: float, amplify: float):
    """Gradient-based one-side sampling (the JAX package's _goss and fused
    goss_fn) under `key` [2]: rows whose |g| x h reaches the top_k-th
    largest score are kept at weight 1; of the others, those whose uniform
    falls below rest_frac at weight `amplify`, the rest at 0. Returns
    (grad x w, hess x w, cnt), cnt 1 on every kept row. The threshold is
    lax.top_k's k-th value: its total order puts +NaN above inf and -0.0
    below 0.0, so the scores are ranked as order-preserving int32 keys;
    the comparison with it is IEEE's, as in the JAX package. Class-major
    [k, N] gradients score a row by the sum of its classes' |g| x h,
    class after class."""
    score = grad.abs() * hess
    if score.dim() == 2:
        total = score[0]
        for c in range(1, score.shape[0]):
            total = total + score[c]
        score = total
    bits = score.view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    t = torch.topk(order, top_k, sorted=False).values.min()
    thresh = torch.where(t < 0, t ^ 0x7FFFFFFF, t).view(torch.float32)
    is_top = score >= thresh
    u = rng.uniform(key, score.shape[0])
    is_other = ~is_top & (u < rest_frac)
    w = torch.where(is_top, 1.0, is_other.to(torch.float32) * amplify)
    cnt = (is_top | is_other).to(torch.float32)
    return grad * w, hess * w, cnt


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
    return [(name, item) for name, item, hit in [
        ("level_pipeline", "P9", cfg.level_pipeline),
        # the JAX package grows these on its portable grower
        ("monotone_constraints_method=" +
         str(cfg.monotone_constraints_method), "P13",
         cfg.monotone_constraints is not None and
         cfg.monotone_constraints_method != "basic"),
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
        ("checkpoint_period/checkpoint_dir", "A9",
         cfg.checkpoint_period > 0 and bool(cfg.checkpoint_dir)),
    ] if hit]


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for parameter values the port cannot
    train yet; it never runs something else in their place. Every
    hist_backend is ported; the JAX package's rule that EFB pins mxu has
    no counterpart here because EFB itself is not ported (P8)."""
    bad = _unsupported(cfg)
    if bad:
        raise NotImplementedError(
            "not ported to lightgbm_tpu_torch yet: " +
            ", ".join(f"{name} (ROADMAP.md port queue {item})"
                      for name, item in bad))


class GBDT:
    """Gradient Boosted Decision Trees trainer (reference gbdt.h:35)."""

    def __init__(self, config: Config, train_set: BinnedDataset,
                 objective: Optional[ObjectiveFunction],
                 device: torch.device, train_metrics=None):
        check_supported(config)
        self.config = config
        # None: objective "none", gradients from the caller
        # (train_one_iter(grad, hess))
        self.objective = objective
        self.train_set = train_set
        self.train_metrics = list(train_metrics or [])
        # validation sets (add_valid): datasets, names, metrics, device
        # bins and scores; the host copy of each score, taken at most once
        # per state (_valid_score_host); the last block's trajectory
        self.valid_sets: List[BinnedDataset] = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[list] = []
        self.valid_bins: List[torch.Tensor] = []
        self.valid_scores: List[torch.Tensor] = []
        self._valid_host: List[Optional[np.ndarray]] = []
        self._fused_valid_traj: Optional[List[torch.Tensor]] = None
        self._fused_valid_traj_host: Optional[List[np.ndarray]] = None
        #: device-to-host copies of valid scores and trajectories
        self.valid_host_copies = 0
        self._custom_objective = False
        self.device = device
        self.shrinkage_rate = float(config.learning_rate)
        self.num_class = max(int(config.num_class), 1)
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else self.num_class)
        self.iter_ = 0
        self.trees: List[TreeArrays] = []
        self.tree_class: List[int] = []
        self._fused_run = None
        #: the stats of each fused trainer built (FusedTrainer.stats),
        #: kept after release_fused
        self.fused_stats: List[dict] = []
        self._grower_obj = None
        # the lagged stall poll of train_many: the last leaf count of the
        # latest block, copied to the host without waiting
        self._pending_nleaves = None
        self.stall_polls = 0    # host reads of a pending leaf count
        # GOSS's key stream (_next_key), split once a draw
        self._rng_key = rng.PRNGKey(int(config.seed), device)
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
        # 4-bit packed bin storage (reference dense_bin.hpp:42) where the
        # JAX package packs: every feature fits a nibble and every growth
        # pass fits the fused/v2 kernels (the v1 fallback would unpack the
        # whole matrix per call); no EFB and no linear trees in the port.
        # Packed on the host, so the matrix goes to the device once.
        bins = ds.bins
        self._packed4 = False
        if cfg.bin_pack_4bit and self.bmax <= 16:
            over = cfg.growth_overshoot if cfg.growth_overshoot >= 1.0 \
                else 0.0
            L_g = int(math.ceil(cfg.num_leaves * over)) if over \
                else cfg.num_leaves
            if fits_v2(L_g + 1, ds.num_features, self.bmax,
                       cfg.use_quantized_grad):
                packed = pack_bins_4bit(ds.bins)
                if packed is not None:
                    bins = packed
                    self._packed4 = True
                    Log.debug("bin matrix packed 4-bit: [%d, %d] bytes",
                              ds.num_data, packed.shape[1])
        self.bins = torch.as_tensor(bins, device=dev).contiguous()
        # resolved before the first tree (_resolved_hist_backend)
        self._hist_backend = None
        self._hist_autotune = None
        self.num_bins_d = torch.as_tensor(ds.num_bins, device=dev)
        self.missing_is_nan_d = torch.as_tensor(ds.missing_types == 2,
                                                device=dev)
        self.is_cat_d = torch.as_tensor(ds.is_categorical, device=dev)
        # [N], or class-major [k, N] (an init score comes as the JAX
        # package reads it, [N, k] row-major)
        k = self.num_tree_per_iteration
        self.train_score = torch.zeros(
            (self.num_data,) if k == 1 else (k, self.num_data),
            dtype=torch.float32, device=dev)
        self._has_init_score = ds.metadata.init_score is not None
        if self._has_init_score:
            init = np.asarray(ds.metadata.init_score, np.float32)
            init = init.reshape(-1) if k == 1 else \
                init.reshape(self.num_data, k).T
            self.train_score = torch.as_tensor(
                np.ascontiguousarray(init), device=dev)
        # unsampled, every row counts once in the count channel
        self._cnt = torch.ones(self.num_data, dtype=torch.float32,
                               device=dev)
        # monotone constraints (original-feature order -> used-feature order)
        self._monotone = None
        has_monotone = False
        if cfg.monotone_constraints:
            mc = np.zeros(ds.num_total_features, np.int32)
            arr = np.asarray(cfg.monotone_constraints, np.int32)
            mc[:len(arr)] = arr
            used = np.asarray(ds.used_features, np.int64)
            if np.any(mc[used] != 0):
                self._monotone = torch.as_tensor(mc[used], device=dev)
                has_monotone = True
        # interaction constraints (groups of original feature indices)
        self._interaction_groups = None
        if cfg.interaction_constraints:
            orig2used = {int(o): j for j, o in enumerate(ds.used_features)}
            groups = []
            for grp in cfg.interaction_constraints:
                if not isinstance(grp, (list, tuple)):
                    grp = [grp]
                groups.append(tuple(sorted(
                    orig2used[int(fi)] for fi in grp
                    if int(fi) in orig2used)))
            self._interaction_groups = tuple(g for g in groups if g)
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
            has_monotone=has_monotone,
            monotone_penalty=cfg.monotone_penalty,
            extra_trees=cfg.extra_trees,
            has_categorical=bool(ds.is_categorical.any()))
        self._boosted_from_average = [False] * k
        if self.objective is not None:
            self.objective.init(ds.metadata, ds.num_data, dev)

    def _const_hessian(self) -> float:
        """Constant-hessian fast path (reference IsConstantHessian,
        objective_function.h:42): per-row hessians are const x the count
        weight, so the kernels drop the hessian channel. User weights ride
        the hessian but not the count, so they turn it off, and so do a
        custom objective (set_custom_objective), whose hessians are the
        caller's, and GOSS, whose amplified rows count 1. A bagging mask
        scales the hessian and the count alike and keeps it."""
        if (not self._custom_objective and self.objective is not None and
                self.objective.is_constant_hessian and
                self.objective.weight is None and
                self.config.boosting != "goss"):
            return float(self.objective.constant_hessian_value)
        return 0.0

    def set_custom_objective(self) -> None:
        """Mark this booster as trained on a caller's gradients (the JAX
        package's set_custom_objective): drops the constant-hessian gate,
        and the Grower and fused trainer built with it."""
        if not self._custom_objective:
            self._custom_objective = True
            self._grower_obj = None
            self._fused_run = None

    def _resolved_hist_backend(self) -> str:
        """config.hist_backend as a concrete backend for grow_tree_mxu,
        resolved once and pinned for the run (the JAX package's rules).
        "auto" autotunes mxu against the scatter kernel only in the
        quantized posture, with hist_autotune on and on the card: there
        integer sums make the backends bit-identical, so the choice is a
        speed knob only. Exact mode (last-bit summation order), a
        hist_autotune=false run and the CPU (nothing real to time) pin
        mxu. The outcome is kept in self._hist_autotune."""
        if self._hist_backend is not None:
            return self._hist_backend
        cfg = self.config
        hb = cfg.hist_backend
        timings: dict = {}
        autotuned = False
        if hb == "auto":
            if (self.device.type == "cpu" or not cfg.hist_autotune or
                    not cfg.use_quantized_grad):
                hb = "mxu"
            else:
                over = cfg.growth_overshoot \
                    if cfg.growth_overshoot >= 1.0 else 1.0
                s_max = int(math.ceil(cfg.num_leaves * over)) + 1
                s_rep = max(2, _kernel_cap(s_max)
                            if cfg.hist_subtraction else s_max)
                hb, timings = autotune_hist_backend(
                    self.bins, num_slots=s_rep, bmax=self.bmax,
                    num_features=(int(self.num_bins_d.shape[0])
                                  if self._packed4 else 0),
                    quantized=True, const_hess=self._const_hessian())
                autotuned = True
                Log.info("hist_backend=auto picked %s (%s)", hb,
                         ", ".join("%s=%.2fms" % kv
                                   for kv in sorted(timings.items())))
        self._hist_backend = hb
        self._hist_autotune = {"choice": hb, "autotuned": autotuned,
                               "timings_ms": dict(timings)}
        return hb

    def _mxu_grow_kwargs(self) -> dict:
        """grow_tree_mxu's settings for this booster, the single source
        (the JAX package's _mxu_grow_kwargs); the per-tree inputs (feature
        mask, key) come from _feature_mask_at and _tree_key."""
        cfg = self.config
        return dict(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth, hp=self.hp,
            bmax=self.bmax, monotone=self._monotone,
            interaction_groups=self._interaction_groups,
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            tail_split_cap=cfg.tail_split_cap,
            hist_subtraction=cfg.hist_subtraction,
            overshoot=cfg.growth_overshoot,
            bridge_gate=cfg.growth_bridge_gate,
            const_hessian=self._const_hessian(),
            quantized_grad=cfg.use_quantized_grad, packed4=self._packed4,
            hist_backend=self._resolved_hist_backend(),
            partition_impl=cfg.partition_impl)

    def _mask_settings(self) -> dict:
        cfg = self.config
        return dict(f=int(self.num_bins_d.shape[0]),
                    fraction=cfg.feature_fraction,
                    seed=cfg.feature_fraction_seed, device=self.device)

    def _feature_mask_at(self, it) -> torch.Tensor:
        """Iteration `it`'s feature_fraction mask (_feature_mask)."""
        return _feature_mask(it, **self._mask_settings())

    def _needs_rng(self) -> bool:
        """Whether growth draws from the per-tree key (extra_trees, bynode
        sampling, quantized gradients)."""
        cfg = self.config
        return bool(self.hp.extra_trees or cfg.feature_fraction_bynode < 1.0
                    or cfg.use_quantized_grad)

    def _tree_key(self, it=None):
        """The JAX package's per-tree key, fold_in(PRNGKey(extra_seed), it)
        (it: this iteration by default, an int or a device int32 scalar),
        where growth draws from it; else None."""
        if not self._needs_rng():
            return None
        return _tree_key(self.iter_ if it is None else it,
                         seed=self.config.extra_seed, device=self.device)

    def _grower(self) -> Grower:
        """The booster's Grower (grow_tree_mxu's programs with this
        booster's settings), built once: the per-iteration path and the
        fused trainer grow through it."""
        if self._grower_obj is None:
            self._grower_obj = Grower(
                self.bins, self.num_bins_d, self.missing_is_nan_d,
                self.is_cat_d, **self._mxu_grow_kwargs())
        return self._grower_obj

    def _grow(self, grad, hess, cnt=None):
        """This iteration's tree, grown on its row sample of (grad, hess):
        drawn here (_sample), or given as its count cnt with the sampled
        gradients of one class (the classes of an iteration share one
        sample)."""
        if cnt is None:
            grad, hess, cnt = self._sample(grad, hess)
        return self._grower().grow(grad, hess, cnt,
                                   self._feature_mask_at(self.iter_),
                                   self._tree_key())

    # ------------------------------------------------------------------
    # row sampling: bagging and GOSS
    def _needs_bagging(self) -> bool:
        cfg = self.config
        return cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0)

    def _next_key(self) -> torch.Tensor:
        """The next key of the booster's stream: split(key) into (key,
        draw), as the JAX package's _next_key."""
        self._rng_key, sub = rng.split(self._rng_key)
        return sub

    def _sample_fn(self):
        """(sample_fn(grad, hess, it, key) -> (grad, hess, cnt), whether it
        takes keys), or (None, False) with no sampling: the per-iteration
        path's and the fused trainer's one definition (a partial of a
        module function: the trainer holds no reference to the
        booster)."""
        cfg = self.config
        if cfg.boosting == "goss":
            return functools.partial(_goss_sample, **_goss_settings(
                self.num_data, cfg.top_rate, cfg.other_rate)), True
        if not self._needs_bagging():
            return None, False
        fraction = _f32(cfg.bagging_fraction)
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            fraction = torch.where(
                self.objective.label > 0,
                _f32(cfg.pos_bagging_fraction),
                _f32(cfg.neg_bagging_fraction)).to(torch.float32)
        return functools.partial(
            _bag_sample, n=self.num_data, seed=cfg.bagging_seed,
            freq=cfg.bagging_freq, fraction=fraction,
            device=self.device), False

    def _sample(self, grad, hess):
        """(grad, hess, cnt) of this iteration's row sample: GOSS under
        the next key; the bagging mask of the current resample boundary
        (a function of the boundary alone, so it is drawn anew each
        iteration and equals the mask drawn at the boundary); else the
        gradients as they are and a count of ones."""
        fn, keyed = self._sample_fn()
        if fn is None:
            return grad, hess, self._cnt
        return fn(grad, hess, self.iter_,
                  self._next_key() if keyed else None)

    def _gradients(self, score: torch.Tensor):
        """The objective's gradients at `score`, this iteration's."""
        return gradients_at(self.objective, score, self.iter_)

    def train_one_iter(self, gradients: Optional[torch.Tensor] = None,
                       hessians: Optional[torch.Tensor] = None) -> bool:
        """One boosting iteration (reference TrainOneIter gbdt.cpp:371-449),
        on the objective's gradients or, where given, the caller's ([N] f32,
        or [k, N] with k trees an iteration, on the training device): one
        tree a class. Returns True if training cannot continue (no tree of
        the iteration made a split)."""
        cfg = self.config
        k = self.num_tree_per_iteration
        init_scores = [0.0] * k
        if gradients is None or hessians is None:
            if self.objective is None:
                raise ValueError("objective 'none' trains on the caller's "
                                 "gradients: pass them (fobj)")
            for cls in range(k):
                init_scores[cls] = self._boost_from_average(cls)
            gradients, hessians = self._gradients(self.train_score)
        renew = self.objective is not None and \
            self.objective.need_renew_tree_output
        cnt = None
        if k > 1 or renew:
            # one row sample an iteration, shared by its classes
            gradients, hessians, cnt = self._sample(gradients, hessians)
        first = self.iter_ == 0
        finished = True
        for cls in range(k):
            g = gradients if k == 1 else gradients[cls]
            h = hessians if k == 1 else hessians[cls]
            tree, row_node = self._grow(g, h) if cnt is None \
                else self._grow(g, h, cnt)
            if int(tree.num_leaves) > 1:
                finished = False
                score = self._class_score(cls)
                if renew:
                    obj = self.objective
                    rw = cnt if obj.weight is None else cnt * obj.weight
                    tree = renew_tree_output(tree, row_node, score,
                                             obj.label, rw,
                                             obj.renew_percentile)
                # shrinkage (tree.cpp Shrinkage), then the learner-side
                # score update (score_updater.hpp:21-110) through
                # node_values
                tree = tree._replace(
                    leaf_value=tree.leaf_value * self.shrinkage_rate)
                self._set_class_score(
                    cls, score + node_values(row_node, tree.leaf_value))
                self._update_valid(tree, cls)
                if abs(init_scores[cls]) > 1e-35:
                    # AddBias (gbdt.cpp:416-417): fold the init score into
                    # the first tree's leaves
                    tree = tree._replace(leaf_value=torch.where(
                        tree.split_feature < 0,
                        tree.leaf_value + init_scores[cls],
                        tree.leaf_value))
            else:
                value = 0.0
                if first:
                    value = init_scores[cls]
                    if (self.objective is not None and
                            not cfg.boost_from_average and
                            not self._has_init_score):
                        value = self.objective.boost_from_score(cls)
                        self._add_const_score(value, cls)
                tree = self._constant_tree(value)
                if not first:
                    # the valid scores take the constant tree's zeros, as
                    # the fused trainer's trajectory does
                    self._update_valid(tree, cls)
            self.trees.append(tree)
            self.tree_class.append(cls)
        self.iter_ += 1
        return finished

    def _class_score(self, cls: int) -> torch.Tensor:
        """The training score of class cls ([N])."""
        return self.train_score if self.num_tree_per_iteration == 1 \
            else self.train_score[cls]

    def _set_class_score(self, cls: int, score: torch.Tensor) -> None:
        if self.num_tree_per_iteration == 1:
            self.train_score = score
            return
        new = self.train_score.clone()
        new[cls] = score
        self.train_score = new

    # ------------------------------------------------------------------
    # K iterations per dispatch (boosting/fused.py)
    def _fused_eligible(self) -> bool:
        """Whether engine.train may dispatch K iterations at a time
        through the fused trainer, with the trees of K train_one_iter
        calls: the JAX package's rule (gbdt or GOSS on the serial grower,
        bagging and k trees an iteration included; not RF or DART; no
        guard rails, no linear trees, no leaf renewal, no CEGB, no custom
        objective)."""
        cfg = self.config
        return (type(self) is GBDT and cfg.boosting in ("gbdt", "goss")
                and cfg.guard_nonfinite == "off" and not cfg.linear_tree
                and self.objective is not None
                and not self.objective.need_renew_tree_output
                and not self._custom_objective)

    def _build_fused(self):
        """The fused trainer. It gets no reference to the booster (its
        draws are plain functions of the iteration), so dropping the
        booster or release_fused frees its graphs at once, without a
        garbage collection."""
        from .fused import build_fused_train
        key_fn = None
        if self._needs_rng():
            key_fn = functools.partial(_tree_key,
                                       seed=self.config.extra_seed,
                                       device=self.device)
        sample_fn, keyed = self._sample_fn()
        return build_fused_train(
            objective=self.objective, grower=self._grower(),
            cnt_weight=self._cnt, sample_fn=sample_fn, sample_keys=keyed,
            feature_mask_fn=functools.partial(_feature_mask,
                                              **self._mask_settings()),
            key_fn=key_fn, shrinkage=self.shrinkage_rate,
            const_tree=self._constant_tree(0.0),
            block=self.config.fused_block_size,
            num_class=self.num_tree_per_iteration)

    def release_fused(self) -> None:
        """Free the fused trainer: its CUDA graphs, their memory pool and
        its buffers (engine.train does, when it is done). A later
        train_many builds and captures a new one."""
        self._fused_run = None

    def train_many(self, k: int) -> bool:
        """K boosting iterations, the same trees and scores as K
        train_one_iter calls, with the trees of iterations after the first
        grown by the fused trainer (a booster _fused_eligible refuses, RF
        or DART, runs them one by one). Returns True when training cannot
        continue (the lagged stall poll)."""
        return self.finalize_block(self.train_many_dispatch(k))

    def train_many_dispatch(self, k: int) -> dict:
        """First half of train_many: run the k iterations and leave all
        but appending the trees done; returns the handle finalize_block
        takes. Iteration 0 runs train_one_iter (boost-from-average); a run
        that stalls there finishes the block with train_one_iter too. Every
        path leaves the block's k-point valid-score trajectory in
        _fused_valid_traj (the JAX package's gbdt.py:1423-1440,1556-1578):
        the per-iteration points it ran, then the fused block's, scored
        over each valid set by one stacked_score_traj launch."""
        self._fused_valid_traj = None
        self._fused_valid_traj_host = None
        lead: List[List[torch.Tensor]] = [[] for _ in self.valid_sets]

        def snap():
            for i, pts in enumerate(lead):
                pts.append(self.valid_scores[i])

        def seal():
            if lead and lead[0]:
                self._fused_valid_traj = [torch.stack(p) for p in lead]

        stop = False
        if self.iter_ == 0 and k > 0:
            stop = self.train_one_iter()
            k -= 1
            snap()
            if stop:
                for _ in range(k):
                    self.train_one_iter()
                    snap()
                seal()
                return {"mode": "done", "stop": True}
        if k <= 0 or not self._fused_eligible():
            for _ in range(k):
                stop = self.train_one_iter() or stop
                snap()
            seal()
            return {"mode": "done", "stop": stop}
        if self._fused_run is None:
            self._fused_run = self._build_fused()
            self.fused_stats.append(self._fused_run.stats)
        # GOSS: the keys k train_one_iter calls would draw, drawn ahead
        keys = torch.stack([self._next_key() for _ in range(k)]) \
            if self._fused_run.sample_keys else None
        score, stacked = self._fused_run(self.train_score, self.iter_, k,
                                         keys)
        self.train_score = score
        kcls = self.num_tree_per_iteration
        if self.valid_sets:
            trajs = []
            for i, pts in enumerate(lead):
                fin, traj = stacked_score_traj(
                    stacked, self.valid_scores[i], self.valid_bins[i],
                    self.num_bins_d, self.missing_is_nan_d,
                    num_class=kcls)
                if pts:
                    traj = torch.cat([torch.stack(pts), traj])
                self._set_valid(i, fin)
                trajs.append(traj)
            self._fused_valid_traj = trajs
        self.iter_ += k
        # lagged stall poll: read the count an earlier block left (its copy
        # has long landed) when this block crossed a poll boundary
        crossed = (self.iter_ // _STOP_POLL_EVERY !=
                   (self.iter_ - k) // _STOP_POLL_EVERY)
        stop_hint = crossed and self._pending_nleaves is not None and \
            self._read_pending() <= 1
        last = stacked.num_leaves[k - 1]
        # stalled only if every class's tree is
        self._pending_nleaves = self._start_copy(
            last if kcls == 1 else last.amax())
        return {"mode": "fused", "stacked": stacked, "k": k,
                "kcls": kcls, "stop": stop_hint}

    def finalize_block(self, handle: dict) -> bool:
        """Second half of train_many: the block's trees, views of its
        stack, onto self.trees (no device work)."""
        if handle["mode"] == "fused":
            stacked, kcls = handle["stacked"], handle["kcls"]
            for i in range(handle["k"]):
                if kcls == 1:
                    self.trees.append(TreeArrays(*[t[i] for t in stacked]))
                    self.tree_class.append(0)
                    continue
                for c in range(kcls):
                    self.trees.append(TreeArrays(*[t[i, c]
                                                   for t in stacked]))
                    self.tree_class.append(c)
        return handle["stop"]

    def _start_copy(self, count: torch.Tensor):
        """(host tensor, event) of a device scalar being copied back
        without waiting; the CPU's own tensor on the CPU."""
        if count.device.type != "cuda":
            return count, None
        host = torch.empty((), dtype=count.dtype, pin_memory=True)
        host.copy_(count, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _read_pending(self) -> int:
        host, event = self._pending_nleaves
        if event is not None:
            event.synchronize()
        self.stall_polls += 1
        return int(host)

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

    def _boost_from_average(self, cls: int) -> float:
        """BoostFromAverage (gbdt.cpp:335-344): the first iteration starts
        class cls's scores from the objective's average."""
        if (self.trees or self._boosted_from_average[cls] or
                self._has_init_score or self.objective is None or
                not self.config.boost_from_average):
            return 0.0
        init = self.objective.boost_from_score(cls)
        if abs(init) > 1e-35:
            self._add_const_score(init, cls)
            Log.info("Start training from score %f", init)
            self._boosted_from_average[cls] = True
            return init
        return 0.0

    def _add_const_score(self, value: float, cls: int = 0) -> None:
        """A constant onto class cls's training and valid scores."""
        self._set_class_score(cls, self._class_score(cls) + value)
        for i in range(len(self.valid_sets)):
            score = self.valid_scores[i]
            if self.num_tree_per_iteration > 1:
                score = score.clone()
                score[:, cls] = self.valid_scores[i][:, cls] + value
            else:
                score = score + value
            self._set_valid(i, score)

    # ------------------------------------------------------------------
    # validation sets
    def add_valid(self, ds: BinnedDataset, name: str, metrics: list) -> None:
        """A validation set binned with the training set's mappers: its
        bins go to the device once, its score starts at its init score (or
        zeros) and replays the trees trained so far (the JAX package's
        add_valid, gbdt.py:888-921)."""
        if ds.num_features != int(self.num_bins_d.shape[0]):
            raise ValueError("validation set has other features than the "
                             "training set: bin it with reference=")
        self.valid_sets.append(ds)
        self.valid_names.append(name)
        self.valid_metrics.append(list(metrics))
        self.valid_bins.append(torch.as_tensor(ds.bins,
                                               device=self.device))
        k = self.num_tree_per_iteration
        shape = (ds.num_data,) if k == 1 else (ds.num_data, k)
        score = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if ds.metadata.init_score is not None:
            score = torch.as_tensor(np.asarray(
                ds.metadata.init_score, np.float32).reshape(shape),
                device=self.device)
        self.valid_scores.append(score)
        self._valid_host.append(None)
        i = len(self.valid_sets) - 1
        for tree, cls in zip(self.trees, self.tree_class):
            if k > 1:
                self._set_valid(i, class_score_add(
                    tree, self.valid_scores[i], cls, self.valid_bins[i],
                    self.num_bins_d, self.missing_is_nan_d))
                continue
            self._set_valid(i, self.valid_scores[i] + predict_binned_tree(
                tree, self.valid_bins[i], self.num_bins_d,
                self.missing_is_nan_d))

    def _set_valid(self, i: int, score: torch.Tensor,
                   host: Optional[np.ndarray] = None) -> None:
        self.valid_scores[i] = score
        self._valid_host[i] = host

    def _update_valid(self, tree: TreeArrays, cls: int = 0) -> None:
        """Each valid score plus the tree's leaf values (into column cls
        with k trees an iteration): one f32 add, the trajectory step the
        fused block's stacked_score_traj takes."""
        for i in range(len(self.valid_sets)):
            if self.num_tree_per_iteration > 1:
                self._set_valid(i, class_score_add(
                    tree, self.valid_scores[i], cls, self.valid_bins[i],
                    self.num_bins_d, self.missing_is_nan_d))
                continue
            fin, _ = stacked_score_traj(
                TreeArrays(*[t.unsqueeze(0) for t in tree]),
                self.valid_scores[i], self.valid_bins[i], self.num_bins_d,
                self.missing_is_nan_d)
            self._set_valid(i, fin)

    def valid_traj_point(self, j: int) -> None:
        """Pin every valid score to point j of the last block's trajectory
        (engine.train evaluates each inner iteration so); the trajectory
        comes to the host once a block."""
        traj = self._fused_valid_traj
        if self._fused_valid_traj_host is None:
            self._fused_valid_traj_host = [t.cpu().numpy() for t in traj]
            self.valid_host_copies += len(traj)
        for i, t in enumerate(traj):
            self._set_valid(i, t[j], self._fused_valid_traj_host[i][j])

    def _valid_score_host(self, i: int) -> np.ndarray:
        if self._valid_host[i] is None:
            self._valid_host[i] = self.valid_scores[i].cpu().numpy()
            self.valid_host_copies += 1
        return self._valid_host[i]

    def _train_bins_unpacked(self) -> torch.Tensor:
        """The training bins as [N, F] uint8, unpacked for the call when
        stored 4-bit (cold paths: rollback)."""
        if not self._packed4:
            return self.bins
        return unpack_bins_4bit(self.bins, int(self.num_bins_d.shape[0]))

    def rollback_one_iter(self) -> None:
        """Drop the last iteration (gbdt.cpp:451-467): its tree comes off
        the trees and off the training and valid scores (subtracted: the
        add-then-subtract can leave a last-bit residue, as in the JAX
        package); with k trees an iteration, each class's tree off its
        class's scores."""
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        bins = self._train_bins_unpacked()
        for _ in range(k):
            tree = self.trees.pop()
            cls = self.tree_class.pop()
            self._set_class_score(cls, self._class_score(cls) -
                                  predict_binned_tree(
                                      tree, bins, self.num_bins_d,
                                      self.missing_is_nan_d))
            for i in range(len(self.valid_sets)):
                vals = predict_binned_tree(tree, self.valid_bins[i],
                                           self.num_bins_d,
                                           self.missing_is_nan_d)
                score = self.valid_scores[i]
                if k > 1:
                    score = score.clone()
                    score[:, cls] = self.valid_scores[i][:, cls] - vals
                else:
                    score = score - vals
                self._set_valid(i, score)
        self.iter_ -= 1

    def train_score_host(self) -> np.ndarray:
        """The training score on the host, [N] or [N, k]."""
        score = self.train_score.cpu().numpy()
        return score if score.ndim == 1 else score.T

    def eval_train(self) -> dict:
        return self._eval(self.train_score_host(), self.train_metrics)

    def eval_valid(self, i: int) -> dict:
        return self._eval(self._valid_score_host(i), self.valid_metrics[i])

    def _eval(self, score: np.ndarray, metrics: list) -> dict:
        out: dict = {}
        convert = None if self.objective is None \
            else self.objective.convert_output
        for m in metrics:
            if hasattr(m, "evaluate_multi"):
                out.update(m.evaluate_multi(score))
            else:
                out[m.name] = m.evaluate(score, convert)
        return out

    def current_iteration(self) -> int:
        return self.iter_


def create_boosting(config: Config, train_set: BinnedDataset,
                    objective: Optional[ObjectiveFunction],
                    device: torch.device, train_metrics=None) -> GBDT:
    """The booster of config.boosting (reference Boosting::CreateBoosting,
    boosting.cpp:38-58): GBDT for gbdt and goss, RF, DART."""
    from .dart import DART
    from .rf import RF
    cls = {"rf": RF, "dart": DART}.get(config.boosting, GBDT)
    return cls(config, train_set, objective, device,
               train_metrics=train_metrics)
