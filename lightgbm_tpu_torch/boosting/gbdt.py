"""GBDT training loop: TrainOneIter and the learner-side scores.

Port of the serial path of lightgbm_tpu/boosting/gbdt.py (reference
src/boosting/gbdt.cpp:266-572): objective gradients on the device, one
tree per iteration from learner/grower_mxu.grow_tree_mxu, shrinkage, and
the score update through the node_values kernel. Where the JAX package
excludes its MXU grower (_mxu_exclusions: max_bin > 256, the
intermediate and advanced monotone methods) or use_pallas is false, the
tree comes from the portable grower (learner/grower.py grow_tree: the
scatter kernel, or the segment sums under EFB or use_pallas=false),
leaf-wise under those monotone methods, one iteration a dispatch, and the
score update is leaf_value[row_node]. gpu_use_dp=false stays on the MXU
grower (hist_double_prec). With
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
boost-from-average. train_many_dispatch and finalize_block are
train_many's two halves, which the pipelined executor
(pipeline/executor.py, engine.train's default) interleaves with the next
block. level_pipeline and level_pipeline_lookahead are accepted and
unused (ROADMAP B2): every tree grows through Grower.grow, since the
port's fix-up pass has no free no-op (a pass on a finished tree computes
a whole pass before grower_mxu._select keeps the old state), so the JAX
package's lagged fix-up loop would buy one fewer host read with a whole
pass of device work for each speculative pass. training_state and
restore_training_state carry what a checkpoint bundle holds beyond the
model text (reliability/checkpoint.py).

Retries and the fall-back (the JAX package's gbdt.py:719-762,
1411-1552; reliability/retry.py, reliability/faults.py): a tree's growth
(_grow, either grower) runs through retry_call at site histogram_build,
retry_max_attempts attempts in all with capped exponential backoff, the
row sample drawn once before the first attempt; a growth that fails every
attempt raises. A fused block (train_many_dispatch) runs through
retry_call at site fused_dispatch: each attempt rewinds GOSS's key stream,
and a failed attempt drops the trainer, which the next attempt builds and
captures anew. A block that fails every attempt trains its k iterations
with train_one_iter on the same card and kernels (never the CPU or a
plain version), with a warning, the fallbacks counter and k valid-score
points, as every other path; two such blocks in a row turn the fused path
off for the booster (_fused_disabled), and a fused block that succeeds
resets the count. The fused_dispatch site also reads
LGBM_TPU_INJECT_FUSED_FAULT ("N" or "S:N", _maybe_inject_fused_fault).

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

Exclusive feature bundling (enable_bundle, the JAX package's
gbdt.py:110-153): _setup_train plans over the training bins (efb.py
build_plan, one process: every row's bins) and, where the plan bundles
anything, the device holds the bundled [N, Fb] matrix and the plan's
tables (self._efb); the grower builds histograms in bundle space and
routes in the plan's mode (efb_segmented_scan: bundle ranges and the
segmented scan, else the loc table and the expansion), the score refresh
of rollback and DART reads the bundled matrix through kernel V's bundled
mode (_train_values), and validation matrices stay unbundled. EFB pins the mxu
sweep (the segment sums on the portable grower) and stores no 4-bit
packed bins, as in the JAX package.
Bundled data grows on the MXU grower (and so on the fused trainer) only
under efb_use_mxu=true, as in the JAX package (_mxu_exclusions, rule
"efb config"); by default it grows on the portable grower with the
segment sums, one iteration a dispatch, full precision.

Forced splits (forcedsplits_filename: the JSON spec tree, flattened BFS
into four int32 tensors on the device by _load_forced_splits) ride the
MXU grower, the fused trainer and the portable grower; CEGB
(cegb_penalty_split and the coupled and lazy per-feature penalties,
_setup_cegb) rides both growers, the lazy term only the portable one
(_mxu_exclusions' fourth rule), one iteration a dispatch: the
feature-used flags carry from tree to tree on the host side
(_cegb_state), as in the JAX package. guard_nonfinite (reliability/
guards.py) checks the gradients before growth and the training score and
the new trees' leaves after (train_one_iter: sanitize, skip, roll back
or raise), one iteration a dispatch.

Linear trees (linear_tree, linear_lambda; the JAX package's
gbdt.py:285-300,1076-1113) grow on the MXU grower one iteration a
dispatch, on full-precision bins (no EFB, no 4-bit packing), and keep the
training and valid sets' raw values on the device (raw, valid_raws). After
growth (and leaf renewal) each tree's leaves get ridge models
(learner/linear.py fit_linear_leaves: kernel L1's sums and a batched
solve) on the sample's gradients, which train_one_iter draws itself so the
fit sees the in-bag count; shrinkage scales their constants and
coefficients, the first tree's constants take the init score, and
linear_models keeps one LinearLeaves or None per tree, aligned with trees
wherever a tree is added or dropped. Scores take the leaf models' values
(kernel L2): the training rows by their grown leaf, the valid rows, and
the training rows of rollback and DART, by their leaf ids from kernel V.

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
from ..efb import build_plan, bundle_matrix, make_device_tables
from ..learner.grower import CegbParams, CegbState, TreeArrays, grow_tree
from ..learner.grower_mxu import (Grower, _kernel_cap,
                                  autotune_hist_backend)
from ..learner.histogram_mxu import (fits_v2, node_values, pack_bins_4bit,
                                     unpack_bins_4bit)
from ..learner.linear import (LinearLeaves, fit_linear_leaves,
                              linear_leaf_values)
from ..learner.predict import (class_score_add, predict_binned_tree,
                               stacked_leaf_nodes, stacked_score_traj)
from ..learner.renew import renew_tree_output
from ..learner.split import SplitHyperParams
from ..objectives import ObjectiveFunction, gradients_at
from ..reliability import counters, faults, guards, retry_call
from ..utils.log import LightGBMError, Log

__all__ = ["GBDT", "check_supported", "create_boosting", "resolve_device"]

# train_many reads a block's stall state every this many iterations (the
# JAX package's _stop_poll_every)
_STOP_POLL_EVERY = 8

_FAULT_ENV = "LGBM_TPU_INJECT_FUSED_FAULT"


def _maybe_inject_fused_fault(env: str = _FAULT_ENV) -> None:
    """Fail upcoming fused dispatches on request, so the retry and
    fall-back paths run without a real device fault. Env format: "N"
    (fail the next N dispatches) or "S:N" (let S through, then fail N).

    A shim over the fault registry (reliability/faults.py): the env var
    only seeds the schedule, the countdown lives in the registry and the
    environment is never mutated. The default env maps to the
    `fused_dispatch` site; another env name gets its own site,
    "env:<name>"."""
    site = "fused_dispatch" if env == _FAULT_ENV else f"env:{env}"
    faults.schedule_from_env(site, env)
    faults.inject(site)


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
        ("tree_learner=" + str(cfg.tree_learner), "P14",
         cfg.tree_learner != "serial" or cfg.num_machines > 1),
    ] if hit]


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for parameter values the port cannot
    train yet; it never runs something else in their place. Every
    hist_backend is ported (EFB pins mxu, with the JAX package's
    warning)."""
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
        # iterations a resumed run's base model holds
        # (restore_training_state): iter_ stays absolute, so every draw
        # keyed by the iteration is the uninterrupted run's
        self._iter_offset = 0
        self.trees: List[TreeArrays] = []
        self.tree_class: List[int] = []
        #: each tree's leaf models (LinearLeaves), None for constant leaves
        self.linear_models: List[Optional[LinearLeaves]] = []
        self.valid_raws: List[Optional[torch.Tensor]] = []
        self._fused_run = None
        #: the stats of each fused trainer that ran a block
        #: (FusedTrainer.stats), kept after release_fused
        self.fused_stats: List[dict] = []
        # fused blocks in a row that failed every attempt, and whether two
        # did (the fused path is then off for this booster)
        self._fused_failures = 0
        self._fused_disabled = False
        # the last fused block's handle until finalize_block appends its
        # trees
        self._unfinalized: Optional[dict] = None
        #: the pipelined executor's PipelineStats of the last run through it
        self._pipeline_stats = None
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
        # EFB (reference feature_group.h:25; efb.py): bundle mutually
        # exclusive sparse features so the histogram work scales with the
        # bundle columns, not the features. Only the device bin matrix
        # changes shape; the grower translates through the plan's tables
        bins = ds.bins
        self._efb = None
        if cfg.enable_bundle and not cfg.linear_tree and ds.num_features:
            plan = build_plan(ds.bins, ds.num_bins, ds.default_bins,
                              np.asarray(ds.is_categorical),
                              max_bundle_bins=256)
            if plan is not None and plan.effective:
                # the feature metadata attaches the segmented scan's
                # tables; without them the grower expands each pass
                seg = cfg.efb_segmented_scan
                self._efb = make_device_tables(
                    plan, ds.default_bins,
                    num_bins=ds.num_bins if seg else None,
                    missing_is_nan=(ds.missing_types == 2) if seg else None,
                    is_cat=np.asarray(ds.is_categorical) if seg else None,
                    device=dev)
                bins = bundle_matrix(ds.bins, plan)
        self._setup_cegb(cfg, ds)
        # the growth path, as the JAX package picks it (gbdt.py:209-259):
        # the MXU grower unless something excludes it, else the portable
        # grower (learner/grower.py) with the scatter kernel, or with the
        # segment sums under EFB or use_pallas=false
        self._mono_nonbasic = (cfg.monotone_constraints is not None and
                               cfg.monotone_constraints_method != "basic")
        self._mono_method = (cfg.monotone_constraints_method
                             if self._mono_nonbasic else "basic")
        if cfg.use_pallas:
            excl = self._mxu_exclusions()
            if not excl:
                self._hist_impl = "mxu"
            else:
                self._hist_impl = "pallas" if self._efb is None \
                    else "scatter"
                # the EFB rule alone is the JAX package's chosen default
                # for bundled data: only the other exclusions warn
                hard = [r for r in excl if r != "efb config"]
                if hard:
                    Log.warning("training runs on the portable %s grower "
                                "(MXU path excluded by: %s)",
                                self._hist_impl, ", ".join(hard))
        else:
            self._hist_impl = "scatter"
        if cfg.use_quantized_grad and self._hist_impl != "mxu":
            Log.warning("use_quantized_grad only accelerates the MXU "
                        "growth path (active: %s); training runs "
                        "full-precision", self._hist_impl)
        #: the portable grower's trees and passes (one host read of `done`
        #: a pass), and under monotone constraints the last tree's
        #: node_bounds (grower.grow_tree)
        self.grow_stats = {"trees": 0, "passes": 0}
        # 4-bit packed bin storage (reference dense_bin.hpp:42) where the
        # JAX package packs: every feature fits a nibble and every growth
        # pass fits the fused/v2 kernels (the v1 fallback would unpack the
        # whole matrix per call); not under EFB or linear trees. Packed on
        # the host, so the matrix goes to the device once.
        self._packed4 = False
        if (self._hist_impl == "mxu" and cfg.bin_pack_4bit and
                self.bmax <= 16 and self._efb is None and
                not cfg.linear_tree):
            over = cfg.growth_overshoot if cfg.growth_overshoot >= 1.0 \
                else 0.0
            L_g = int(math.ceil(cfg.num_leaves * over)) if over \
                else cfg.num_leaves
            if fits_v2(L_g + 1, ds.num_features, self.bmax,
                       cfg.use_quantized_grad, double_prec=cfg.gpu_use_dp):
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
        self._forced = self._load_forced_splits(cfg, ds, dev)
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
        # linear trees: the used features' raw values (dataset.cpp:418-420)
        self._linear = bool(cfg.linear_tree)
        self.raw = None
        if self._linear:
            if ds.raw is None:
                raise ValueError(
                    "linear_tree=true requires raw feature values; "
                    "reconstruct the dataset with linear_tree in params")
            self.raw = torch.as_tensor(ds.raw, device=dev).contiguous()
            depth_cap = cfg.max_depth if cfg.max_depth > 0 else 31
            self._lin_dmax = max(1, min(ds.num_features, depth_cap, 31))

    def _mxu_exclusions(self) -> List[str]:
        """Why the MXU grower cannot grow this booster's trees (empty: it
        can), the JAX package's _mxu_exclusions (gbdt.py:566-584): bins
        wider than its uint8 kernels read, the monotone methods that
        rescan every node, the lazy CEGB penalty (its per-row charges),
        and bundled data unless efb_use_mxu is set, every bundle fits 256
        bins and either the segmented scan is in use or the expansion fits
        1 GiB."""
        cfg = self.config
        efb = self._efb
        efb_ok = efb is None or (
            cfg.efb_use_mxu and efb.bundle_bmax <= 256 and
            (efb.scan is not None or self._mxu_expand_bytes() <= 1 << 30))
        return [r for r, hit in [
            ("max_bin > 256", self.bmax > 256),
            ("monotone_constraints_method", self._mono_nonbasic),
            ("cegb_penalty_feature_lazy",
             self._cegb_cfg is not None and self._cegb_cfg.has_lazy),
            ("efb config", not efb_ok)] if hit]

    def _setup_cegb(self, cfg: Config, ds: BinnedDataset) -> None:
        """Cost-effective gradient boosting (reference
        cost_effective_gradient_boosting.hpp:23; the JAX package's
        _setup_cegb, gbdt.py:306-340): _cegb_cfg, and _cegb_state, the
        CegbState the growers advance from tree to tree, per-feature lists
        mapped to used-feature order."""
        self._cegb_cfg = None
        self._cegb_state = None
        lazy = cfg.cegb_penalty_feature_lazy
        coupled = cfg.cegb_penalty_feature_coupled
        has_lazy, has_coupled = bool(lazy), bool(coupled)
        if cfg.cegb_penalty_split <= 0 and not has_lazy and not has_coupled:
            return
        f = ds.num_features
        used = np.asarray(ds.used_features, np.int64)
        dev = self.device

        def per_used(pen):
            pen = np.asarray(pen, np.float32)
            if len(pen) != ds.num_total_features:
                # the reference requires one penalty per feature
                raise ValueError(
                    f"cegb per-feature penalty has {len(pen)} entries but "
                    f"the dataset has {ds.num_total_features} features")
            return torch.as_tensor(pen[used], device=dev)

        zf = torch.zeros(f, dtype=torch.float32, device=dev)
        self._cegb_cfg = CegbParams(
            tradeoff=float(cfg.cegb_tradeoff),
            penalty_split=float(cfg.cegb_penalty_split),
            has_coupled=has_coupled, has_lazy=has_lazy)
        self._cegb_state = CegbState(
            per_used(coupled) if has_coupled else zf,
            per_used(lazy) if has_lazy else zf.clone(),
            torch.zeros(f, dtype=torch.bool, device=dev),
            torch.zeros((ds.num_data, f) if has_lazy else (1, 1),
                        dtype=torch.bool, device=dev))

    @staticmethod
    def _load_forced_splits(cfg: Config, ds: BinnedDataset,
                            device: torch.device):
        """The forced-splits JSON tree (reference ForceSplits,
        serial_tree_learner.cpp:459; read at serial_tree_learner.cpp:53)
        flattened breadth first into (feature, threshold bin, left spec,
        right spec) [K] int32 tensors on `device`, spec i the i-th node of
        the BFS and -1 for none; None without a spec. A node on an unused
        or a categorical feature is kept as feature -1 with no children,
        with the JAX package's warning (gbdt.py:342-405)."""
        fname = cfg.forcedsplits_filename
        if not fname:
            return None
        import json
        with open(fname) as fh:
            root = json.load(fh)
        if not root:
            return None
        orig2used = {int(o): j for j, o in enumerate(ds.used_features)}
        feat, tbin, left, right = [], [], [], []
        nodes = [root]
        i = 0
        while i < len(nodes):
            nd = nodes[i]
            i += 1
            fo = int(nd["feature"])
            fu = orig2used.get(fo)
            if fu is None:
                Log.warning("forced split on unused feature %d ignored", fo)
            elif ds.mappers[fu].is_categorical:
                Log.warning("forced split on categorical feature %d ignored "
                            "(numerical thresholds only)", fo)
                fu = None
            if fu is None:              # a leaf of the spec: its BFS ends
                feat.append(-1)
                tbin.append(0)
                left.append(-1)
                right.append(-1)
                continue
            feat.append(fu)
            tbin.append(ds.mappers[fu]._value_to_bin_scalar(
                float(nd["threshold"])))
            for key, out in (("left", left), ("right", right)):
                child = nd.get(key)
                if child:
                    nodes.append(child)
                    out.append(len(nodes) - 1)
                else:
                    out.append(-1)
        if not feat or all(f < 0 for f in feat):
            return None
        return tuple(torch.tensor(a, dtype=torch.int32, device=device)
                     for a in (feat, tbin, left, right))

    def _mxu_expand_bytes(self) -> int:
        """Bytes of one pass's expanded scan tensor under EFB on the MXU
        grower, [s_max, F, bmax, 3] f32 (the JAX package's
        _mxu_expand_bytes, gbdt.py:586-593)."""
        cfg = self.config
        over = max(cfg.growth_overshoot, 1.0)
        s_max = int(math.ceil(cfg.num_leaves * over)) + 1
        f = int(self._efb.col_of_feat.shape[0])
        return s_max * f * self.bmax * 3 * 4

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
        mxu. EFB growth has no scatter wiring (bundle-space routing stays
        on the mxu sweep): it pins mxu, with a warning for another explicit
        backend. The outcome is kept in self._hist_autotune."""
        if self._hist_backend is not None:
            return self._hist_backend
        cfg = self.config
        hb = cfg.hist_backend
        timings: dict = {}
        autotuned = False
        if self._efb is not None and hb not in ("auto", "mxu"):
            Log.warning("hist_backend=%s has no EFB bundle-space "
                        "wiring; using mxu", hb)
            hb = "mxu"
        elif hb == "auto":
            if (self._efb is not None or self.device.type == "cpu" or
                    not cfg.hist_autotune or not cfg.use_quantized_grad):
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
            partition_impl=cfg.partition_impl, efb=self._efb,
            hist_double_prec=cfg.gpu_use_dp, forced=self._forced,
            cegb_cfg=self._cegb_cfg)

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
        sample). The MXU grower, or the portable one (_grow_portable).

        The growth dispatch of the JAX package's _grow (gbdt.py:719-762):
        each attempt passes the histogram_build fault site before any
        device work, and retry_call retries a failed attempt. The sample
        is drawn once, before the first attempt, so a retry draws no new
        GOSS key. With CEGB the growers advance _cegb_state (the
        feature-used flags persist across the whole model: the
        reference's is_feature_used_in_split_ and is_feature_used_); both
        rebind its flags after the growth's last program and never write
        them in place (grower.py clones row_feat_used first), so keeping
        the references before the first attempt and putting them back
        before each retry restores them, and grow_stats with them."""
        if cnt is None:
            grad, hess, cnt = self._sample(grad, hess)
        cfg = self.config
        cegb = self._cegb_state
        flags = None if cegb is None else (cegb.feat_used,
                                           cegb.row_feat_used)
        stats = dict(self.grow_stats)

        def restore():
            if cegb is not None:
                cegb.feat_used, cegb.row_feat_used = flags
            self.grow_stats.clear()
            self.grow_stats.update(stats)

        def attempt():
            faults.inject("histogram_build")
            if self._hist_impl != "mxu":
                return self._grow_portable(grad, hess, cnt)
            return self._grower().grow(grad, hess, cnt,
                                       self._feature_mask_at(self.iter_),
                                       self._tree_key(), cegb)

        return retry_call(attempt, attempts=cfg.retry_max_attempts,
                          backoff_ms=cfg.retry_backoff_ms,
                          backoff_max_ms=cfg.retry_backoff_max_ms,
                          site="histogram_build", on_retry=restore)

    def _grow_portable(self, grad, hess, cnt):
        """One tree on the portable grower (the JAX package's call,
        gbdt.py:800-812): leaf-wise under the intermediate and advanced
        monotone methods, batched otherwise; its passes add into
        grow_stats."""
        cfg = self.config
        self.grow_stats["trees"] += 1
        return grow_tree(
            self.bins, grad, hess, cnt, self._feature_mask_at(self.iter_),
            self.num_bins_d, self.missing_is_nan_d, self.is_cat_d,
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth, hp=self.hp,
            leafwise=self._mono_nonbasic, bmax=self.bmax,
            monotone=self._monotone,
            interaction_groups=self._interaction_groups,
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            rng_key=self._tree_key(), hist_impl=self._hist_impl,
            partition_impl=cfg.partition_impl,
            monotone_method=self._mono_method, efb=self._efb,
            forced=self._forced, cegb_cfg=self._cegb_cfg,
            cegb_state=self._cegb_state, stats=self.grow_stats)

    def _leaf_values(self, tree: TreeArrays,
                     row_node: torch.Tensor) -> torch.Tensor:
        """[N] each row's leaf value, the learner-side score update
        (score_updater.hpp:21-110): the node_values kernel on the MXU
        path, the plain gather leaf_value[row_node] on the portable one,
        as in the JAX package (gbdt.py:1674-1678); a linear tree's rows
        take its leaf models' values instead (linear_leaf_values)."""
        if self._hist_impl == "mxu":
            return node_values(row_node, tree.leaf_value)
        return tree.leaf_value[row_node.to(torch.int64)]

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
        the iteration made a split). With guard_nonfinite, the rails of
        the JAX package's train_one_iter (gbdt.py:1001-1010, 1120-1145):
        non-finite gradients or hessians before growth, and a non-finite
        training score or leaf of the new trees after it, trip the
        policy."""
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
        guard = cfg.guard_nonfinite
        prev_scores = None
        if guard != "off":
            # pre-growth rail: non-finite gradients (an exploding custom
            # objective, corrupted scores) poison every later iteration
            if not guards.all_finite(gradients, hessians):
                gradients, hessians = self._guard_gradients(
                    guard, gradients, hessians)
                if gradients is None:      # skip_iteration consumed it
                    return False
            # the scores are never written in place, so keeping the
            # references restores them exactly (subtracting a NaN tree
            # cannot un-NaN a score)
            prev_scores = (self.train_score, list(self.valid_scores))
        renew = self.objective is not None and \
            self.objective.need_renew_tree_output
        cnt = None
        if k > 1 or renew or self._linear:
            # one row sample an iteration, shared by its classes (the leaf
            # models' fit needs its in-bag count)
            gradients, hessians, cnt = self._sample(gradients, hessians)
        first = self.iter_ == 0
        finished = True
        for cls in range(k):
            g = gradients if k == 1 else gradients[cls]
            h = hessians if k == 1 else hessians[cls]
            tree, row_node = self._grow(g, h) if cnt is None \
                else self._grow(g, h, cnt)
            lin = None
            if int(tree.num_leaves) > 1:
                finished = False
                score = self._class_score(cls)
                if renew:
                    obj = self.objective
                    rw = cnt if obj.weight is None else cnt * obj.weight
                    tree = renew_tree_output(tree, row_node, score,
                                             obj.label, rw,
                                             obj.renew_percentile)
                if self._linear:
                    # the leaf models, on the full-precision gradients of
                    # the sample (quantized growth included)
                    lin = fit_linear_leaves(
                        tree, row_node, self.raw, g, h, cnt, self.is_cat_d,
                        self.config.linear_lambda, dmax=self._lin_dmax)
                # shrinkage (tree.cpp Shrinkage), then the learner-side
                # score update
                tree = tree._replace(
                    leaf_value=tree.leaf_value * self.shrinkage_rate)
                if lin is not None:
                    lin = lin._replace(const=lin.const * self.shrinkage_rate,
                                       coeff=lin.coeff * self.shrinkage_rate)
                self._set_class_score(cls, score + (
                    self._leaf_values(tree, row_node) if lin is None else
                    linear_leaf_values(tree, lin, row_node, self.raw)))
                self._update_valid(tree, cls, lin)
                if abs(init_scores[cls]) > 1e-35:
                    # AddBias (gbdt.cpp:416-417): fold the init score into
                    # the first tree's leaves (and the leaf models' const)
                    leaf = tree.split_feature < 0
                    tree = tree._replace(leaf_value=torch.where(
                        leaf, tree.leaf_value + init_scores[cls],
                        tree.leaf_value))
                    if lin is not None:
                        lin = lin._replace(const=torch.where(
                            leaf, lin.const + init_scores[cls], lin.const))
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
            self.linear_models.append(lin)
        self.iter_ += 1
        if guard != "off" and not guards.all_finite(
                self.train_score,
                *[self._guarded_tree_values(t) for t in self.trees[-k:]]):
            guards.trip("split gains/scores", guard, self.iter_ - 1)
            if guard in ("skip_iteration", "rollback"):
                # discard the offending iteration by exact restoration
                for _ in range(k):
                    self.trees.pop()
                    self.tree_class.pop()
                    self.linear_models.pop()
                self.train_score = prev_scores[0]
                for i, score in enumerate(prev_scores[1]):
                    self._set_valid(i, score)
                self.iter_ -= 1
                if guard == "skip_iteration":
                    self._append_zero_trees()
        return finished

    def _append_zero_trees(self) -> None:
        """An iteration of constant zero trees: it keeps the tree count
        aligned with the boosting rounds and moves no score."""
        for cls in range(self.num_tree_per_iteration):
            self.trees.append(self._constant_tree(0.0))
            self.tree_class.append(cls)
            self.linear_models.append(None)
        self.iter_ += 1

    @staticmethod
    def _guarded_tree_values(tree: TreeArrays) -> torch.Tensor:
        """The leaf values of `tree`'s nodes in use: slots past num_nodes
        and internal nodes are padding, which the guard does not read."""
        idx = torch.arange(tree.leaf_value.shape[0],
                           device=tree.leaf_value.device)
        valid = (idx < tree.num_nodes) & tree.is_leaf
        return torch.where(valid, tree.leaf_value, 0.0)

    def _guard_gradients(self, guard: str, gradients, hessians):
        """The pre-growth rail (the JAX package's _guard_gradients,
        gbdt.py:1159-1190): usable (gradients, hessians), or (None, None)
        when skip_iteration consumed the iteration. rollback drops the
        iteration that produced the scores (with an objective to recompute
        from) and recomputes; what is still non-finite is set to 0, as
        under warn."""
        guards.trip("gradients/hessians", guard, self.iter_)
        if guard == "rollback" and self.iter_ > self._iter_offset and \
                self.objective is not None:
            self.rollback_one_iter()
            gradients, hessians = self._gradients(self.train_score)
            if guards.all_finite(gradients, hessians):
                return gradients, hessians
            guards.trip("gradients/hessians after rollback", guard,
                        self.iter_)
        if guard == "skip_iteration":
            self._append_zero_trees()
            return None, None
        return (torch.nan_to_num(gradients, nan=0.0, posinf=0.0,
                                 neginf=0.0),
                torch.nan_to_num(hessians, nan=0.0, posinf=0.0, neginf=0.0))

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
        calls: the JAX package's rule (gbdt or GOSS on the serial MXU
        grower, bagging and k trees an iteration included; not RF or DART,
        not the portable grower; no guard rails, no linear trees, no leaf
        renewal, no CEGB, whose feature-used flags carry across trees, no
        custom objective). Forced splits ride along: the spec is the
        same for every tree. A booster whose fused blocks failed twice in
        a row (_fused_disabled, train_many_dispatch) is refused too."""
        cfg = self.config
        return (type(self) is GBDT and cfg.boosting in ("gbdt", "goss")
                and not self._fused_disabled
                and self._hist_impl == "mxu"
                and cfg.guard_nonfinite == "off" and not cfg.linear_tree
                and self.objective is not None
                and not self.objective.need_renew_tree_output
                and not self._custom_objective
                and self._cegb_cfg is None)

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
        over each valid set by one stacked_score_traj launch.

        The fused block runs through retry_call at site fused_dispatch
        (the JAX package's gbdt.py:1466-1543). Nothing of the booster
        moves until the trainer returns: each attempt rewinds GOSS's key
        stream and draws the block's keys anew; iter_, the scores, the
        stall poll and fused_stats change only after a success. The
        trainer copies the score in and returns a new tensor
        (boosting/fused.py), so a failed attempt never touches
        train_score, and nothing is donated: the JAX package's check for
        a donated, deleted score buffer has no counterpart. A failed
        attempt drops the trainer (its graphs and held buffers are freed
        outside any capture); the next attempt builds and captures a new
        one. When every attempt fails, the block's k iterations run
        through train_one_iter on the same device and kernels, with a
        warning and the fallbacks counter; a second such block in a row
        sets _fused_disabled."""
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
        cfg = self.config
        saved_key = self._rng_key

        def attempt():
            # every attempt draws the same keys: a fault that a retry
            # absorbs must not change the model
            self._rng_key = saved_key
            try:
                _maybe_inject_fused_fault()
                if self._fused_run is None:
                    self._fused_run = self._build_fused()
                # GOSS: the keys k train_one_iter calls would draw, drawn
                # ahead
                keys = torch.stack([self._next_key() for _ in range(k)]) \
                    if self._fused_run.sample_keys else None
                return self._fused_run(self.train_score, self.iter_, k,
                                       keys)
            except Exception:
                # the trainer's graphs may be dead: the next attempt
                # builds and captures a new one
                self._fused_run = None
                raise

        failed = False
        try:
            score, stacked = retry_call(
                attempt, attempts=cfg.retry_max_attempts,
                backoff_ms=cfg.retry_backoff_ms,
                backoff_max_ms=cfg.retry_backoff_max_ms,
                site="fused_dispatch")
        except Exception as exc:
            # the per-iteration path draws the keys the block would have
            self._rng_key = saved_key
            self._fused_failures += 1
            counters.inc("fallbacks")
            if self._fused_failures >= 2:
                self._fused_disabled = True
            Log.warning(
                "fused multi-tree dispatch failed (%s: %s); falling back "
                "to per-iteration training for this batch%s"
                % (type(exc).__name__, exc,
                   " and disabling the fused path"
                   if self._fused_disabled else ""))
            failed = True
        # the fall-back runs outside the except clause: the exception's
        # frames hold the failed trainer, freed when the clause ends
        if failed:
            # the pipelined executor finalizes the previous fused block
            # after this dispatch returns: its trees go on first
            if self._unfinalized is not None:
                self.finalize_block(self._unfinalized)
            for _ in range(k):
                stop = self.train_one_iter() or stop
                snap()
            seal()
            return {"mode": "done", "stop": stop}
        self._fused_failures = 0
        st = self._fused_run.stats
        if not self.fused_stats or self.fused_stats[-1] is not st:
            self.fused_stats.append(st)
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
        self._unfinalized = {"mode": "fused", "stacked": stacked, "k": k,
                             "kcls": kcls, "stop": stop_hint}
        return self._unfinalized

    def finalize_block(self, handle: dict) -> bool:
        """Second half of train_many: the block's trees, views of its
        stack, onto self.trees (no device work); a handle's trees go on
        once, however often it is finalized."""
        if handle["mode"] == "fused" and not handle.get("finalized"):
            handle["finalized"] = True
            if self._unfinalized is handle:
                self._unfinalized = None
            stacked, kcls = handle["stacked"], handle["kcls"]
            for i in range(handle["k"]):
                if kcls == 1:
                    self.trees.append(TreeArrays(*[t[i] for t in stacked]))
                    self.tree_class.append(0)
                    self.linear_models.append(None)
                    continue
                for c in range(kcls):
                    self.trees.append(TreeArrays(*[t[i, c]
                                                   for t in stacked]))
                    self.tree_class.append(c)
                    self.linear_models.append(None)
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

    def _pending_value(self) -> int:
        """The lagged stall poll's leaf count, once its copy has landed."""
        host, event = self._pending_nleaves
        if event is not None:
            event.synchronize()
        return int(host)

    def _read_pending(self) -> int:
        self.stall_polls += 1
        return self._pending_value()

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
        if self._linear and ds.raw is None:
            raise ValueError(
                "linear_tree model needs raw values on validation sets; "
                "construct them with linear_tree in params")
        self.valid_sets.append(ds)
        self.valid_raws.append(
            torch.as_tensor(ds.raw, device=self.device).contiguous()
            if self._linear else None)
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
        for ti, (tree, cls) in enumerate(zip(self.trees, self.tree_class)):
            lin = self._lin(ti)
            if lin is not None:
                self._add_valid_values(i, cls,
                                       self._valid_values(tree, i, lin))
            elif k > 1:
                self._set_valid(i, class_score_add(
                    tree, self.valid_scores[i], cls, self.valid_bins[i],
                    self.num_bins_d, self.missing_is_nan_d))
            else:
                self._set_valid(i, self.valid_scores[i] + predict_binned_tree(
                    tree, self.valid_bins[i], self.num_bins_d,
                    self.missing_is_nan_d))

    def _set_valid(self, i: int, score: torch.Tensor,
                   host: Optional[np.ndarray] = None) -> None:
        self.valid_scores[i] = score
        self._valid_host[i] = host

    def _lin(self, idx: int) -> Optional[LinearLeaves]:
        """The leaf models of tree idx (None: constant leaves)."""
        return self.linear_models[idx] \
            if idx < len(self.linear_models) else None

    def _valid_values(self, tree: TreeArrays, i: int,
                      lin: Optional[LinearLeaves] = None) -> torch.Tensor:
        """[N_i] the tree's values over valid set i: kernel V's leaf values
        or, for a linear tree, V's leaf ids and the leaf models' values
        (kernel L2) on the set's raw values (the JAX package's
        _tree_values)."""
        if lin is None:
            return predict_binned_tree(tree, self.valid_bins[i],
                                       self.num_bins_d,
                                       self.missing_is_nan_d)
        _, leaf = stacked_leaf_nodes(_stack1(tree), self.valid_bins[i],
                                     self.num_bins_d, self.missing_is_nan_d)
        return linear_leaf_values(tree, lin, leaf[0], self.valid_raws[i])

    def _add_valid_values(self, i: int, cls: int,
                          vals: torch.Tensor) -> None:
        """Valid score i plus vals (into column cls with k trees an
        iteration), one f32 add."""
        score = self.valid_scores[i]
        if self.num_tree_per_iteration > 1:
            score = score.clone()
            score[:, cls] = self.valid_scores[i][:, cls] + vals
        else:
            score = score + vals
        self._set_valid(i, score)

    def _update_valid(self, tree: TreeArrays, cls: int = 0,
                      lin: Optional[LinearLeaves] = None) -> None:
        """Each valid score plus the tree's leaf values (into column cls
        with k trees an iteration): one f32 add, the trajectory step the
        fused block's stacked_score_traj takes; a linear tree's values
        come from _valid_values."""
        for i in range(len(self.valid_sets)):
            if lin is not None:
                self._add_valid_values(i, cls,
                                       self._valid_values(tree, i, lin))
                continue
            if self.num_tree_per_iteration > 1:
                self._set_valid(i, class_score_add(
                    tree, self.valid_scores[i], cls, self.valid_bins[i],
                    self.num_bins_d, self.missing_is_nan_d))
                continue
            fin, _ = stacked_score_traj(
                _stack1(tree),
                self.valid_scores[i], self.valid_bins[i], self.num_bins_d,
                self.missing_is_nan_d)
            self._set_valid(i, fin)

    def valid_traj_point(self, j: int, host: bool = True) -> None:
        """Pin every valid score to point j of the last block's trajectory
        (engine.train evaluates each inner iteration so); the trajectory
        comes to the host once a block. host=False pins the device scores
        without that copy (the pipelined executor's device evaluation)."""
        traj = self._fused_valid_traj
        if host and self._fused_valid_traj_host is None:
            self._fused_valid_traj_host = [t.cpu().numpy() for t in traj]
            self.valid_host_copies += len(traj)
        hosts = self._fused_valid_traj_host
        for i, t in enumerate(traj):
            self._set_valid(i, t[j], None if hosts is None else hosts[i][j])

    def _valid_score_host(self, i: int) -> np.ndarray:
        if self._valid_host[i] is None:
            self._valid_host[i] = self.valid_scores[i].cpu().numpy()
            self.valid_host_copies += 1
        return self._valid_host[i]

    def _train_bins_unpacked(self) -> torch.Tensor:
        """The training bins as [N, F] uint8, unpacked for the call when
        stored 4-bit (cold paths: rollback); under EFB the bundled [N, Fb]
        matrix, which _train_values reads through the plan."""
        if not self._packed4:
            return self.bins
        return unpack_bins_4bit(self.bins, int(self.num_bins_d.shape[0]))

    def _train_values(self, tree: TreeArrays,
                      bins: Optional[torch.Tensor] = None,
                      lin: Optional[LinearLeaves] = None) -> torch.Tensor:
        """[N] leaf values of `tree` over the training rows (bins: the
        _train_bins_unpacked matrix, fetched when None), through kernel V's
        bundled mode under EFB (the JAX package's _tree_values(efb=)); a
        linear tree's through V's leaf ids and the leaf models (kernel
        L2; never bundled: EFB is off under linear trees)."""
        if bins is None:
            bins = self._train_bins_unpacked()
        if lin is not None:
            _, leaf = stacked_leaf_nodes(_stack1(tree), bins,
                                         self.num_bins_d,
                                         self.missing_is_nan_d)
            return linear_leaf_values(tree, lin, leaf[0], self.raw)
        return predict_binned_tree(tree, bins, self.num_bins_d,
                                   self.missing_is_nan_d, efb=self._efb)

    def rollback_one_iter(self) -> None:
        """Drop the last iteration (gbdt.cpp:451-467): its tree comes off
        the trees and off the training and valid scores (subtracted: the
        add-then-subtract can leave a last-bit residue, as in the JAX
        package); with k trees an iteration, each class's tree off its
        class's scores."""
        if self.iter_ <= self._iter_offset:
            return
        k = self.num_tree_per_iteration
        bins = self._train_bins_unpacked()
        for _ in range(k):
            tree = self.trees.pop()
            cls = self.tree_class.pop()
            lin = self.linear_models.pop()
            self._set_class_score(cls, self._class_score(cls) -
                                  self._train_values(tree, bins, lin))
            for i in range(len(self.valid_sets)):
                # a + (-b) is a - b, bit for bit
                self._add_valid_values(i, cls,
                                       -self._valid_values(tree, i, lin))
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
        return self.iter_ - self._iter_offset

    # ------------------------------------------------------------------
    # checkpoint and resume (reliability/checkpoint.py bundles)
    def training_state(self):
        """(json state, arrays) beyond what the model text carries: the
        exact f32 training and valid scores, the key stream's position,
        the boost-from-average flags and the lagged stall poll (the JAX
        package's training_state). With these restored, iterations k..N
        reproduce an uninterrupted run bit for bit: every draw keyed by
        the iteration takes the absolute iter_, which resume keeps. The
        bagging mask is a function of the iteration (ROADMAP C10), so no
        mask is saved."""
        state = {
            "boosting": self.config.boosting,
            "num_class": self.num_class,
            "shrinkage_rate": float(self.shrinkage_rate),
            "boosted_from_average": [bool(b) for b in
                                     self._boosted_from_average],
            "has_init_score": bool(self._has_init_score),
            "num_valid": len(self.valid_scores),
        }
        if self._pending_nleaves is not None:
            # one host read of the lagged poll (saving is IO-bound anyway);
            # not a stall poll, so stall_polls does not count it
            state["pending_nleaves"] = self._pending_value()
        arrays = {
            "train_score": self.train_score.cpu().numpy(),
            "rng_key": self._rng_key.cpu().numpy(),
        }
        for i, score in enumerate(self.valid_scores):
            arrays[f"valid_score_{i}"] = score.cpu().numpy()
        return state, arrays

    def restore_training_state(self, iteration: int, state: dict,
                               arrays: dict) -> None:
        """Continue a checkpointed run: `iteration` boosting rounds live in
        the attached base model; this booster trains the rest from the
        exact state the killed run held (the JAX package's
        restore_training_state, with its refusals)."""
        cfg = self.config
        if int(state.get("num_class", self.num_class)) != self.num_class:
            raise LightGBMError(
                "checkpoint num_class=%s does not match num_class=%d" %
                (state.get("num_class"), self.num_class))
        if state.get("boosting", cfg.boosting) != cfg.boosting:
            raise LightGBMError(
                "checkpoint boosting=%r does not match boosting=%r" %
                (state.get("boosting"), cfg.boosting))
        if cfg.boosting not in ("gbdt", "goss"):
            Log.warning(
                "resume is exact for gbdt/goss boosting; %r resumes "
                "best-effort (sampling state beyond the RNG key is "
                "rebuilt)" % cfg.boosting)
        if self._cegb_cfg is not None:
            Log.warning(
                "cegb feature-used state is not checkpointed; resumed "
                "CEGB penalties restart from a clean slate")
        score = np.asarray(arrays["train_score"])
        if tuple(score.shape) != tuple(self.train_score.shape):
            raise LightGBMError(
                "checkpoint train_score shape %s does not match the "
                "training set (%s) — resume needs the same dataset" %
                (score.shape, tuple(self.train_score.shape)))
        # valid scores are restored by position: a valid set the bundle
        # lacks would start without the bundle's trees in its scores
        n_valid = int(state.get("num_valid", len(self.valid_scores)))
        if n_valid != len(self.valid_scores):
            raise LightGBMError(
                "checkpoint holds %d valid set(s) but the resumed run has "
                "%d — resume needs the same valid sets in the same order" %
                (n_valid, len(self.valid_scores)))
        valid = [np.asarray(arrays[f"valid_score_{i}"])
                 for i in range(n_valid)]
        for i, vs in enumerate(valid):
            if tuple(vs.shape) != tuple(self.valid_scores[i].shape):
                raise LightGBMError(
                    "checkpoint valid_score_%d shape %s does not match "
                    "valid set %d (%s) — resume needs the same valid sets "
                    "in the same order" % (i, vs.shape, i,
                                           tuple(self.valid_scores[i].shape)))
        dev = self.device
        self.iter_ = int(iteration)
        self._iter_offset = int(iteration)
        self.train_score = torch.as_tensor(score, device=dev)
        self._rng_key = torch.as_tensor(np.asarray(arrays["rng_key"]),
                                        device=dev)
        self.shrinkage_rate = float(
            state.get("shrinkage_rate", self.shrinkage_rate))
        bfa = state.get("boosted_from_average")
        if bfa is not None:
            self._boosted_from_average = [bool(b) for b in bfa]
        if state.get("pending_nleaves") is not None:
            self._pending_nleaves = (
                torch.tensor(int(state["pending_nleaves"]),
                             dtype=torch.int32), None)
        for i, vs in enumerate(valid):
            self._set_valid(i, torch.as_tensor(vs, device=dev))


def _stack1(tree: TreeArrays) -> TreeArrays:
    """One tree as a stack of one ([1, ...] fields)."""
    return TreeArrays(*[t.unsqueeze(0) for t in tree])


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
