"""Vectorized best-split search over histograms (PyTorch).

Port of lightgbm_tpu/learner/split.py: ONE batched computation over
[slots, features, bins] replaces the reference's per-feature sequential
gain scans (FeatureHistogram::FindBestThresholdSequentially,
feature_histogram.hpp:85-270): prefix sums along the bin axis, the
closed-form gain at every threshold, NA-left/NA-right as two masked
variants, and a flat first-index argmax. Categorical splits
(feature_histogram.hpp:278-485) use the one-hot scan for low-cardinality
features and the sorted-by-ratio two-direction scan otherwise, emitting
the left set as a bin bitset (int64 words holding 32 bits each).

All math follows feature_histogram.hpp:737-860 and runs in f32 tensors:
  ThresholdL1(s, l1) = sign(s) * max(|s| - l1, 0)
  output  = -ThresholdL1(g, l1) / (h + l2)   (clipped by max_delta_step,
                                              smoothed toward parent)
  gain(output) = -(2 * ThresholdL1(g, l1) * output + (h + l2) * output^2)

Basic monotone constraints clip both children's outputs to the node's
[cons_min, cons_max], kill order-violating splits and scale constrained
gains by the depth penalty; extra_trees evaluates one random threshold
per (slot, feature). The prefix sums along bins (numerical, and the
categorical scans' over bins sorted by ratio) are summed in float64 and
rounded to f32 once, so their value does not depend on the order of the
additions, which differs between the card and the CPU: the fused scan
kernel (split_kernel.py) sums the same way and picks the same splits. CEGB penalties are not ported;
boosting/gbdt.py refuses those params.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["SplitHyperParams", "BestSplits", "find_best_splits",
           "leaf_output", "leaf_gain", "numerical_gains", "numerical_inputs"]


@dataclasses.dataclass(frozen=True)
class SplitHyperParams:
    """Static split-search hyperparameters (subset of Config)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    has_monotone: bool = False     # enables the constrained-output gain path
    monotone_penalty: float = 0.0
    extra_trees: bool = False      # one random threshold per (slot, feature)
    has_categorical: bool = False  # enables the categorical scan paths


class BestSplits(NamedTuple):
    """Per-slot best split (reference SplitInfo, split_info.hpp:22)."""
    gain: torch.Tensor           # [S] split gain (already minus gain_shift)
    feature: torch.Tensor        # [S] used-feature index, -1 if none
    threshold_bin: torch.Tensor  # [S] bin t: numerical left iff bin <= t
    default_left: torch.Tensor   # [S] bool, NaN direction
    left_grad: torch.Tensor      # [S]
    left_hess: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor    # [S]
    right_output: torch.Tensor   # [S]
    cat_bitset: torch.Tensor     # [S, W] int64 words of 32 bits


def _threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(g, h, l1, l2, max_delta_step=0.0, path_smooth=0.0,
                count=None, parent_output=None):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:743-764)."""
    ret = -_threshold_l1(g, l1) / (h + l2)
    if max_delta_step > 0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    if path_smooth > 0 and count is not None and parent_output is not None:
        n_over = count / path_smooth
        ret = ret * n_over / (n_over + 1.0) + parent_output / (n_over + 1.0)
    return ret


def _gain_given_output(g, h, l1, l2, output):
    """GetLeafGainGivenOutput (feature_histogram.hpp:851-860)."""
    sg = _threshold_l1(g, l1)
    return -(2.0 * sg * output + (h + l2) * output * output)


def leaf_gain(g, h, l1, l2, max_delta_step=0.0, path_smooth=0.0,
              count=None, parent_output=None):
    """GetLeafGain (feature_histogram.hpp:826-842)."""
    if max_delta_step <= 0 and path_smooth <= 0:
        sg = _threshold_l1(g, l1)
        return (sg * sg) / (h + l2)
    out = leaf_output(g, h, l1, l2, max_delta_step, path_smooth, count,
                      parent_output)
    return _gain_given_output(g, h, l1, l2, out)


def _split_gain(lg, lh, lc, rg, rh, rc, l1, l2, hp: SplitHyperParams,
                parent_output):
    """GetSplitGains without monotone (feature_histogram.hpp:785-806)."""
    return (leaf_gain(lg, lh, l1, l2, hp.max_delta_step, hp.path_smooth,
                      lc, parent_output) +
            leaf_gain(rg, rh, l1, l2, hp.max_delta_step, hp.path_smooth,
                      rc, parent_output))


def _monotone_penalty_factor(depth: torch.Tensor, p: float) -> torch.Tensor:
    """ComputeMonotoneSplitGainPenalty (monotone_constraints.hpp:355-364)."""
    eps = 1e-10
    d = depth.to(torch.float32)
    small = 1.0 - p / torch.exp2(d) + eps
    large = 1.0 - torch.exp2(p - 1.0 - d) + eps
    out = small if p <= 1.0 else large
    return torch.where(p >= d + 1.0, torch.full_like(d, eps), out)


def _neg_inf(ref: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("-inf"), dtype=torch.float32,
                      device=ref.device)


def numerical_inputs(hist: torch.Tensor, num_bins: torch.Tensor,
                     missing_is_nan: torch.Tensor):
    """(prefix [S, F, B, 3], nan_sums [S, F, 1, 3], t_limit [F] i32) of
    [S, F, B, 3] histograms: the inclusive prefix sums along bins, summed
    in float64 and rounded to f32 once (so the order of the additions, a
    running sum here and a parallel scan on the card, does not reach the
    result); each feature's NaN-bin sums (its last bin, zeros without
    one); and the last valid threshold bin, num_bins - 2, one less with a
    NaN bin."""
    s, f = hist.shape[:2]
    prefix = torch.cumsum(hist.to(torch.float64), dim=2).to(torch.float32)
    nan_idx = torch.clamp(num_bins.to(torch.int64) - 1, min=0)
    nan_sums = torch.gather(
        hist, 2, nan_idx[None, :, None, None].expand(s, f, 1, 3))
    nan_sums = torch.where(missing_is_nan[None, :, None, None], nan_sums,
                           torch.zeros((), device=hist.device))
    t_limit = num_bins.to(torch.int32) - 2 - missing_is_nan.to(torch.int32)
    return prefix, nan_sums, t_limit


def numerical_gains(prefix, nan_sums, parent_grad, parent_hess,
                    parent_count, parent_output, missing_is_nan, valid_t,
                    hp: SplitHyperParams, monotone=None, cons_min=None,
                    cons_max=None, penalty=None):
    """Gains [S, F, B] of every numerical threshold with the NaN bin kept
    right and with it sent left (-inf where invalid or where the feature
    has no NaN bin), before the min_gain_to_split gate. prefix: [S, F, B,
    3]; nan_sums: [S, F, 1, 3]; valid_t: [S, F, B] bool. With
    hp.has_monotone: the GetSplitGains USE_MC branch
    (feature_histogram.hpp:806-824) — child outputs clipped to the node's
    [cons_min, cons_max] ([S]), order-violating splits killed, and the
    gains of constrained features ([F] monotone) times `penalty` ([S],
    _monotone_penalty_factor) when hp.monotone_penalty > 0."""
    l1, l2 = hp.lambda_l1, hp.lambda_l2
    ninf = _neg_inf(prefix)
    tot = torch.stack([parent_grad, parent_hess, parent_count], -1)
    tot = tot[:, None, None, :]                                    # [S,1,1,3]
    po = parent_output[:, None, None]

    def eval_option(left):                                         # [S,F,B,3]
        right = tot - left
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]
        ok = ((lc >= hp.min_data_in_leaf) & (rc >= hp.min_data_in_leaf) &
              (lh >= hp.min_sum_hessian_in_leaf) &
              (rh >= hp.min_sum_hessian_in_leaf))
        if hp.has_monotone:
            lout = leaf_output(lg, lh, l1, l2, hp.max_delta_step,
                               hp.path_smooth, lc, po)
            rout = leaf_output(rg, rh, l1, l2, hp.max_delta_step,
                               hp.path_smooth, rc, po)
            cmin = cons_min[:, None, None]
            cmax = cons_max[:, None, None]
            lout = torch.clamp(lout, cmin, cmax)
            rout = torch.clamp(rout, cmin, cmax)
            mc = monotone[None, :, None]
            violate = ((mc > 0) & (lout > rout)) | ((mc < 0) & (lout < rout))
            g = _gain_given_output(lg, lh, l1, l2, lout) + \
                _gain_given_output(rg, rh, l1, l2, rout)
            if hp.monotone_penalty > 0:
                g = torch.where(mc != 0, g * penalty[:, None, None], g)
            g = torch.where(violate, ninf, g)
        else:
            g = _split_gain(lg, lh, lc, rg, rh, rc, l1, l2, hp, po)
        return torch.where(ok & valid_t, g, ninf)

    gain_na_right = eval_option(prefix)                       # NaN stays right
    gain_na_left = torch.where(
        missing_is_nan[None, :, None],
        eval_option(prefix + nan_sums), ninf)                 # NaN joins left
    return gain_na_right, gain_na_left


def find_best_splits(hist: torch.Tensor, parent_grad: torch.Tensor,
                     parent_hess: torch.Tensor, parent_count: torch.Tensor,
                     parent_output: torch.Tensor, num_bins: torch.Tensor,
                     missing_is_nan: torch.Tensor, is_cat: torch.Tensor,
                     feature_mask: torch.Tensor,
                     hp: SplitHyperParams,
                     monotone: Optional[torch.Tensor] = None,
                     cons_min: Optional[torch.Tensor] = None,
                     cons_max: Optional[torch.Tensor] = None,
                     depth: Optional[torch.Tensor] = None,
                     rand_bins: Optional[torch.Tensor] = None,
                     gain_penalty: Optional[torch.Tensor] = None
                     ) -> BestSplits:
    """Find the best split per slot.

    Args:
      hist: [S, F, B, 3] f32 (grad, hess, count) histograms.
      parent_*: [S] node aggregates; parent_output: [S] node output value.
      num_bins: [F] per-feature bin counts (incl. NaN bin when present).
      missing_is_nan: [F] bool, feature has a trailing NaN bin.
      is_cat: [F] bool.
      feature_mask: [F] or [S, F] — 0 disables a feature.
      monotone: [F] int constraint per feature, with cons_min/cons_max [S]
        output bounds and depth [S] node depths (hp.has_monotone only).
      rand_bins: [S, F] int random draws; with hp.extra_trees, threshold
        rand_bins % (t_limit + 1) is the only one evaluated per (slot,
        feature).
      gain_penalty: [S, F] f32 subtracted from every threshold's gain of
        (slot, feature) after the min_gain_to_split gate (the CEGB
        penalties, cost_effective_gradient_boosting.hpp DeltaGain).
    """
    s, f, b, _ = hist.shape
    dev = hist.device
    l1, l2 = hp.lambda_l1, hp.lambda_l2
    ninf = _neg_inf(hist)
    bins_r = torch.arange(b, dtype=torch.int32, device=dev)
    fmask = feature_mask.to(torch.float32).reshape(
        (1, f) if feature_mask.dim() == 1 else (s, f)).expand(s, f)

    tot = torch.stack([parent_grad, parent_hess, parent_count], -1)
    tot = tot[:, None, None, :]                                    # [S,1,1,3]

    # gain_shift: unsmoothed closed-form gain of the unsplit node
    # (feature_histogram.hpp:295-301 passes USE_SMOOTHING=false here)
    gain_shift = leaf_gain(parent_grad, parent_hess, l1, l2,
                           hp.max_delta_step)                      # [S]
    min_gain_shift = gain_shift + hp.min_gain_to_split

    # ---------- numerical features ----------
    prefix, nan_sums, t_limit = numerical_inputs(hist, num_bins,
                                                 missing_is_nan)
    valid_t = bins_r[None, None, :] <= t_limit[None, :, None]      # [1,F,B]
    valid_t = valid_t & (~is_cat[None, :, None]) & \
        (fmask[:, :, None] > 0)                                    # [S,F,B]
    if hp.extra_trees and rand_bins is not None:
        # extra-trees: evaluate ONE random threshold per (slot, feature)
        # (reference USE_RAND specialization, feature_histogram.hpp:85)
        rt = rand_bins % torch.clamp(t_limit + 1, min=1)[None, :]
        valid_t = valid_t & (bins_r[None, None, :] == rt[:, :, None])
    penalty = None
    if hp.has_monotone and hp.monotone_penalty > 0:
        penalty = _monotone_penalty_factor(depth, hp.monotone_penalty)
    gain_na_right, gain_na_left = numerical_gains(
        prefix, nan_sums, parent_grad, parent_hess, parent_count,
        parent_output, missing_is_nan, valid_t, hp, monotone, cons_min,
        cons_max, penalty)

    # ---------- categorical ----------
    # one-hot branch for low-cardinality features (original l2), sorted-by-
    # ratio two-way scan otherwise (l2 + cat_l2), mirroring
    # FindBestThresholdCategoricalInner (feature_histogram.hpp:278-485).
    # Bin 0 (unseen/NaN) always stays right.
    cl2 = l2 + hp.cat_l2
    use_onehot_f = num_bins <= hp.max_cat_to_onehot                # [F]
    cat_basic_valid = (bins_r[None, None, :] >= 1) & \
        (bins_r[None, None, :] < num_bins[None, :, None])
    if hp.has_categorical:
        po3 = parent_output[:, None, None]
        lg, lh, lc = hist[..., 0], hist[..., 1], hist[..., 2]
        rg = tot[..., 0] - lg
        rh = tot[..., 1] - lh
        rc = tot[..., 2] - lc
        oh_ok = ((lc >= hp.min_data_in_leaf) & (rc >= hp.min_data_in_leaf) &
                 (lh >= hp.min_sum_hessian_in_leaf) &
                 (rh >= hp.min_sum_hessian_in_leaf))
        onehot_gain = (leaf_gain(lg, lh, l1, l2, hp.max_delta_step,
                                 hp.path_smooth, lc, po3) +
                       leaf_gain(rg, rh, l1, l2, hp.max_delta_step,
                                 hp.path_smooth, rc, po3))
        onehot_gain = torch.where(oh_ok & cat_basic_valid, onehot_gain, ninf)
        cnt3 = hist[..., 2]
        sort_ok = cat_basic_valid & (cnt3 >= hp.cat_smooth)
        pinf = -ninf
        ratio = torch.where(sort_ok,
                            hist[..., 0] / (hist[..., 1] + hp.cat_smooth),
                            pinf)
        used_bin = torch.sum(sort_ok, dim=2)                       # [S,F]
        max_num_cat = torch.clamp((used_bin + 1) // 2,
                                  max=hp.max_cat_threshold)        # [S,F]
        pos_limit = torch.minimum(used_bin, max_num_cat)[:, :, None]
        min_rc = max(hp.min_data_in_leaf, hp.min_data_per_group)

        def scan_dir(order):
            sh = torch.gather(hist, 2, order[..., None].expand(s, f, b, 3))
            # float64, rounded once, as numerical_inputs: an f32 cumsum
            # adds in another order on the card than on the CPU
            sp = torch.cumsum(sh.to(torch.float64), dim=2) \
                .to(torch.float32)                                 # [S,F,B,3]
            slg, slh, slc = sp[..., 0], sp[..., 1], sp[..., 2]
            srg = tot[..., 0] - slg
            srh = tot[..., 1] - slh
            src = tot[..., 2] - slc
            ok = ((bins_r[None, None, :] < pos_limit) &
                  (slc >= hp.min_data_in_leaf) &
                  (slh >= hp.min_sum_hessian_in_leaf) &
                  (src >= min_rc) & (srh >= hp.min_sum_hessian_in_leaf))
            g = (leaf_gain(slg, slh, l1, cl2, hp.max_delta_step,
                           hp.path_smooth, slc, po3) +
                 leaf_gain(srg, srh, l1, cl2, hp.max_delta_step,
                           hp.path_smooth, src, po3))
            return torch.where(ok, g, ninf), sp

        # stable sorts: equal ratios keep bin order, as jnp.argsort does
        order_a = torch.argsort(ratio, dim=2, stable=True)
        order_d = torch.argsort(torch.where(sort_ok, -ratio, pinf), dim=2,
                                stable=True)
        gain_a, sp_a = scan_dir(order_a)
        gain_d, sp_d = scan_dir(order_d)
        sorted_gain = torch.maximum(gain_a, gain_d)
        cat_dir_bwd = gain_d > gain_a                              # [S,F,B]
        cat_gain = torch.where(use_onehot_f[None, :, None], onehot_gain,
                               sorted_gain)
        cat_gain = torch.where(
            is_cat[None, :, None] & (fmask[:, :, None] > 0) &
            (cat_gain > min_gain_shift[:, None, None]), cat_gain, ninf)
    else:
        cat_gain = ninf.expand(s, f, b)

    # ---------- combine & first-index argmax ----------
    num_gain = torch.maximum(gain_na_right, gain_na_left)
    # also maps NaN gains to -inf before the argmax
    num_gain = torch.where(num_gain > min_gain_shift[:, None, None],
                           num_gain, ninf)
    all_gain = torch.where(is_cat[None, :, None], cat_gain, num_gain)
    if gain_penalty is not None:
        # constant across one feature's thresholds, so its argmax stands;
        # only the competition across features and the recorded gain see
        # the penalty (as in the reference)
        all_gain = all_gain - gain_penalty[:, :, None]

    flat = all_gain.reshape(s, f * b)
    best_idx = torch.argmax(flat, dim=1)                           # [S]
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_f = torch.div(best_idx, b, rounding_mode="floor")
    best_t = best_idx - best_f * b
    has_split = torch.isfinite(best_gain)

    ar = torch.arange(s, device=dev)
    chose_na_left = gain_na_left[ar, best_f, best_t] >= \
        gain_na_right[ar, best_f, best_t]
    best_is_cat = is_cat[best_f]
    num_left = torch.where(chose_na_left[:, None],
                           (prefix + nan_sums)[ar, best_f, best_t],
                           prefix[ar, best_f, best_t])             # [S, 3]
    w = (b + 31) // 32
    if hp.has_categorical:
        use_oh = use_onehot_f[best_f]                              # [S]
        dir_bwd = cat_dir_bwd[ar, best_f, best_t]                  # [S]
        sorted_left = torch.where(dir_bwd[:, None],
                                  sp_d[ar, best_f, best_t],
                                  sp_a[ar, best_f, best_t])
        cat_left = torch.where(use_oh[:, None], hist[ar, best_f, best_t],
                               sorted_left)
        left = torch.where(best_is_cat[:, None], cat_left, num_left)
        # best one-hot split uses original l2; sorted uses l2 + cat_l2
        # (feature_histogram.hpp:384,476-489)
        eff_l2 = torch.where(best_is_cat & ~use_oh,
                             torch.full((), cl2, device=dev),
                             torch.full((), l2, device=dev))
        # left-set bitset: one-hot -> {best_t}; sorted -> the first
        # best_t+1 bins in the winning scan direction
        order_sel = torch.where(dir_bwd[:, None], order_d[ar, best_f],
                                order_a[ar, best_f])               # [S, B]
        rank_sel = torch.zeros((s, b), dtype=torch.int64, device=dev)
        rank_sel.scatter_(1, order_sel,
                          torch.arange(b, device=dev).expand(s, b))
        member_sorted = rank_sel <= best_t[:, None]
        member_oh = bins_r[None, :] == best_t[:, None]
        member = best_is_cat[:, None] & torch.where(
            use_oh[:, None], member_oh, member_sorted)
        member_p = torch.zeros((s, w * 32), dtype=torch.int64, device=dev)
        member_p[:, :b] = member.to(torch.int64)
        weights = torch.pow(2, torch.arange(32, device=dev, dtype=torch.int64))
        cat_bitset = torch.sum(member_p.reshape(s, w, 32) *
                               weights[None, None, :], dim=2)      # [S, W]
    else:
        left = num_left
        eff_l2 = l2
        cat_bitset = torch.zeros((s, w), dtype=torch.int64, device=dev)
    lgs, lhs, lcs = left[..., 0], left[..., 1], left[..., 2]
    rgs = parent_grad - lgs
    rhs = parent_hess - lhs
    rcs = parent_count - lcs
    lout = leaf_output(lgs, lhs, l1, eff_l2, hp.max_delta_step,
                       hp.path_smooth, lcs, parent_output)
    rout = leaf_output(rgs, rhs, l1, eff_l2, hp.max_delta_step,
                       hp.path_smooth, rcs, parent_output)
    if hp.has_monotone:
        lout = torch.clamp(lout, cons_min, cons_max)
        rout = torch.clamp(rout, cons_min, cons_max)

    return BestSplits(
        gain=torch.where(has_split, best_gain - gain_shift, ninf),
        feature=torch.where(has_split, best_f.to(torch.int32),
                            torch.full((), -1, dtype=torch.int32, device=dev)),
        threshold_bin=best_t.to(torch.int32),
        default_left=torch.where(best_is_cat, False, chose_na_left),
        left_grad=lgs, left_hess=lhs, left_count=lcs,
        left_output=lout, right_output=rout,
        cat_bitset=cat_bitset)
