"""Segmented bundle-space best-split search (EFB, efb_segmented_scan).

Port of lightgbm_tpu/learner/split_bundled.py. The expansion design
(efb.expand_histograms, then split.find_best_splits) materializes an
[S, F, bmax, 3] tensor each pass; the reference never expands: it scans
each sub-feature's offset range of the bundled histogram
(feature_histogram.hpp offset scans over feature_group.h:25 ranges). This
is that scan as one batched computation over [S, Fb, Bb]: every bundle
position hosts at most one numeric threshold candidate (the EfbScan
bijection, efb.py), whose left sums are two prefix-sum gathers plus the
reconstructed default mass. Categorical features (identity columns, never
bundled) run through split.find_best_splits on a gathered [S, Fc, bmax]
slice.

Gain forms, NaN direction, monotone constraints and the min-data gates
are split.numerical_gains' on a [S, Fb·Bb, 1] view (a position stands
for a feature of one threshold). The prefix sums, segment sums and
default masses are float64, each NaN-right left sum rounded to f32 once
(split.py's rule), so nothing depends on the order of the additions; the
NaN bin's sums are added in f32, as split.py adds them; an empty default
bin's mass is zero in every channel (efb._empty_to_zero), as the
unbundled histogram has it. Exact ties rank by
bundle position, as in the JAX package: a bundled feature's default-bin
threshold is hosted at its segment's last position, so a tie between it
and a later empty bin's threshold goes to the later bin (the thresholds
differ; the partition of the rows does not). The argmax is the first
index. No host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..efb import EfbDev, _empty_to_zero
from .split import (BestSplits, SplitHyperParams, _monotone_penalty_factor,
                    _neg_inf, find_best_splits, leaf_gain, leaf_output,
                    numerical_gains)

__all__ = ["find_best_splits_bundled"]


def find_best_splits_bundled(hist_b: torch.Tensor, parent_grad: torch.Tensor,
                             parent_hess: torch.Tensor,
                             parent_count: torch.Tensor,
                             parent_output: torch.Tensor,
                             num_bins: torch.Tensor,
                             missing_is_nan: torch.Tensor,
                             is_cat: torch.Tensor,
                             feature_mask: torch.Tensor,
                             hp: SplitHyperParams, efb: EfbDev,
                             monotone: Optional[torch.Tensor] = None,
                             cons_min: Optional[torch.Tensor] = None,
                             cons_max: Optional[torch.Tensor] = None,
                             depth: Optional[torch.Tensor] = None,
                             rand_bins: Optional[torch.Tensor] = None,
                             gain_penalty: Optional[torch.Tensor] = None
                             ) -> BestSplits:
    """split.find_best_splits over BUNDLED histograms [S, Fb, Bb, 3]: the
    same contract (per-ORIGINAL-feature num_bins, missing_is_nan, is_cat,
    feature_mask; BestSplits in original feature ids), `efb` an EfbDev
    with its scan tables. gain_penalty [S, F] is applied per original
    feature, to the bundle positions of each and in the categorical
    sub-scan."""
    t = efb.scan
    s, fb, bb, _ = hist_b.shape
    dev = hist_b.device
    f = int(num_bins.shape[0])
    bmax = efb.flat_pos.shape[1]
    l1, l2 = hp.lambda_l1, hp.lambda_l2
    ninf = _neg_inf(hist_b)
    P = fb * bb

    h64 = hist_b.to(torch.float64)
    flat_c = torch.cumsum(h64, dim=2).reshape(s, P, 3)           # float64
    flat_h = hist_b.reshape(s, P, 3)
    # any single column's bin total is the node total
    total = h64[:, 0].sum(dim=1)                                 # [S, 3]

    fid = t.fid.reshape(P).to(torch.int64)
    fid_c = fid.clamp(0, f - 1)
    cand_t = t.cand_t.reshape(P)

    def c_at(idx):                                               # [S, P, 3]
        idx = idx.reshape(P).to(torch.int64)
        got = flat_c[:, idx.clamp(0, P - 1)]
        return torch.where((idx >= 0)[None, :, None], got, 0.0)

    below = c_at(t.seg_lo_m1_flat)
    seg_sum = c_at(t.seg_hi_flat) - below
    dmass = torch.where(t.is_multi_pos.reshape(P)[None, :, None],
                        _empty_to_zero(total[:, None] - seg_sum), 0.0)
    pre = torch.where((t.prefix_flat.reshape(P) >= 0)[None, :, None],
                      c_at(t.prefix_flat) - below, 0.0)
    left_nr = (pre + torch.where(t.incl_def.reshape(P)[None, :, None],
                                 dmass, 0.0)).to(torch.float32)  # NaN right
    nan_pos = t.nan_flat.reshape(P).to(torch.int64)
    has_nan_p = t.has_nan_pos.reshape(P)
    nan_stat = torch.where(
        has_nan_p[None, :, None],
        torch.where((nan_pos >= 0)[None, :, None],
                    flat_h[:, nan_pos.clamp(0, P - 1)],
                    dmass.to(torch.float32)),
        torch.zeros((), dtype=hist_b.dtype, device=dev))

    fmask = feature_mask.to(torch.float32).reshape(
        (1, f) if feature_mask.dim() == 1 else (s, f)).expand(s, f)
    fm_pos = fmask[:, fid_c] * (fid >= 0)                        # [S, P]
    valid = (cand_t >= 0)[None, :] & (fm_pos > 0)                # [S, P]
    if hp.extra_trees and rand_bins is not None:
        t_lim = (num_bins.to(torch.int32) - 2 -
                 missing_is_nan.to(torch.int32))[fid_c]
        rsel = rand_bins[:, fid_c] % torch.clamp(t_lim + 1, min=1)[None, :]
        valid = valid & (cand_t[None, :] == rsel)

    gain_shift = leaf_gain(parent_grad, parent_hess, l1, l2,
                           hp.max_delta_step)                    # [S]
    min_gain_shift = gain_shift + hp.min_gain_to_split
    pen = _monotone_penalty_factor(depth, hp.monotone_penalty) \
        if hp.has_monotone and hp.monotone_penalty > 0 else None
    # the unbundled scan's gains with each position as a feature of one
    # threshold: [S, P, 1] (NaN right, NaN left)
    gain_nr, gain_nl = numerical_gains(
        left_nr[:, :, None], nan_stat[:, :, None], parent_grad,
        parent_hess, parent_count, parent_output, has_nan_p,
        valid[:, :, None], hp,
        monotone[fid_c] if monotone is not None else None, cons_min,
        cons_max, pen)
    gain_nr, gain_nl = gain_nr[..., 0], gain_nl[..., 0]          # [S, P]
    num_gain = torch.maximum(gain_nr, gain_nl)
    # also maps NaN gains to -inf before the argmax
    num_gain = torch.where(num_gain > min_gain_shift[:, None], num_gain,
                           ninf)
    if gain_penalty is not None:
        num_gain = num_gain - gain_penalty[:, fid_c] * (fid >= 0)

    best_p = torch.argmax(num_gain, dim=1)                       # [S]
    ar = torch.arange(s, device=dev)
    num_best_gain = num_gain[ar, best_p]
    num_f = fid[best_p].to(torch.int32)
    num_t = cand_t[best_p]
    chose_na_left = gain_nl[ar, best_p] >= gain_nr[ar, best_p]
    num_left = left_nr[ar, best_p] + torch.where(
        chose_na_left[:, None], nan_stat[ar, best_p], 0.0)       # [S, 3]

    # ---------- categorical sub-scan (identity columns; exact) ----------
    fc = int(t.cat_feats.shape[0])
    w = (bmax + 31) // 32
    if hp.has_categorical and fc > 0:
        cf = t.cat_feats
        fp = efb.flat_pos[cf]                                    # [Fc, bmax]
        hist_cat = torch.where(
            efb.is_valid_pos[cf][None, :, :, None],
            flat_h[:, fp.reshape(-1)].reshape(s, fc, bmax, 3),
            torch.zeros((), dtype=hist_b.dtype, device=dev))
        bs_cat = find_best_splits(
            hist_cat, parent_grad, parent_hess, parent_count,
            parent_output, num_bins[cf], missing_is_nan[cf],
            torch.ones(fc, dtype=torch.bool, device=dev), fmask[:, cf], hp,
            monotone=monotone[cf] if monotone is not None else None,
            cons_min=cons_min, cons_max=cons_max, depth=depth,
            rand_bins=rand_bins[:, cf] if rand_bins is not None else None,
            gain_penalty=gain_penalty[:, cf]
            if gain_penalty is not None else None)
        cat_gain = bs_cat.gain + gain_shift                      # undo shift
        cat_better = cat_gain > torch.where(torch.isfinite(num_best_gain),
                                            num_best_gain, ninf)
        cat_better = cat_better & (bs_cat.feature >= 0)
        best_gain = torch.where(cat_better, cat_gain, num_best_gain)
        best_f = torch.where(
            cat_better, cf[bs_cat.feature.to(torch.int64).clamp(min=0)]
            .to(torch.int32), num_f)
        best_t = torch.where(cat_better, bs_cat.threshold_bin, num_t)
        left = torch.where(
            cat_better[:, None],
            torch.stack([bs_cat.left_grad, bs_cat.left_hess,
                         bs_cat.left_count], -1), num_left)
        chose_na_left = torch.where(cat_better, False, chose_na_left)
        cat_bitset = torch.where(cat_better[:, None], bs_cat.cat_bitset, 0)
        best_is_cat = cat_better
        cat_lout, cat_rout = bs_cat.left_output, bs_cat.right_output
    else:
        best_gain, best_f, best_t = num_best_gain, num_f, num_t
        left = num_left
        cat_bitset = torch.zeros((s, w), dtype=torch.int64, device=dev)
        best_is_cat = torch.zeros(s, dtype=torch.bool, device=dev)
        cat_lout = cat_rout = torch.zeros(s, dtype=torch.float32, device=dev)

    has_split = torch.isfinite(best_gain)
    lgs, lhs, lcs = left[..., 0], left[..., 1], left[..., 2]
    rgs = parent_grad - lgs
    rhs = parent_hess - lhs
    rcs = parent_count - lcs
    lout = leaf_output(lgs, lhs, l1, l2, hp.max_delta_step,
                       hp.path_smooth, lcs, parent_output)
    rout = leaf_output(rgs, rhs, l1, l2, hp.max_delta_step,
                       hp.path_smooth, rcs, parent_output)
    if hp.has_monotone:
        lout = torch.clamp(lout, cons_min, cons_max)
        rout = torch.clamp(rout, cons_min, cons_max)
    # categorical outputs come from the sub-scan (cat_l2 semantics)
    lout = torch.where(best_is_cat, cat_lout, lout)
    rout = torch.where(best_is_cat, cat_rout, rout)
    return BestSplits(
        gain=torch.where(has_split, best_gain - gain_shift, ninf),
        feature=torch.where(has_split, best_f,
                            torch.full((), -1, dtype=torch.int32,
                                       device=dev)),
        threshold_bin=torch.clamp(best_t, min=0).to(torch.int32),
        default_left=torch.where(best_is_cat, False, chose_na_left),
        left_grad=lgs, left_hess=lhs, left_count=lcs,
        left_output=lout, right_output=rout,
        cat_bitset=cat_bitset)
