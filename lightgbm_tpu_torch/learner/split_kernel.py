"""Fused best-split scan: one kernel launch per growth pass.

Port of lightgbm_tpu/learner/split_kernel.py, the single-launch analog of
the reference's CUDABestSplitFinder (cuda_best_split_finder.cu:603
FindBestSplitsForLeafKernel). split.find_best_splits runs ~100 small torch
ops over [S, F, B] tensors per pass; csrc/find_best_splits.cu scans every
slot end to end in one launch: float64 prefix sums along bins rounded to
f32 once (split.numerical_inputs' sums), the gain forms of split.py with
the NaN bin kept right and sent left, basic monotone constraints (output
clipping, violation kill, depth penalty), and the per-slot first-index
argmax over (feature, bin).

The kernel and its plain version (find_best_splits_kernel_ref) emit only
the selection: has_split, feature, threshold bin, NaN direction and the
left sums of both NaN options. The wrapper recomputes gains and outputs
from the picked sums with split.py's helpers ([S]-sized ops), so the
kernel's arithmetic can only ever move the choice between near-tied
candidates, never a returned number.

Scope (grow_tree_mxu takes split.find_best_splits outside it): numerical
features only (categorical features are masked off), no extra_trees
random thresholds. The wrapper runs the kernel for CUDA tensors and the
plain version for CPU tensors, nothing else; launches count in
histogram_mxu.launch_counts as find_best_splits and find_best_splits_mono.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _cuda
from .histogram_mxu import _check, _on_cpu, count_launch
from .split import (BestSplits, SplitHyperParams, _gain_given_output,
                    _monotone_penalty_factor, _neg_inf, _split_gain,
                    leaf_gain, leaf_output, numerical_gains,
                    numerical_inputs)

__all__ = ["find_best_splits_kernel", "find_best_splits_kernel_ref",
           "kernel_supports", "pack_inputs"]

# per-slot output columns of the kernel and its plain version
O_HAS = 0       # has_split (0/1)
O_FEAT = 1      # best feature (f32; -1 if none)
O_BIN = 2       # best threshold bin (f32)
O_NAL = 3       # chose the NaN-left option (0/1), ungated
O_LR = 4        # left grad, hess, count sums, NaN-right option (3 columns)
O_LL = 7        # the same, NaN-left option (3 columns)
N_OUT = 16      # padded
# parent table columns (the wrapper computes each; both versions read them)
P_GRAD, P_HESS, P_COUNT, P_OUT, P_CMIN, P_CMAX, P_PEN, P_MIN_SHIFT = range(8)


def kernel_supports(hp: SplitHyperParams) -> bool:
    """Whether the fused scan kernel covers this hyperparameter set."""
    return not hp.has_categorical and not hp.extra_trees


def find_best_splits_kernel_ref(hist: torch.Tensor, parent: torch.Tensor,
                                fmask: torch.Tensor, feat_tbl: torch.Tensor,
                                monotone: Optional[torch.Tensor],
                                hp: SplitHyperParams) -> torch.Tensor:
    """Plain version of the kernel: the selection [S, N_OUT] f32.

    hist: [S, F, B, 3] f32; parent: [S, 8] f32 (P_* columns: sums,
    output, monotone bounds, depth penalty and gain_shift +
    min_gain_to_split of each slot); fmask: [S, F] f32, 0 disables a
    feature; feat_tbl: [F, 2] i32 (num_bins, missing_is_nan); monotone:
    [F] i32, or None for the unconstrained gain forms."""
    s, f, b, _ = hist.shape
    num_bins, missing_is_nan = feat_tbl[:, 0], feat_tbl[:, 1] > 0
    prefix, nan_sums, t_limit = numerical_inputs(hist, num_bins,
                                                 missing_is_nan)
    bins_r = torch.arange(b, dtype=torch.int32, device=hist.device)
    valid_t = (bins_r[None, None, :] <= t_limit[None, :, None]) & \
        (fmask[:, :, None] > 0)
    col = parent.unbind(1)
    g_right, g_left = numerical_gains(
        prefix, nan_sums, col[P_GRAD], col[P_HESS], col[P_COUNT],
        col[P_OUT], missing_is_nan, valid_t,
        dataclasses.replace(hp, has_monotone=monotone is not None),
        monotone, col[P_CMIN], col[P_CMAX], col[P_PEN])
    ninf = _neg_inf(hist)
    # torch.maximum keeps a NaN gain, which the gate then maps to -inf
    combined = torch.maximum(g_right, g_left)
    combined = torch.where(combined > col[P_MIN_SHIFT][:, None, None],
                           combined, ninf)
    flat = combined.reshape(s, f * b)
    best = torch.argmax(flat, dim=1)                # first index of the max
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    bf = torch.div(best, b, rounding_mode="floor")
    bt = best - bf * b
    ar = torch.arange(s, device=hist.device)
    has = best_gain > -3e38
    out = torch.zeros((s, N_OUT), dtype=torch.float32, device=hist.device)
    out[:, O_HAS] = has.to(torch.float32)
    out[:, O_FEAT] = torch.where(has, bf.to(torch.float32),
                                 torch.full((), -1.0, device=hist.device))
    out[:, O_BIN] = bt.to(torch.float32)
    # ungated, as split.find_best_splits: junk slots compare their -inf
    # (or below-gate) gains at (feature 0, bin 0)
    out[:, O_NAL] = (g_left[ar, bf, bt] >= g_right[ar, bf, bt]) \
        .to(torch.float32)
    left_r = prefix[ar, bf, bt]                                    # [S, 3]
    out[:, O_LR:O_LR + 3] = left_r
    out[:, O_LL:O_LL + 3] = left_r + nan_sums[ar, bf, 0]
    return out


def pack_inputs(parent_grad, parent_hess, parent_count, parent_output,
                num_bins, missing_is_nan, is_cat, feature_mask,
                hp: SplitHyperParams, monotone=None, cons_min=None,
                cons_max=None, depth=None):
    """The kernel's tables from find_best_splits' arguments: parent [S, 8]
    f32, fmask [S, F] f32 (categorical features masked off), feat_tbl
    [F, 2] i32 and monotone [F] i32 (None unless hp.has_monotone and
    constraints are given)."""
    s, f = parent_grad.shape[0], num_bins.shape[0]
    has_mono = hp.has_monotone and monotone is not None
    zeros = torch.zeros_like(parent_grad)
    gain_shift = leaf_gain(parent_grad, parent_hess, hp.lambda_l1,
                           hp.lambda_l2, hp.max_delta_step)
    pen = zeros
    if has_mono and hp.monotone_penalty > 0:
        pen = _monotone_penalty_factor(
            depth if depth is not None else zeros, hp.monotone_penalty)
    parent = torch.stack(
        [parent_grad, parent_hess, parent_count, parent_output,
         cons_min if has_mono else zeros, cons_max if has_mono else zeros,
         pen, gain_shift + hp.min_gain_to_split], dim=1) \
        .to(torch.float32).contiguous()
    fmask = feature_mask.to(torch.float32).reshape(
        (1, f) if feature_mask.dim() == 1 else (s, f)).expand(s, f)
    # numerical-only kernel: categorical features are masked off
    fmask = (fmask * (~is_cat).to(torch.float32)[None, :]).contiguous()
    feat_tbl = torch.stack([num_bins.to(torch.int32),
                            missing_is_nan.to(torch.int32)], 1).contiguous()
    mono = monotone.to(torch.int32).contiguous() if has_mono else None
    return parent, fmask, feat_tbl, mono


def _launch(hist, parent, fmask, feat_tbl, mono, hp) -> torch.Tensor:
    s, f, b, _ = hist.shape
    _check(hist, "hist", torch.float32, (s, f, b, 3))
    _check(parent, "parent", torch.float32, (s, 8))
    _check(fmask, "fmask", torch.float32, (s, f))
    _check(feat_tbl, "feat_tbl", torch.int32, (f, 2))
    if mono is not None:
        _check(mono, "monotone", torch.int32, (f,))
    out = torch.empty((s, N_OUT), dtype=torch.float32, device=hist.device)
    ps = hp.path_smooth
    # torch divides a CUDA tensor by a Python scalar as a multiply by its
    # f32 reciprocal; the kernel does the same for count / path_smooth
    inv_ps = float(np.float32(1.0) / np.float32(ps)) if ps > 0 else 0.0
    _cuda.call("find_best_splits", hist.device, hist, parent, fmask,
               feat_tbl, mono, out, s, f, b,
               int(mono is not None and hp.monotone_penalty > 0),
               float(hp.lambda_l1), float(hp.lambda_l2),
               float(hp.min_data_in_leaf), float(hp.min_sum_hessian_in_leaf),
               float(hp.max_delta_step), float(ps), inv_ps)
    count_launch("find_best_splits_mono" if mono is not None
                 else "find_best_splits")
    return out


def find_best_splits_kernel(hist: torch.Tensor, parent_grad: torch.Tensor,
                            parent_hess: torch.Tensor,
                            parent_count: torch.Tensor,
                            parent_output: torch.Tensor,
                            num_bins: torch.Tensor,
                            missing_is_nan: torch.Tensor,
                            is_cat: torch.Tensor, feature_mask: torch.Tensor,
                            hp: SplitHyperParams,
                            monotone: Optional[torch.Tensor] = None,
                            cons_min: Optional[torch.Tensor] = None,
                            cons_max: Optional[torch.Tensor] = None,
                            depth: Optional[torch.Tensor] = None
                            ) -> BestSplits:
    """split.find_best_splits (numerical subset) in one kernel launch.

    Same contract as split.find_best_splits for kernel_supports(hp);
    cat_bitset is zeros. The kernel runs for CUDA tensors, its plain
    version for CPU tensors."""
    s, f, b, _ = hist.shape
    parent, fmask, feat_tbl, mono = pack_inputs(
        parent_grad, parent_hess, parent_count, parent_output, num_bins,
        missing_is_nan, is_cat, feature_mask, hp, monotone, cons_min,
        cons_max, depth)
    if _on_cpu(hist, parent_grad, num_bins, feature_mask):
        out = find_best_splits_kernel_ref(hist, parent, fmask, feat_tbl,
                                          mono, hp)
    else:
        out = _launch(hist.contiguous(), parent, fmask, feat_tbl, mono, hp)

    has_split = out[:, O_HAS] > 0.5
    na_left = out[:, O_NAL] > 0.5
    left = torch.where(na_left[:, None], out[:, O_LL:O_LL + 3],
                       out[:, O_LR:O_LR + 3])
    lg, lh, lc = left.unbind(1)
    rg = parent_grad - lg
    rh = parent_hess - lh
    rc = parent_count - lc
    # gains and outputs recomputed from the picked sums ([S]-sized ops)
    l1, l2 = hp.lambda_l1, hp.lambda_l2
    gain_shift = leaf_gain(parent_grad, parent_hess, l1, l2,
                           hp.max_delta_step)
    lout = leaf_output(lg, lh, l1, l2, hp.max_delta_step, hp.path_smooth,
                       lc, parent_output)
    rout = leaf_output(rg, rh, l1, l2, hp.max_delta_step, hp.path_smooth,
                       rc, parent_output)
    feat = out[:, O_FEAT].to(torch.int32)
    if mono is not None:
        lout = torch.clamp(lout, cons_min, cons_max)
        rout = torch.clamp(rout, cons_min, cons_max)
        g = _gain_given_output(lg, lh, l1, l2, lout) + \
            _gain_given_output(rg, rh, l1, l2, rout)
        if hp.monotone_penalty > 0:
            bfc = feat.to(torch.int64).clamp(0, f - 1)
            g = torch.where(mono[bfc] != 0, g * parent[:, P_PEN], g)
    else:
        g = _split_gain(lg, lh, lc, rg, rh, rc, l1, l2, hp, parent_output)
    return BestSplits(
        gain=torch.where(has_split, g - gain_shift, _neg_inf(hist)),
        feature=feat, threshold_bin=out[:, O_BIN].to(torch.int32),
        default_left=na_left,   # ungated, as split.py's junk slots
        left_grad=lg, left_hess=lh, left_count=lc,
        left_output=lout, right_output=rout,
        cat_bitset=torch.zeros((s, (b + 31) // 32), dtype=torch.int64,
                               device=hist.device))
