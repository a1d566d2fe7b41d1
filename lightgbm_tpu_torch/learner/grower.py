"""The portable grower (port of lightgbm_tpu/learner/grower.py, the serial
learner) and the tree state every grower fills.

`TreeArrays` is the struct-of-arrays tree, indexed by node id and sized
[max_nodes + 1] (the last row is scratch): the device-resident
counterpart of the reference Tree (include/LightGBM/tree.h:25) and
CUDATree (cuda_tree.hpp:28). Node 0 is the root; internal nodes carry
split info, leaves carry output values. Categorical left-sets are int64
words holding 32 bits each (the JAX package's uint32 words; torch's
uint32 has few ops).

`grow_tree` is the JAX package's portable grower, the path it takes where
the MXU grower (grower_mxu.py) is excluded: max_bin > 256 (uint16 bins),
the intermediate and advanced monotone methods, use_pallas=false.
Best-first growth with batched frontier passes: each pass histograms every
not-yet-scanned leaf (a slot each, num_leaves + 1 slots), scans their best
splits, and applies the top `num_leaves - leaves` splits by gain; with
`leafwise` only the best one, the reference's leaf-wise order
(serial_tree_learner.cpp:188-206). Histograms: hist_impl "pallas" runs
the slot-grouped scatter kernel (histogram_pallas.build_histograms_scatter,
csrc/build_histograms_scatter.cu on the card, uint8 or uint16 bins),
"scatter" the segment-sum backend (histogram.py, torch index_add_ as the
JAX package's XLA segment sums). Routing, the split choice and the tree
updates are torch ops, as they are XLA ops there; the score update
leaf_value[row_node] is the booster's. With an EFB plan (efb=) the bins
are the bundled matrix: histograms build in bundle space and are expanded
to original features (efb.expand_histograms), rows route through the
plan's loc table (efb.route_bins).

The intermediate and advanced monotone methods (learner/monotone.py) need
leaf-wise growth: every pass caches its frontier's histograms by node,
recomputes every node's bounds from the whole tree and rescans every node
([M+1] slots, the vectorized form of the reference's leaves_to_update
refresh, monotone_constraints.hpp:558-587). feature_fraction_bynode and
extra_trees draw under fold_in(rng_key, pass index), or the fixed fold 1
when rescanning, so a node keeps its draws across rescans.

The JAX package's lax.while_loop is a Python loop here: this grower runs
per iteration only (the booster's fused trainer needs the MXU grower), so
each pass reads `done` on the host once, to stop (`stats`). The root
sums are the fixed-point sums of histogram_mxu.exact_sums, the same bits
on every device. Not ported here: the sharded and feature-parallel
branches (the booster refuses their params).

Forced splits (forced=, the JAX package's grower.py:309-318, 582-660,
716-728; reference ForceSplits, serial_tree_learner.cpp:459) and all
three CEGB terms (cegb_cfg= with cegb_state=, :320-330, 431-449,
731-735, 797-804; reference cost_effective_gradient_boosting.hpp) work as
in grower_mxu.py, the forced sums gathered from the (under EFB expanded)
histograms; the lazy term is each slot's sum of the count weights of its
rows not yet charged for a feature (row_feat_used [N, F], read through
row_node when rescanning), and a row is charged for a feature when its
node splits on it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..utils.log import Log
from . import histogram
from .histogram_mxu import exact_scale, exact_sums, gather_bins
from .histogram_pallas import build_histograms_scatter
from .monotone import recompute_bounds
from .split import (BestSplits, SplitHyperParams, find_best_splits,
                    leaf_gain, leaf_output)

__all__ = ["CegbParams", "CegbState", "TreeArrays", "_init_tree",
           "grow_tree", "HIST_IMPLS"]

#: the portable grower's histogram backends
HIST_IMPLS = ("pallas", "scatter")


@dataclasses.dataclass(frozen=True)
class CegbParams:
    """Static CEGB settings (reference Config cegb_* params,
    cost_effective_gradient_boosting.hpp:23), the JAX package's."""
    tradeoff: float = 1.0
    penalty_split: float = 0.0
    has_coupled: bool = False
    has_lazy: bool = False


@dataclasses.dataclass
class CegbState:
    """The CEGB state a booster carries across its trees, in used-feature
    order: the coupled and lazy per-feature penalties ([F] f32),
    feat_used ([F] bool, the features split on in the model so far) and
    row_feat_used ([N, F] bool, the rows charged for a feature; [1, 1]
    without the lazy term). A grower reads it when a tree starts and sets
    feat_used and row_feat_used to the flags after the tree."""
    coupled: torch.Tensor
    lazy: torch.Tensor
    feat_used: torch.Tensor
    row_feat_used: torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def cegb_penalty(cfg: CegbParams, count: torch.Tensor, num_features: int,
                 coupled: torch.Tensor, feat_used: torch.Tensor
                 ) -> torch.Tensor:
    """[s, F] f32 CEGB gain penalty of scan slots whose nodes hold `count`
    rows ([s]): tradeoff x (penalty_split x count + coupled[f] while f is
    unused in the model), the split and coupled terms of the reference's
    CostEfficientGradientBoosting::DeltaGain (the JAX package's
    grower.py:431-436, grower_mxu.py:728-737); the lazy term is the
    portable grower's."""
    gp = _f32(cfg.tradeoff * cfg.penalty_split) * count[:, None] * \
        torch.ones((count.shape[0], num_features), dtype=torch.float32,
                   device=count.device)
    if cfg.has_coupled:
        gp = gp + _f32(cfg.tradeoff) * coupled[None, :] * \
            (~feat_used)[None, :].to(torch.float32)
    return gp


def mark_used(feat_used: torch.Tensor, fclip: torch.Tensor,
              split_mask: torch.Tensor) -> torch.Tensor:
    """feat_used [F] with the features of this pass's splits set (fclip
    [m1], split_mask [m1]): the model's feature-used flags."""
    f = feat_used.shape[0]
    return feat_used | ((fclip[:, None] == torch.arange(
        f, device=fclip.device)[None, :]) & split_mask[:, None]).any(dim=0)


def force_splits(hist: torch.Tensor, parent, sn: torch.Tensor,
                 node_force: torch.Tensor, spec: torch.Tensor,
                 bs: BestSplits, hp: SplitHyperParams, m: int, f: int,
                 expand=None):
    """Each scan slot's best split overridden by its node's forced spec
    (reference ForceSplits, serial_tree_learner.cpp:459; the JAX
    package's grower.py:582-636, grower_mxu.py:774-848): the spec's
    feature and threshold, the left sums gathered from the slot's
    histogram of that feature as FeatureHistogram::GatherInfoForThreshold
    does, the split gain minus the parent's shift, NaN right, no
    categorical set. Valid where the node has a spec whose feature is in
    use and both children get rows.

    hist: [s, F, B, 3] (original features), or what expand(ff) ([s] i64
    features) turns into the [s, B, 3] rows; parent: the slots'
    (sum_grad, sum_hess, count, leaf_value) [s]; spec: [K, 4] i32
    (feature, threshold bin, left spec, right spec); node_force [m1] each
    node's spec (-1 none). Returns (bs, valid [s] bool). Left and right go
    through the leaf formulas stacked and the replaced fields through one
    where: on the fused trainer these ops run every pass of every tree."""
    pg, ph, pc, pout = parent
    s = sn.shape[0]
    dev = sn.device
    nf_slot = node_force[sn]
    sp = spec[nf_slot.clamp(min=0)]                           # [s, 4]
    ff = sp[:, 0].clamp(0, f - 1).to(torch.int64)
    fb = sp[:, 1]
    hsel = expand(ff) if expand is not None else \
        hist[torch.arange(s, device=dev), ff]                 # [s, B, 3]
    lmask = torch.arange(hsel.shape[1], device=dev)[None, :] <= fb[:, None]
    # summed in float64 and rounded once, as the scan's prefix sums
    left = torch.where(lmask[..., None], hsel.to(torch.float64),
                       0.0).sum(dim=1).to(torch.float32)      # [s, 3]
    # [2, s, 3]: the left child's sums, the right's (parent - left)
    lr = torch.stack([left, torch.stack([pg, ph, pc], -1) - left])
    g2, h2, c2 = lr[..., 0], lr[..., 1], lr[..., 2]
    l1, l2, mds, ps = (hp.lambda_l1, hp.lambda_l2, hp.max_delta_step,
                       hp.path_smooth)
    shift = leaf_gain(pg, ph, l1, l2, mds, ps, pc, pout)
    gain2 = leaf_gain(g2, h2, l1, l2, mds, ps, c2, pout[None])
    out2 = leaf_output(g2, h2, l1, l2, mds, ps, c2, pout[None])
    fgain = gain2[0] + gain2[1] - shift
    valid = (nf_slot >= 0) & (sn < m) & (c2[0] > 0) & (c2[1] > 0) & \
        (sp[:, 0] >= 0)
    new = torch.where(valid, torch.stack(
        [fgain, g2[0], h2[0], c2[0], out2[0], out2[1]]), torch.stack(
        [bs.gain, bs.left_grad, bs.left_hess, bs.left_count,
         bs.left_output, bs.right_output]))
    bs = bs._replace(
        gain=new[0], left_grad=new[1], left_hess=new[2], left_count=new[3],
        left_output=new[4], right_output=new[5],
        feature=torch.where(valid, ff.to(torch.int32), bs.feature),
        threshold_bin=torch.where(valid, fb, bs.threshold_bin),
        default_left=bs.default_left & ~valid,
        cat_bitset=torch.where(valid[:, None], 0, bs.cat_bitset))
    return bs, valid


def forced_children(spec: torch.Tensor, node_force: torch.Tensor,
                    split_mask: torch.Tensor, forced_ok: torch.Tensor):
    """([m1], [m1]) the spec indices the left and right children of each
    node take: the spec's subtrees where the node's forced split was
    applied, -1 elsewhere (a node whose forced split could not apply ends
    the spec's BFS there, as the reference's)."""
    kids = spec[node_force.clamp(min=0)]                      # [m1, 4]
    inherit = (split_mask & (node_force >= 0) & forced_ok)[:, None]
    kids = torch.where(inherit, kids, -1)
    return kids[:, 2], kids[:, 3]


class TreeArrays(NamedTuple):
    split_feature: torch.Tensor   # i32, used-feature idx; -1 for leaf
    threshold_bin: torch.Tensor   # i32; numerical: left iff bin <= t
    default_left: torch.Tensor    # bool (NaN direction)
    is_cat: torch.Tensor          # bool; decision: bin in cat_bitset -> left
    cat_bitset: torch.Tensor      # [M+1, W] int64 words of 32 bits
    left: torch.Tensor            # i32 child id
    right: torch.Tensor           # i32 child id
    parent: torch.Tensor          # i32, -1 for root
    leaf_value: torch.Tensor      # f32 node output
    sum_grad: torch.Tensor        # f32
    sum_hess: torch.Tensor        # f32
    count: torch.Tensor           # f32
    gain: torch.Tensor            # f32 split gain of internal nodes
    depth: torch.Tensor           # i32
    is_leaf: torch.Tensor         # bool
    num_nodes: torch.Tensor       # i32 scalar
    num_leaves: torch.Tensor      # i32 scalar


def _init_tree(max_nodes: int, root_grad, root_hess, root_count,
               root_value, bitset_words: int = 1,
               device=None) -> TreeArrays:
    m1 = max_nodes + 1

    def zf():
        return torch.zeros(m1, dtype=torch.float32, device=device)

    def with_root(v):
        t = zf()
        t[0] = v
        return t

    def full_i(v):
        return torch.full((m1,), v, dtype=torch.int32, device=device)

    is_leaf = torch.zeros(m1, dtype=torch.bool, device=device)
    is_leaf[0].fill_(True)
    return TreeArrays(
        split_feature=full_i(-1), threshold_bin=full_i(0),
        default_left=torch.zeros(m1, dtype=torch.bool, device=device),
        is_cat=torch.zeros(m1, dtype=torch.bool, device=device),
        cat_bitset=torch.zeros((m1, bitset_words), dtype=torch.int64,
                               device=device),
        left=full_i(-1), right=full_i(-1), parent=full_i(-1),
        leaf_value=with_root(root_value), sum_grad=with_root(root_grad),
        sum_hess=with_root(root_hess), count=with_root(root_count),
        gain=zf(), depth=full_i(0), is_leaf=is_leaf,
        num_nodes=torch.ones((), dtype=torch.int32, device=device),
        num_leaves=torch.ones((), dtype=torch.int32, device=device))


def _put(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         limit: int) -> torch.Tensor:
    """base.at[idx].set(vals) along dim 0 with every index outside [0,
    limit) dropped: the writes the JAX package parks in its scratch row
    (node m, slot s) go to a pad row that is sliced off, so no row takes
    two writes."""
    n = base.shape[0]
    i = torch.where((idx >= 0) & (idx < limit), idx.to(torch.int64), n)
    out = torch.cat([base, base[:1]])
    out[i] = vals
    return out[:n]


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              cnt_weight: torch.Tensor, feature_mask: torch.Tensor,
              num_bins: torch.Tensor, missing_is_nan: torch.Tensor,
              is_cat_feat: torch.Tensor, *, num_leaves: int, max_depth: int,
              hp: SplitHyperParams, leafwise: bool = False, bmax: int,
              monotone: Optional[torch.Tensor] = None,
              interaction_groups: Optional[tuple] = None,
              feature_fraction_bynode: float = 1.0,
              rng_key: Optional[torch.Tensor] = None,
              hist_impl: str = "scatter", partition_impl: str = "auto",
              monotone_method: str = "basic", efb=None,
              forced: Optional[tuple] = None,
              cegb_cfg: Optional[CegbParams] = None,
              cegb_state: Optional[CegbState] = None,
              stats: Optional[dict] = None):
    """Grow one tree (the JAX package's grow_tree, serial learner).
    grad/hess already carry the row sample's weights (zeros out of the
    bag); cnt_weight is 1 for sampled rows, 0 otherwise, so
    min_data_in_leaf counts sampled rows. bins: [N, F] uint8 or uint16,
    or with efb (an efb.EfbDev) the bundled [N, Fb] matrix, every other
    argument in original features. monotone: [F] int directions (with
    hp.has_monotone), monotone_method "basic", "intermediate" or
    "advanced" (the last two need leafwise). stats: a dict that gets the
    passes run added in (one host read of `done` a pass) and, under
    monotone constraints, "node_bounds": [M+1, 2] f32, the interval each
    node's value was clamped into when its parent split (+-inf for the
    root), this tree's. forced: the spec tree, (feature, threshold bin,
    left spec, right spec) [K] i32 tensors in BFS order. cegb_cfg with
    cegb_state (a CegbState, advanced to the flags after this tree).

    Returns (tree, row_node [N] i32): each row's leaf, out-of-bag rows
    included, for the booster's score update."""
    if hist_impl not in HIST_IMPLS:
        raise ValueError(f"hist_impl {hist_impl!r}: the portable grower "
                         f"builds histograms with one of {HIST_IMPLS}")
    dev = bins.device
    n = bins.shape[0]
    f = feature_mask.shape[0] if efb is not None else bins.shape[1]
    hist_bmax = efb.bundle_bmax if efb is not None else bmax
    m = 2 * num_leaves - 1             # max nodes
    m1 = m + 1
    s = num_leaves + 1                 # frontier slots (2k children <= S)
    mono_rescan = monotone_method != "basic" and monotone is not None
    if mono_rescan:
        if not leafwise:
            raise ValueError(
                "monotone_constraints_method=%r requires leaf-wise growth"
                % monotone_method)
        # the all-nodes histogram cache is [M+1, F, bmax, 3] f32: warn
        # before allocating it, so an out-of-memory error is attributable
        cache_bytes = m1 * f * bmax * 3 * 4
        if cache_bytes > (1 << 30):
            Log.warning(
                "monotone_constraints_method=%s allocates a %.1f GiB "
                "histogram cache ([%d nodes, %d features, %d bins]); "
                "reduce num_leaves/max_bin or use "
                "monotone_constraints_method='basic' if this OOMs."
                % (monotone_method, cache_bytes / 2**30, m1, f, bmax))
        directions = monotone.tolist()
    k_top = num_leaves - 1             # top-k size

    # root sums in the histograms' fixed point: the same bits on every
    # device (an f32 sum adds in another order on the card than on the CPU)
    fixed = exact_scale(grad, hess, cnt_weight)
    root_g, root_h, root_c = exact_sums(grad, hess, cnt_weight, fixed)
    root_val = leaf_output(root_g, root_h, hp.lambda_l1, hp.lambda_l2,
                           hp.max_delta_step)
    w_cat = (bmax + 31) // 32          # bitset words per node
    tree = _init_tree(m, root_g, root_h, root_c, root_val,
                      bitset_words=w_cat, device=dev)

    def ifull(size, v):
        return torch.full((size,), v, dtype=torch.int32, device=dev)

    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    zf = torch.zeros(m1, dtype=torch.float32, device=dev)
    best = BestSplits(
        gain=ninf.expand(m1).clone(), feature=ifull(m1, -1),
        threshold_bin=ifull(m1, 0),
        default_left=torch.zeros(m1, dtype=torch.bool, device=dev),
        left_grad=zf, left_hess=zf, left_count=zf, left_output=zf,
        right_output=zf,
        cat_bitset=torch.zeros((m1, w_cat), dtype=torch.int64, device=dev))

    group_masks = None
    if interaction_groups:
        gm = np.zeros((len(interaction_groups), f), np.bool_)
        for gi, grp in enumerate(interaction_groups):
            for fi in grp:
                if 0 <= fi < f:
                    gm[gi, fi] = True
        group_masks = torch.as_tensor(gm, device=dev)
        path_mask = torch.zeros((m1, f), dtype=torch.bool, device=dev)
    use_bynode = feature_fraction_bynode < 1.0 and rng_key is not None
    k_bynode = max(1, int(round(feature_fraction_bynode * f)))

    if forced is not None:
        spec = torch.stack(forced, dim=1)
        node_force = ifull(m1, -1)
        node_force[0].fill_(0)
        forced_ok = torch.zeros(m1, dtype=torch.bool, device=dev)
    if cegb_cfg is not None:
        cegb_coupled, cegb_lazy = cegb_state.coupled, cegb_state.lazy
        feat_used, row_feat_used = cegb_state.feat_used, \
            cegb_state.row_feat_used
        if cegb_cfg.has_lazy:
            # charged below in place, on this tree's copy
            row_feat_used = row_feat_used.clone()
    row_node = torch.zeros(n, dtype=torch.int32, device=dev)
    slot_of_node = ifull(m1, -1)
    slot_of_node[0].fill_(0)
    slot_nodes = ifull(s, m)
    slot_nodes[0].fill_(0)
    cons_min = ninf.expand(m1).clone()
    cons_max = (-ninf).expand(m1).clone()
    hist_cache = torch.zeros((m1, f, bmax, 3), dtype=torch.float32,
                             device=dev) if mono_rescan else None
    nodes = torch.arange(m1, dtype=torch.int32, device=dev)
    neg1 = ifull(m1, -1)
    keep_bounds = stats is not None and hp.has_monotone
    if keep_bounds:
        node_lo, node_hi = cons_min.clone(), cons_max.clone()

    passes = 0
    for pass_idx in range(num_leaves - 1):
        passes += 1
        # ---- 1. histograms for the frontier slots
        row_slot = slot_of_node[row_node.to(torch.int64)]
        if hist_impl == "pallas":
            hist = build_histograms_scatter(
                bins, grad, hess, cnt_weight, row_slot, num_slots=s,
                bmax=hist_bmax, partition_impl=partition_impl, scale=fixed)
        else:
            hist = histogram.build_histograms(bins, grad, hess, row_slot,
                                              cnt_weight, num_slots=s,
                                              bmax=hist_bmax)
        if efb is not None:
            from ..efb import expand_histograms
            hist = expand_histograms(hist, efb)
        # ---- 2. best-split scan per slot
        sn = slot_nodes.to(torch.int64)                     # [S] (m: none)
        if mono_rescan:
            # cache the frontier's histograms by node, then rescan EVERY
            # node with freshly recomputed bounds
            hist_cache = _put(hist_cache, sn, hist, m)
            sn = torch.arange(m1, dtype=torch.int64, device=dev)
            hist = hist_cache
            s_scan = m1
        else:
            s_scan = s
        # per-slot feature mask: the tree's fraction x bynode sample x
        # interaction-allowed set (reference ColSampler, col_sampler.hpp:20)
        slot_fmask = feature_mask[None, :].expand(s_scan, f)
        draw = 1 if mono_rescan else pass_idx
        if use_bynode:
            # rescan slots ARE nodes: a fixed fold keeps each node's
            # by-node sample across rescans (the reference samples once a
            # leaf)
            u = rng.uniform(rng.fold_in(rng_key, draw), (s_scan, f))
            u = torch.where(feature_mask[None, :] > 0, u, -ninf)
            kth = torch.sort(u, dim=1).values[:, k_bynode - 1][:, None]
            slot_fmask = slot_fmask * (u <= kth)
        if group_masks is not None:
            pm = path_mask[sn]
            subset = torch.all((~pm[:, None, :]) | group_masks[None, :, :],
                               dim=2)
            allowed = (subset.to(torch.float32) @
                       group_masks.to(torch.float32)) > 0
            slot_fmask = slot_fmask * (allowed | pm)
        rand_bins = None
        if hp.extra_trees and rng_key is not None:
            kr = rng.fold_in(rng.fold_in(rng_key, 7919), draw)
            rand_bins = rng.randint(kr, (s_scan, f), 0, bmax)
        mono_kw = {}
        if hp.has_monotone:
            if mono_rescan:
                cmin_s, cmax_s = recompute_bounds(
                    tree, monotone, num_bins, method=monotone_method,
                    missing_is_nan=missing_is_nan, directions=directions)
            else:
                cmin_s, cmax_s = cons_min[sn], cons_max[sn]
            mono_kw = dict(monotone=monotone, cons_min=cmin_s,
                           cons_max=cmax_s, depth=tree.depth[sn])
        gp = None
        if cegb_cfg is not None:
            gp = cegb_penalty(cegb_cfg, tree.count[sn], f, cegb_coupled,
                              feat_used)
            if cegb_cfg.has_lazy:
                # each slot's count weight of the rows not yet charged for
                # a feature (the reference's on-demand cost)
                rs = row_node if mono_rescan else \
                    torch.where(row_slot < 0, s, row_slot)
                uncharged = torch.zeros((s_scan + 1, f), dtype=torch.float32,
                                        device=dev).index_add_(
                    0, rs.to(torch.int64),
                    (~row_feat_used).to(torch.float32) *
                    cnt_weight[:, None])[:s_scan]
                gp = gp + _f32(cegb_cfg.tradeoff) * cegb_lazy[None, :] * \
                    uncharged
        parent = (tree.sum_grad[sn], tree.sum_hess[sn], tree.count[sn],
                  tree.leaf_value[sn])
        bs = find_best_splits(
            hist, *parent, num_bins, missing_is_nan, is_cat_feat,
            slot_fmask, hp, rand_bins=rand_bins, gain_penalty=gp, **mono_kw)
        if forced is not None:
            bs, valid = force_splits(hist, parent, sn, node_force, spec, bs,
                                     hp, m, f)
            forced_ok = _put(forced_ok, sn, valid, m)
        best = BestSplits(*[_put(getattr(best, fld), sn, getattr(bs, fld),
                                 m) for fld in BestSplits._fields])

        # ---- 3. choose splits: top-budget by gain
        eligible = tree.is_leaf & torch.isfinite(best.gain) & (best.gain > 0)
        if forced is not None:
            # forced nodes split whatever the sign of their gain, and
            # outrank every gain-chosen candidate
            eligible = tree.is_leaf & torch.isfinite(best.gain) & \
                ((best.gain > 0) | forced_ok)
        if max_depth > 0:
            eligible &= tree.depth < max_depth
        gains = torch.where(eligible[:m], best.gain[:m], ninf)
        if forced is not None:
            gains = torch.where(eligible[:m] & forced_ok[:m],
                                1e30 + best.gain[:m], gains)
        budget = num_leaves - tree.num_leaves
        k_allowed = torch.clamp(budget, max=1 if leafwise else k_top)
        # top_k with ties broken lower index first, as lax.top_k does
        top_vals, top_idx = torch.sort(gains, descending=True, stable=True)
        top_vals, top_idx = top_vals[:k_top], top_idx[:k_top]
        take = (torch.arange(k_top, device=dev) < k_allowed) & \
            torch.isfinite(top_vals)
        split_mask = torch.zeros(m1, dtype=torch.bool, device=dev)
        split_mask[top_idx] = take
        k = torch.sum(split_mask, dtype=torch.int32)

        # ---- 4. apply splits
        order = (torch.cumsum(split_mask.to(torch.int32), dim=0) - 1) \
            .to(torch.int32)
        child_l = torch.where(split_mask, tree.num_nodes + 2 * order, m) \
            .to(torch.int32)
        child_r = torch.where(split_mask, tree.num_nodes + 2 * order + 1,
                              m).to(torch.int32)
        rg = tree.sum_grad - best.left_grad
        rh = tree.sum_hess - best.left_hess
        rc = tree.count - best.left_count
        feat = best.feature
        fclip = feat.to(torch.int64).clamp(0, f - 1)
        new_tree = tree._replace(
            split_feature=torch.where(split_mask, feat, tree.split_feature),
            threshold_bin=torch.where(split_mask, best.threshold_bin,
                                      tree.threshold_bin),
            default_left=torch.where(split_mask, best.default_left,
                                     tree.default_left),
            is_cat=torch.where(split_mask, is_cat_feat[fclip], tree.is_cat),
            cat_bitset=torch.where(split_mask[:, None], best.cat_bitset,
                                   tree.cat_bitset),
            left=torch.where(split_mask, child_l, tree.left),
            right=torch.where(split_mask, child_r, tree.right),
            gain=torch.where(split_mask, best.gain, tree.gain),
            is_leaf=tree.is_leaf & ~split_mask,
            num_nodes=tree.num_nodes + 2 * k,
            num_leaves=tree.num_leaves + k)

        def scat(arr, lv, rv):
            return _put(_put(arr, child_l, lv, m), child_r, rv, m)

        d1 = tree.depth + 1
        new_tree = new_tree._replace(
            parent=scat(new_tree.parent, nodes, nodes),
            leaf_value=scat(new_tree.leaf_value, best.left_output,
                            best.right_output),
            sum_grad=scat(new_tree.sum_grad, best.left_grad, rg),
            sum_hess=scat(new_tree.sum_hess, best.left_hess, rh),
            count=scat(new_tree.count, best.left_count, rc),
            depth=scat(new_tree.depth, d1, d1),
            is_leaf=scat(new_tree.is_leaf, split_mask, split_mask),
            split_feature=scat(new_tree.split_feature, neg1, neg1),
            left=scat(new_tree.left, neg1, neg1),
            right=scat(new_tree.right, neg1, neg1))
        ninf_m = ninf.expand(m1)
        best = best._replace(gain=scat(best.gain, ninf_m, ninf_m))
        if forced is not None:
            node_force = scat(node_force, *forced_children(
                spec, node_force, split_mask, forced_ok))
            zb = torch.zeros(m1, dtype=torch.bool, device=dev)
            forced_ok = scat(forced_ok, zb, zb)
        if cegb_cfg is not None and cegb_cfg.has_coupled:
            feat_used = mark_used(feat_used, fclip, split_mask)
        if keep_bounds:
            # the bounds the children's outputs were clamped to: the
            # parent's in this pass's scan
            lo, hi = (cmin_s, cmax_s) if mono_rescan else (cons_min,
                                                           cons_max)
            node_lo, node_hi = scat(node_lo, lo, lo), scat(node_hi, hi, hi)
        if hp.has_monotone and not mono_rescan:
            # basic method: mid = (l_out + r_out) / 2 caps the increasing
            # side and floors the other (monotone_constraints.hpp
            # BasicLeafConstraints::UpdateConstraints)
            mcf = monotone[fclip]
            mid = (best.left_output + best.right_output) * 0.5
            lmin = torch.where(mcf < 0, torch.maximum(cons_min, mid),
                               cons_min)
            lmax = torch.where(mcf > 0, torch.minimum(cons_max, mid),
                               cons_max)
            rmin = torch.where(mcf > 0, torch.maximum(cons_min, mid),
                               cons_min)
            rmax = torch.where(mcf < 0, torch.minimum(cons_max, mid),
                               cons_max)
            cons_min = scat(cons_min, lmin, rmin)
            cons_max = scat(cons_max, lmax, rmax)
        if group_masks is not None:
            fsel = (torch.arange(f, device=dev)[None, :] == fclip[:, None]) \
                & split_mask[:, None]
            child_pm = path_mask | fsel
            path_mask = scat(path_mask, child_pm, child_pm)

        # ---- 5. frontier slots for the children
        slot_l = torch.where(split_mask, 2 * order, s)
        slot_r = torch.where(split_mask, 2 * order + 1, s)
        slot_nodes = _put(_put(ifull(s, m), slot_l, child_l, s), slot_r,
                          child_r, s)
        slot_of_node = scat(ifull(m1, -1), slot_l.to(torch.int32),
                            slot_r.to(torch.int32))

        # ---- 6. route rows through the new splits
        pnode = row_node.to(torch.int64)
        pm_rows = split_mask[pnode]
        pf = fclip[pnode]
        if efb is not None:
            from ..efb import route_bins
            binv = route_bins(bins, pf, efb)
        else:
            binv = gather_bins(bins, pf)
        is_nan_bin = missing_is_nan[pf] & (binv == num_bins[pf] - 1)
        bitw = best.cat_bitset[pnode, binv // 32]
        in_set = ((bitw >> (binv % 32)) & 1) == 1
        go_left = torch.where(
            is_cat_feat[pf], in_set,
            torch.where(is_nan_bin, best.default_left[pnode],
                        binv <= best.threshold_bin[pnode]))
        row_node = torch.where(
            pm_rows, torch.where(go_left, child_l[pnode], child_r[pnode]),
            row_node)
        if cegb_cfg is not None and cegb_cfg.has_lazy:
            # the rows of a node that split are charged for its feature
            # (the reference's per-row is_feature_used_ flags)
            ar_n = torch.arange(n, device=dev)
            row_feat_used[ar_n, pf] = row_feat_used[ar_n, pf] | pm_rows
        tree = new_tree
        # the loop's one host read a pass: is growth over
        if bool((k == 0) | (tree.num_leaves >= num_leaves)):
            break
    if stats is not None:
        stats["passes"] = stats.get("passes", 0) + passes
        if keep_bounds:
            stats["node_bounds"] = torch.stack([node_lo, node_hi], 1)
    if cegb_cfg is not None:
        cegb_state.feat_used = feat_used
        cegb_state.row_feat_used = row_feat_used
    return tree, row_node
