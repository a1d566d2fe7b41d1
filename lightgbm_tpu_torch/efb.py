"""Exclusive Feature Bundling (reference feature_group.h:25,
docs/Features.rst:36, dataset.cpp FindGroups/FastFeatureBundling).

Port of lightgbm_tpu/efb.py. Mutually exclusive sparse features share a
uint8 bundle column, one feature's non-default bins after another, so the
histogram kernels run on [S, Fb, Bb] with Fb << F. The rest of the
learner sees original features:

- the plan (`build_plan`, `bundle_matrix`) is host numpy, bit for bit the
  JAX package's (the same greedy order, sample and tables);
- `make_device_tables` puts its tables on the booster's device as torch
  tensors (EfbDev), with the segmented scan's position tables (EfbScan,
  learner/split_bundled.py) and the bundle-range routing tables that
  pack_route_tables copies into the node table's EFB columns;
- `expand_histograms` turns a bundled histogram back into per-feature
  histograms (each feature's default-bin mass is node total minus its
  segment's sum), the expansion fallback of efb_segmented_scan=false;
- `route_bins` decodes a row's original-feature bin through the [F, Bb]
  loc table (kernel V's bundled mode, learner/predict.py, does the same).

The expansion's sums are taken in float64 and rounded to f32 once, as the
port's split scans take their prefix sums, so they do not depend on the
order of the additions (the card's and the CPU's differ).

Single-feature bundles keep their identity mapping (column = the feature's
column, default bin at its own position), so dense features pay nothing.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .learner.histogram_mxu import gather_bins
from .utils.log import Log

__all__ = ["EfbPlan", "EfbScan", "EfbDev", "build_plan", "bundle_matrix",
           "make_device_tables", "expand_histograms", "route_bins"]


class EfbPlan(NamedTuple):
    """Host-side bundling plan over USED-feature indices."""
    bundles: List[List[int]]        # per column: used-feature indices
    col_of_feat: np.ndarray         # [F] bundle column of each feature
    seg_lo: np.ndarray              # [F] first bundle-bin of f's segment
    seg_hi: np.ndarray              # [F] last bundle-bin of f's segment
    is_multi: np.ndarray            # [F] True when f shares its column
    pos_of_local: np.ndarray        # [F, bmax] bundle-bin of local bin b
    #                                 (-1: reconstructed default, -2: pad)
    local_of_pos: np.ndarray        # [Fb, Bb] local bin at column position
    col_bins: np.ndarray            # [Fb] bins used per column
    num_cols: int
    bundle_bmax: int                # Bb (max bins over columns)

    @property
    def effective(self) -> bool:
        return bool(np.any(self.is_multi))


def build_plan(bins: np.ndarray, num_bins: np.ndarray,
               default_bins: np.ndarray, is_categorical: np.ndarray,
               *, max_bundle_bins: int = 256, sample_rows: int = 20000,
               max_conflict_frac: float = 0.0,
               min_sparsity: float = 0.8) -> Optional[EfbPlan]:
    """Greedy conflict-bounded bundling (reference dataset.cpp FindGroups):
    features in decreasing non-default count order join the first bundle
    whose occupied-row overlap stays within budget and whose bin total
    fits. None when nothing bundles (narrow or dense data). Only
    sufficiently sparse numeric features bundle; dense and categorical
    features keep identity columns."""
    n, f = bins.shape
    if f < 8:
        return None
    rs = np.random.RandomState(13)
    rows = np.arange(n) if n <= sample_rows else \
        np.sort(rs.choice(n, sample_rows, replace=False))
    sub = np.ascontiguousarray(bins[rows].T)            # [F, S] contiguous
    nondef = sub != default_bins[:, None]               # [F, S]
    nd_cnt = nondef.sum(axis=1)
    s = len(rows)

    can_bundle = (~is_categorical) & (nd_cnt <= (1.0 - min_sparsity) * s) \
        & (num_bins >= 2)
    budget = int(max_conflict_frac * s)

    order = np.argsort(nd_cnt, kind="stable")[::-1]     # dense-first
    occ: List[np.ndarray] = []                          # per multi-bundle
    bins_used: List[int] = []
    members: List[List[int]] = []
    singleton: List[int] = []
    for fi in order:
        fi = int(fi)
        if not can_bundle[fi]:
            singleton.append(fi)
            continue
        need = int(num_bins[fi]) - 1                    # non-default bins
        placed = False
        for b in range(len(occ)):
            if bins_used[b] + need > max_bundle_bins:
                continue
            if int(np.count_nonzero(occ[b] & nondef[fi])) <= budget:
                members[b].append(fi)
                occ[b] |= nondef[fi]
                bins_used[b] += need
                placed = True
                break
        if not placed:
            members.append([fi])
            occ.append(nondef[fi].copy())
            bins_used.append(1 + need)
    # bundles that stayed alone revert to identity columns
    for b in range(len(members) - 1, -1, -1):
        if len(members[b]) == 1:
            singleton.append(members[b][0])
            del members[b], occ[b], bins_used[b]
    if not members:
        return None

    bundles = [sorted(m) for m in members] + [[fi] for fi in
                                              sorted(singleton)]
    bmax = int(num_bins.max())
    col_of_feat = np.zeros(f, np.int32)
    seg_lo = np.zeros(f, np.int32)
    seg_hi = np.zeros(f, np.int32)
    is_multi = np.zeros(f, bool)
    pos_of_local = np.full((f, bmax), -2, np.int32)
    col_bins = np.zeros(len(bundles), np.int32)
    for g, feats in enumerate(bundles):
        multi = len(feats) > 1
        pos = 1 if multi else 0                         # pos 0 = default
        for fi in feats:
            col_of_feat[fi] = g
            is_multi[fi] = multi
            nb = int(num_bins[fi])
            if multi:
                seg_lo[fi] = pos
                for b in range(nb):
                    if b == int(default_bins[fi]):
                        pos_of_local[fi, b] = -1        # reconstructed
                    else:
                        pos_of_local[fi, b] = pos
                        pos += 1
                seg_hi[fi] = pos - 1
            else:
                seg_lo[fi] = 0
                seg_hi[fi] = nb - 1
                pos_of_local[fi, :nb] = np.arange(nb)
                pos = nb
        col_bins[g] = pos
    bb = int(col_bins.max())
    local_of_pos = np.zeros((len(bundles), bb), np.int32)
    for g, feats in enumerate(bundles):
        for fi in feats:
            for b in range(int(num_bins[fi])):
                p = pos_of_local[fi, b]
                if p >= 0:
                    local_of_pos[g, p] = b
    plan = EfbPlan(bundles, col_of_feat, seg_lo, seg_hi, is_multi,
                   pos_of_local, local_of_pos, col_bins, len(bundles), bb)
    Log.info("EFB: bundled %d features into %d columns (max %d bins)",
             f, plan.num_cols, bb)
    return plan


def bundle_matrix(bins: np.ndarray, plan: EfbPlan) -> np.ndarray:
    """Re-encode the [N, F] bin matrix as [N, Fb] bundle columns."""
    n = bins.shape[0]
    dtype = np.uint8 if plan.bundle_bmax <= 256 else np.uint16
    out = np.zeros((n, plan.num_cols), dtype)
    for g, feats in enumerate(plan.bundles):
        if len(feats) == 1 and not plan.is_multi[feats[0]]:
            out[:, g] = bins[:, feats[0]].astype(dtype)
            continue
        for fi in feats:
            col = bins[:, fi].astype(np.int64)
            pos = plan.pos_of_local[fi][col]            # [N]
            active = pos >= 0
            # conflicts (simultaneously active features) resolve to the
            # later feature, within the accepted conflict budget
            out[active, g] = pos[active].astype(dtype)
    return out


class EfbScan(NamedTuple):
    """Tables of the segmented bundle-space split scan
    (learner/split_bundled.py) and of bundle-range routing. Every bundle
    position (g, p) hosts at most one numeric threshold candidate: a
    feature's threshold t != default sits at its own position, and t ==
    default (which has no position) is hosted by the position of its last
    local bin nb - 1 (never a threshold itself). [Fb, Bb] tensors, flat
    indices into the [Fb * Bb] csum (-1: none)."""
    fid: torch.Tensor               # [Fb, Bb] i32 original feature (-1 pad)
    cand_t: torch.Tensor            # [Fb, Bb] i32 hosted threshold (-1)
    prefix_flat: torch.Tensor       # [Fb, Bb] i32 csum idx, -1 = empty
    incl_def: torch.Tensor          # [Fb, Bb] bool add default mass left
    seg_lo_m1_flat: torch.Tensor    # [Fb, Bb] i32 csum idx below segment
    seg_hi_flat: torch.Tensor       # [Fb, Bb] i32 csum idx at segment end
    is_multi_pos: torch.Tensor      # [Fb, Bb] bool feature shares column
    nan_flat: torch.Tensor          # [Fb, Bb] i32 NaN-bin hist idx
    #                                 (-1: the NaN bin IS the default bin)
    has_nan_pos: torch.Tensor       # [Fb, Bb] bool feature has NaN bin
    cat_feats: torch.Tensor         # [Fc] i64 categorical feature ids
    # bundle-range routing (route_rows' efb_range mode): a numeric split
    # (f, t) is position compares on the row's bundle bin — in-segment
    # rows go left iff pos <= pos_thresh[f, t], out-of-segment rows (the
    # feature at its default bin) by db_le_t (default_left where the NaN
    # bin is the default), the NaN position by default_left
    pos_thresh: torch.Tensor        # [F, bmax] i32 last left pos per t
    db_le_t: torch.Tensor           # [F, bmax] bool default bin <= t
    nan_is_default: torch.Tensor    # [F] bool NaN bin IS the default
    p_nan_f: torch.Tensor           # [F] i32 NaN-bin position (-1 none)


class EfbDev(NamedTuple):
    """The plan's tables on the device. loc_table[f, p] is the original
    local bin of feature f when its bundle column holds position p (the
    default bin for out-of-segment positions), so a row's bin on any
    feature is one gather."""
    col_of_feat: torch.Tensor       # [F] i32
    seg_lo: torch.Tensor            # [F] i32
    seg_hi: torch.Tensor            # [F] i32
    flat_pos: torch.Tensor          # [F, bmax] i64 gather index (clipped)
    is_default_pos: torch.Tensor    # [F, bmax] bool
    is_valid_pos: torch.Tensor      # [F, bmax] bool
    loc_table: torch.Tensor         # [F, Bb] i32
    num_cols: int                   # Fb
    scan: Optional[EfbScan] = None  # segmented split scan, or None

    @property
    def bundle_bmax(self) -> int:
        return self.loc_table.shape[1]


def _scan_tables(plan: EfbPlan, default_bins: np.ndarray,
                 num_bins: np.ndarray, missing_is_nan: np.ndarray,
                 is_cat: np.ndarray) -> dict:
    """The EfbScan tables as numpy arrays (the JAX package's
    _make_scan_tables)."""
    fb, bb = plan.num_cols, plan.bundle_bmax
    fid = np.full((fb, bb), -1, np.int32)
    cand_t = np.full((fb, bb), -1, np.int32)
    prefix_flat = np.full((fb, bb), -1, np.int32)
    incl_def = np.zeros((fb, bb), bool)
    seg_lo_m1 = np.full((fb, bb), -1, np.int32)
    seg_hi_f = np.zeros((fb, bb), np.int32)
    is_multi_p = np.zeros((fb, bb), bool)
    nan_flat = np.full((fb, bb), -1, np.int32)
    has_nan_p = np.zeros((fb, bb), bool)
    f = plan.col_of_feat.shape[0]
    bmax = plan.pos_of_local.shape[1]
    pos_thresh = np.zeros((f, bmax), np.int32)
    db_le_t = np.zeros((f, bmax), bool)
    nan_is_def = np.zeros(f, bool)
    p_nan_arr = np.full(f, -1, np.int32)
    for fi in range(f):
        g = int(plan.col_of_feat[fi])
        nb = int(num_bins[fi])
        db = int(default_bins[fi])
        nan = bool(missing_is_nan[fi])
        # range routing: the last left-side position of each threshold
        pp = int(plan.seg_lo[fi]) - 1
        for t in range(bmax):
            if t < nb and plan.pos_of_local[fi, t] >= 0:
                pp = int(plan.pos_of_local[fi, t])
            pos_thresh[fi, t] = pp
            db_le_t[fi, t] = db <= t
        if nan:
            pn = int(plan.pos_of_local[fi, nb - 1])
            p_nan_arr[fi] = pn
            nan_is_def[fi] = pn < 0
        # every position of fi gets its feature id and segment/NaN info
        pos_list = [int(plan.pos_of_local[fi, b]) for b in range(nb)
                    if plan.pos_of_local[fi, b] >= 0]
        p_nan = int(plan.pos_of_local[fi, nb - 1]) if nan else -1
        for p in pos_list:
            fid[g, p] = fi
            seg_lo_m1[g, p] = g * bb + plan.seg_lo[fi] - 1 \
                if plan.seg_lo[fi] > 0 else -1
            seg_hi_f[g, p] = g * bb + plan.seg_hi[fi]
            is_multi_p[g, p] = bool(plan.is_multi[fi])
            has_nan_p[g, p] = nan
            nan_flat[g, p] = g * bb + p_nan if p_nan >= 0 else -1
        if is_cat[fi]:
            continue                    # categoricals: the sub-scan
        t_lim = nb - 2 - (1 if nan else 0)
        for t in range(t_lim + 1):
            if t == db and plan.is_multi[fi]:
                continue                # hosted below
            p = int(plan.pos_of_local[fi, t])
            if p < 0:
                continue
            cand_t[g, p] = t
            prefix_flat[g, p] = g * bb + p
            incl_def[g, p] = bool(plan.is_multi[fi]) and db < t
        if plan.is_multi[fi] and db <= t_lim:
            # t == default has no position: host it on local nb-1's
            # position (never a threshold: nb-1 > t_lim always)
            p_host = int(plan.pos_of_local[fi, nb - 1])
            if p_host < 0:
                raise ValueError("EFB: a bundled feature's default bin is "
                                 "its last bin")
            cand_t[g, p_host] = db
            prefix_flat[g, p_host] = \
                g * bb + int(plan.pos_of_local[fi, db - 1]) if db > 0 \
                else -1
            incl_def[g, p_host] = True
    cat_feats = np.nonzero(np.asarray(is_cat))[0].astype(np.int64)
    return dict(fid=fid, cand_t=cand_t, prefix_flat=prefix_flat,
                incl_def=incl_def, seg_lo_m1_flat=seg_lo_m1,
                seg_hi_flat=seg_hi_f, is_multi_pos=is_multi_p,
                nan_flat=nan_flat, has_nan_pos=has_nan_p,
                cat_feats=cat_feats, pos_thresh=pos_thresh,
                db_le_t=db_le_t, nan_is_default=nan_is_def,
                p_nan_f=p_nan_arr)


def make_device_tables(plan: EfbPlan, default_bins: np.ndarray,
                       num_bins: Optional[np.ndarray] = None,
                       missing_is_nan: Optional[np.ndarray] = None,
                       is_cat: Optional[np.ndarray] = None,
                       device: torch.device = torch.device("cpu")
                       ) -> EfbDev:
    """The plan's tables on `device`; with the feature metadata (num_bins,
    missing_is_nan, is_cat) the segmented scan's tables (EfbScan) too."""
    f, bmax = plan.pos_of_local.shape
    bb = plan.bundle_bmax
    flat = plan.col_of_feat[:, None].astype(np.int64) * bb + \
        np.clip(plan.pos_of_local, 0, bb - 1)
    loc = np.empty((f, bb), np.int32)
    p = np.arange(bb)
    for fi in range(f):
        g = plan.col_of_feat[fi]
        in_seg = (p >= plan.seg_lo[fi]) & (p <= plan.seg_hi[fi])
        loc[fi] = np.where(in_seg, plan.local_of_pos[g], default_bins[fi])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    scan = None
    if num_bins is not None and missing_is_nan is not None and \
            is_cat is not None:
        scan = EfbScan(**{k: dev(v) for k, v in _scan_tables(
            plan, default_bins, num_bins, missing_is_nan, is_cat).items()})
    return EfbDev(
        col_of_feat=dev(plan.col_of_feat), seg_lo=dev(plan.seg_lo),
        seg_hi=dev(plan.seg_hi), flat_pos=dev(flat),
        is_default_pos=dev(plan.pos_of_local == -1),
        is_valid_pos=dev(plan.pos_of_local >= 0), loc_table=dev(loc),
        num_cols=plan.num_cols, scan=scan)


def _empty_to_zero(mass: torch.Tensor) -> torch.Tensor:
    """Default-bin masses [..., 3] (grad, hess, count) with every channel 0
    where the count is: a bin no row reaches sums to zero, while the
    subtraction leaves the cells' roundings in the gradient channels (the
    count channel's subtraction is exact, and a row of zero count weight
    carries zero gradients)."""
    return torch.where(mass[..., 2:] == 0, 0.0, mass)


def expand_histograms(hist_b: torch.Tensor, efb: EfbDev) -> torch.Tensor:
    """[S, Fb, Bb, C] bundled histograms -> [S, F, bmax, C] per original
    feature (the JAX package's expand_histograms). Positions map by a
    gather; each feature's default-bin mass is the node total minus its
    segment's sum (any single column's bins sum to the node total: every
    row lands in one bin of every column), taken in float64 and rounded
    once, and zero in every channel where its count is (_empty_to_zero;
    the JAX package keeps the subtraction's rounding there). Linear in
    the histogram, so it commutes with the sibling subtraction."""
    s, fb, bb, c = hist_b.shape
    flat = hist_b.reshape(s, fb * bb, c)
    gath = flat[:, efb.flat_pos]                        # [S, F, bmax, C]
    h64 = hist_b.to(torch.float64)
    csum = torch.cumsum(h64, dim=2)                     # [S, Fb, Bb, C]
    total = h64[:, 0].sum(dim=1)                        # [S, C]
    col = efb.col_of_feat.to(torch.int64)
    hi_s = csum[:, col, efb.seg_hi.to(torch.int64)]     # [S, F, C]
    lo_gate = (efb.seg_lo > 0)[None, :, None]
    lo_s = torch.where(lo_gate, csum[:, col, (efb.seg_lo - 1).clamp(min=0)
                                     .to(torch.int64)], 0.0)
    dmass = _empty_to_zero(total[:, None] - (hi_s - lo_s))
    dmass = dmass.to(torch.float32)
    zero = torch.zeros((), dtype=hist_b.dtype, device=hist_b.device)
    out = torch.where(efb.is_valid_pos[None, :, :, None], gath, zero)
    return torch.where(efb.is_default_pos[None, :, :, None],
                       dmass[:, :, None], out)


def route_bins(bins: torch.Tensor, pf: torch.Tensor,
               efb: EfbDev) -> torch.Tensor:
    """[N] int64 ORIGINAL-feature local bin of each row for its feature pf
    ([N] original ids) over the bundled [N, Fb] matrix: the feature's
    column, decoded through the loc table (out-of-segment positions read
    the default bin)."""
    pf = pf.to(torch.int64)
    g = efb.col_of_feat[pf].to(torch.int64)
    pos = gather_bins(bins, g)
    return efb.loc_table.reshape(-1)[pf * efb.bundle_bmax + pos] \
        .to(torch.int64)
