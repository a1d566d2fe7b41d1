"""The split scan kernel's (K8) work split, on the CPU.

On the card, csrc/find_best_splits.cu runs a CTA of kWarps warps a slot.
Warp 0 lists the slot's features that have a threshold (fmask > 0 and
num_bins - 2 - NaN bin >= 0), in order, kListCap at a time; the warps
take list entries in turn, a feature a group of group_lanes(B) lanes (a
warp above 16 bins, else 4, 8 or 16 lanes), each lane K consecutive bins
(the least odd number >= B / lanes). A lane sums its bins (up to the
feature's last threshold) in float64, the group scans the lane totals
(shuffles up by 1, 2, 4, ... lanes) and shifts them by one lane for each
lane's base; the lane then runs its bins, base + cells in float64 rounded
to f32 once, both NaN options of split.py's gain forms in f32, the gate,
and a strict > against its best. The warp's and then the block's argmax
take the greater gain, then the lower flat index; a slot with nothing
above the gate selects (feature 0, bin 0), its NaN direction from that
threshold's ungated options.

Held here: that plan written out in numpy — lane bin ranges, float64 lane
totals, the scan's grouping, the f32 gain arithmetic in the kernel's
operation order (numpy rounds every f32 op on its own, as the card does
under -fmad=false; the card's division fast path equals the IEEE division
on the range where it is taken, which chip_parts.py --k8 checks on the
card), the per-lane, per-warp and per-slot argmax — against
split_kernel.find_best_splits_kernel_ref: the selection equal and the
picked sums equal bit for bit. Cases: B in {15, 16, 64, 255, 256}, plain
and monotone; a slot with no threshold above the gate whose feature 0 is
masked, and one whose feature 0 is categorical; equal gains on two
features; NaN gains; monotone +1/-1 with the depth penalty; cells from
1M-row hessian sums down to 1e-9.
"""

import re

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.learner import split_kernel as sk
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.test_torch_one_thread import one_thread  # noqa: F401

SRC = (_cuda.CSRC / "find_best_splits.cu").read_text()
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", SRC).group(1))
LIST_CAP = int(re.search(r"constexpr int kListCap = (\d+);", SRC).group(1))
F32 = np.float32
NEG_INF = F32(-np.inf)
NO_INDEX = 0x7FFFFFFF
_S, _F = 8, 7
_WIDTHS = (15, 16, 64, 255, 256)


def group_lanes(nb):
    lanes = 4
    while lanes < nb and lanes < 32:
        lanes <<= 1
    return lanes


def lane_bins(nb, lanes):
    return -(-nb // lanes) | 1


def test_plan_constants_are_the_kernels():
    assert "int lanes = 4;\n  while (lanes < nb && lanes < 32) lanes <<= 1;" \
        in SRC
    assert "return ((nb + lanes - 1) / lanes) | 1;" in SRC
    assert [group_lanes(b) for b in (2, 4, 5, 15, 16, 17, 256)] == \
        [4, 4, 8, 16, 16, 32, 32]
    assert [lane_bins(b, group_lanes(b)) for b in _WIDTHS] == [1, 1, 3, 9, 9]
    assert 32 * 9 >= 256 > 28 * 9       # 256 bins: 29 lanes of 9


# ---- the kernel's f32 arithmetic (split.py's forms, its operation order)

def _tl1(s, p):
    if p["simple"]:
        return s
    sgn = np.where(s > 0, F32(1), np.where(s < 0, F32(-1), F32(0)))
    a = np.abs(s) - p["l1"]
    a = np.where(a < 0, F32(0), a).astype(F32)
    return (sgn * a).astype(F32)


def _leaf_output(g, h, c, po, p):
    ret = -_tl1(g, p) / (h + p["l2"])
    if p["simple"]:
        return ret
    if p["max_delta"] > 0:
        ret = np.minimum(np.maximum(ret, -p["max_delta"]), p["max_delta"])
    if p["path_smooth"] > 0:
        n_over = c * p["inv_ps"]
        ret = ret * n_over / (n_over + F32(1)) + po / (n_over + F32(1))
    return ret


def _gain_given_output(g, h, out, p):
    return -(F32(2) * _tl1(g, p) * out + (h + p["l2"]) * out * out)


def _leaf_gain(g, h, c, po, p):
    if p["simple"] or (p["max_delta"] <= 0 and p["path_smooth"] <= 0):
        sg = _tl1(g, p)
        return sg * sg / (h + p["l2"])
    return _gain_given_output(g, h, _leaf_output(g, h, c, po, p), p)


def _eval_option(lg, lh, lc, q, mono, p):
    rg, rh, rc = q[sk.P_GRAD] - lg, q[sk.P_HESS] - lh, q[sk.P_COUNT] - lc
    ok = (lc >= p["min_data"]) & (rc >= p["min_data"]) & \
        (lh >= p["min_hess"]) & (rh >= p["min_hess"])
    po = q[sk.P_OUT]
    if p["mono"]:
        lo, hi = q[sk.P_CMIN], q[sk.P_CMAX]
        lout = np.minimum(np.maximum(_leaf_output(lg, lh, lc, po, p), lo),
                          hi)
        rout = np.minimum(np.maximum(_leaf_output(rg, rh, rc, po, p), lo),
                          hi)
        violate = ((mono > 0) & (lout > rout)) | ((mono < 0) & (lout < rout))
        g = _gain_given_output(lg, lh, lout, p) + \
            _gain_given_output(rg, rh, rout, p)
        if p["use_penalty"] and mono != 0:
            g = g * q[sk.P_PEN]
        g = np.where(violate, NEG_INF, g)
    else:
        g = _leaf_gain(lg, lh, lc, po, p) + _leaf_gain(rg, rh, rc, po, p)
    return np.where(ok, g, NEG_INF).astype(F32)


def _params(hp, mono_on):
    ps = hp.path_smooth
    return dict(
        l1=F32(hp.lambda_l1), l2=F32(hp.lambda_l2),
        min_data=F32(hp.min_data_in_leaf),
        min_hess=F32(hp.min_sum_hessian_in_leaf),
        max_delta=F32(hp.max_delta_step), path_smooth=F32(ps),
        inv_ps=F32(1) / F32(ps) if ps > 0 else F32(0), mono=mono_on,
        use_penalty=mono_on and hp.monotone_penalty > 0,
        simple=hp.lambda_l1 == 0 and hp.max_delta_step <= 0 and ps <= 0)


def _better(a, b):
    """(gain, index) a beats b: greater gain, then lower index."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _group_bases(tot, lanes):
    """The group's scan: inclusive sums by shuffles up 1, 2, 4, ... lanes
    (each lane adds the value `off` lanes below, all lanes at once), then
    each lane's exclusive base, the inclusive sum one lane below."""
    v = tot.copy()
    off = 1
    while off < lanes:
        u = v.copy()
        u[off:] = v[off:] + v[:-off]
        v = u
        off <<= 1
    base = np.zeros_like(v)
    base[1:] = v[:-1]
    return base


def plan_select(hist, parent, fmask, feat_tbl, mono_tbl, hp):
    """The kernel's [S, N_OUT] selection, from its work split."""
    with np.errstate(all="ignore"):         # 0 / 0 and x / 0 gains
        return _plan_select(hist, parent, fmask, feat_tbl, mono_tbl, hp)


def _plan_select(hist, parent, fmask, feat_tbl, mono_tbl, hp):
    s, f, b, _ = hist.shape
    lanes = group_lanes(b)
    groups = 32 // lanes
    k = lane_bins(b, lanes)
    p = _params(hp, mono_tbl is not None)
    num_bins, m_nan = feat_tbl[:, 0], feat_tbl[:, 1] != 0
    out = np.zeros((s, sk.N_OUT), F32)
    for slot in range(s):
        q = parent[slot]
        # each lane's best: [gain, flat index, NaN-left, left sums]
        best = {(w, ln): [NEG_INF, NO_INDEX, F32(0), np.zeros(3, F32)]
                for w in range(WARPS) for ln in range(32)}
        for f_lo in range(0, f, LIST_CAP):
            listed = [j for j in range(f_lo, min(f, f_lo + LIST_CAP))
                      if fmask[slot, j] > 0 and
                      num_bins[j] - 2 - int(m_nan[j]) >= 0]
            for warp in range(WARPS):
                for e0 in range(warp * groups, len(listed),
                                WARPS * groups):
                    for grp in range(groups):
                        if e0 + grp < len(listed):
                            _scan_feature(hist[slot], listed[e0 + grp], q,
                                          num_bins, m_nan, mono_tbl, p, b,
                                          lanes, k, warp, grp, best)
        # warp argmax (any order: the comparison is total), block argmax
        warp_best = [max(((best[(w, ln)][0], best[(w, ln)][1])
                          for ln in range(32)),
                         key=lambda x: (x[0], -x[1])) for w in range(WARPS)]
        win = warp_best[0]
        for wb in warp_best[1:]:
            if _better(wb, win):
                win = wb
        o = out[slot]
        if win[0] > NEG_INF:
            holder = [v for v in best.values() if v[1] == win[1]]
            assert len(holder) == 1        # one lane holds the winner
            _, idx, nal, left = holder[0]
            bf, bt = divmod(idx, b)
            nan_pos = min(max(num_bins[bf] - 1, 0), b - 1)
            nan_s = hist[slot, bf, nan_pos] if m_nan[bf] else \
                np.zeros(3, F32)
            has = win[0] > F32(-3e38)
            o[sk.O_HAS] = F32(has)
            o[sk.O_FEAT] = F32(bf) if has else F32(-1)
            o[sk.O_BIN] = F32(bt)
            o[sk.O_NAL] = nal
            o[sk.O_LR:sk.O_LR + 3] = left
            o[sk.O_LL:sk.O_LL + 3] = left + nan_s
        else:
            # nothing above the gate: (feature 0, bin 0), ungated options
            valid = num_bins[0] - 2 - int(m_nan[0]) >= 0 and fmask[slot, 0] > 0
            nan_pos = min(max(num_bins[0] - 1, 0), b - 1)
            left = hist[slot, 0, 0]
            nan_s = hist[slot, 0, nan_pos] if m_nan[0] else np.zeros(3, F32)
            mono = int(mono_tbl[0]) if mono_tbl is not None else 0
            gr = _eval_option(*left, q, mono, p) if valid else NEG_INF
            gl = _eval_option(*(left + nan_s), q, mono, p) \
                if valid and m_nan[0] else NEG_INF
            o[sk.O_FEAT] = F32(-1)
            o[sk.O_NAL] = F32(gl >= gr)
            o[sk.O_LR:sk.O_LR + 3] = left
            o[sk.O_LL:sk.O_LL + 3] = left + nan_s
    return out


def _scan_feature(rows, j, q, num_bins, m_nan, mono_tbl, p, b, lanes, k,
                  warp, grp, best):
    """One group's step: feature j's lane totals, scan and thresholds."""
    t_lim = min(num_bins[j] - 2 - int(m_nan[j]), b - 1)
    cells = rows[j].astype(np.float64)                        # [B, 3]
    ranges = [(gl * k, min(gl * k + k, t_lim + 1)) for gl in range(lanes)]
    tot = np.zeros((lanes, 3))
    for gl, (b0, b1) in enumerate(ranges):
        for bb in range(b0, b1):                # one bin after the other
            tot[gl] = tot[gl] + cells[bb]
    base = _group_bases(tot, lanes)
    mono = int(np.sign(mono_tbl[j])) if mono_tbl is not None else 0
    nan_pos = min(max(num_bins[j] - 1, 0), b - 1)
    for gl, (b0, b1) in enumerate(ranges):
        if b0 >= b1:
            continue
        run = base[gl].copy()
        pref = np.zeros((b1 - b0, 3), F32)
        for n, bb in enumerate(range(b0, b1)):
            run = run + cells[bb]
            pref[n] = run.astype(F32)                 # rounded once
        lg, lh, lc = pref[:, 0], pref[:, 1], pref[:, 2]
        gr = _eval_option(lg, lh, lc, q, mono, p)
        gl_ = np.full_like(gr, NEG_INF)
        comb = gr
        if m_nan[j]:
            nan_s = rows[j, nan_pos]
            gl_ = _eval_option(lg + nan_s[0], lh + nan_s[1], lc + nan_s[2],
                               q, mono, p)
            # torch.maximum keeps NaN
            comb = np.where(np.isnan(gr) | np.isnan(gl_), F32(np.nan),
                            np.maximum(gr, gl_))
        st = best[(warp, grp * lanes + gl)]
        for n in range(b1 - b0):                  # strict >: first wins
            if comb[n] > q[sk.P_MIN_SHIFT] and comb[n] > st[0]:
                st[:] = [comb[n], j * b + b0 + n, F32(gl_[n] >= gr[n]),
                         pref[n].copy()]


# ---- inputs

def _case(b, case, seed=0):
    """(hist, find_best_splits_kernel args after hist, hp kwargs, monotone
    kwargs) of one case, numpy, at B = b bins: S = 8 slots, F = 7 features
    (1 and 4 with a NaN bin, 4 and 6 with fewer bins than B), 30% of the
    cells zero (equal gains over runs of empty bins, across lanes too),
    80% feature masks, slot 3 empty and slot 5 with zero gradients (no
    threshold above the gate)."""
    r = np.random.RandomState(seed * 1000 + b)
    num_bins = np.full(_F, b, np.int32)
    num_bins[4] = max(2, b // 2 + 1)
    num_bins[6] = max(2, b - 3)
    mnan = np.zeros(_F, bool)
    mnan[[1, 4]] = True
    is_cat = np.zeros(_F, bool)
    hist = np.stack([r.randn(_S, _F, b), r.rand(_S, _F, b) * 2.0,
                     r.randint(1, 40, (_S, _F, b)).astype(float)], -1)
    hist[..., 0] += 0.6 * np.linspace(-1.0, 1.0, b)       # a signal
    hist *= (r.rand(_S, _F, b, 1) > 0.3)
    for j in range(_F):
        hist[:, j, num_bins[j]:] = 0.0
    if case == "ties":
        hist[:, 3] = hist[:, 1]                  # features 1 and 3 equal
        num_bins[3], mnan[3] = num_bins[1], True
    if case == "nan_gain":
        # zero hessian and gradient at the low bins of every feature:
        # 0 / 0 gains (lambda_l2 0), and on feature 1 a NaN-left option
        # that is finite beside a NaN NaN-right one
        hist[:, :, :max(1, b // 4), :2] = 0.0
    if case == "wide":
        # a 1M-row hessian sum in one cell beside cells near 1e-9
        hist[..., 1] = np.where(r.rand(_S, _F, b) < 0.5, 1e-9, hist[..., 1])
        hist[:, :, 0, 1] = 1.0e6
        hist[:, :, min(2, b - 1), 0] = 3.0e5
    hist[3] = 0.0
    hist[5, :, :, 0] = 0.0
    hist = hist.astype(np.float32)
    tot = hist[:, 0].sum(1)
    for j in range(1, _F):                    # every feature sums to tot
        last = max(num_bins[j] - 2, 0)        # in its last non-NaN bin
        hist[:, j, last] += (tot - hist[:, j].sum(1)).astype(np.float32)
    tot = hist[:, 0].sum(1, dtype=np.float64).astype(np.float32)
    if case == "nonfinite":
        # rows with an inf or a NaN cell: inf and NaN prefix sums
        hist[4, 2, 3, 0] = np.inf
        hist[6, 3, 5, 1] = np.nan
        hist[2, 5, 0, 2] = -np.inf
    fmask = (r.rand(_S, _F) < 0.8).astype(np.float32)
    fmask[:, 1] = 1.0
    fmask[1] = 1.0
    if case == "ties":
        fmask[:, 3] = 1.0
    if case == "junk_masked":
        fmask[[3, 5], 0] = 0.0
    if case == "junk_categorical":
        is_cat[0] = True
    hp = dict(min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3)
    if case == "nan_gain":
        hp.update(min_data_in_leaf=0, min_sum_hessian_in_leaf=0.0,
                  lambda_l2=0.0)
    if case in ("ties", "junk_masked", "wide"):
        mnan[0] = case != "ties"
    args = (tot[:, 0], tot[:, 1], tot[:, 2],
            (r.randn(_S) * 0.1).astype(np.float32), num_bins, mnan, is_cat,
            fmask)
    mono = {}
    if case in ("mono", "mono_penalty"):
        hp.update(has_monotone=True,
                  monotone_penalty=1.5 if case == "mono_penalty" else 0.0)
        m = np.zeros(_F, np.int32)
        m[0], m[1], m[4] = 1, -1, 1
        mono = dict(monotone=m,
                    cons_min=-r.uniform(0.05, 0.5, _S).astype(np.float32),
                    cons_max=r.uniform(0.05, 0.5, _S).astype(np.float32),
                    depth=r.randint(0, 6, _S).astype(np.int32))
    return hist, args, hp, mono


def _run(b, case):
    hist, args, hp, mono = _case(b, case)
    hp = SplitHyperParams(**hp)
    targs = tuple(map(torch.as_tensor, args))
    tables = sk.pack_inputs(*targs, hp, **{
        k: torch.as_tensor(v) for k, v in mono.items()})
    want = sk.find_best_splits_kernel_ref(torch.as_tensor(hist), *tables,
                                          hp).numpy()
    got = plan_select(hist, *(None if t is None else t.numpy()
                              for t in tables), hp)
    sel = slice(sk.O_HAS, sk.O_NAL + 1)
    np.testing.assert_array_equal(got[:, sel], want[:, sel])
    sums = slice(sk.O_LR, sk.O_LL + 3)
    assert np.array_equal(got[:, sums].view(np.int32),
                          want[:, sums].view(np.int32)), \
        np.abs(got[:, sums] - want[:, sums]).max()
    np.testing.assert_array_equal(got[:, sk.O_LL + 3:], 0.0)
    return got, want, hist, tables


@pytest.mark.parametrize("b", _WIDTHS)
@pytest.mark.parametrize("case", ["plain", "mono"])
def test_plan_matches_ref(b, case):
    got, _, _, _ = _run(b, case)
    assert got[:, sk.O_HAS].sum() >= 4                 # real splits
    # the empty slot and the flat one select (feature 0, bin 0)
    assert (got[[3, 5], sk.O_FEAT] == -1).all()
    assert (got[[3, 5], sk.O_BIN] == 0).all()


@pytest.mark.parametrize("b", [16, 256])
@pytest.mark.parametrize("case", ["junk_masked", "junk_categorical"])
def test_plan_junk_slot(b, case):
    got, want, hist, tables = _run(b, case)
    parent, fmask, feat_tbl, _ = (t.numpy() if t is not None else None
                                  for t in tables)
    assert (fmask[[3, 5], 0] == 0).all()       # feature 0 masked off there
    for slot in (3, 5):
        assert got[slot, sk.O_FEAT] == -1 and got[slot, sk.O_BIN] == 0
        # both options -inf on a masked feature: -inf >= -inf
        assert got[slot, sk.O_NAL] == 1
        np.testing.assert_array_equal(got[slot, sk.O_LR:sk.O_LR + 3],
                                      hist[slot, 0, 0])


@pytest.mark.parametrize("b", [15, 64, 256])
def test_plan_equal_gains_go_to_the_lower_feature(b):
    got, _, _, tables = _run(b, "ties")
    # features 1 and 3 hold the same row, unmasked in every slot, so
    # neither can win alone; a tie goes to feature 1
    assert (got[:, sk.O_FEAT] != 3).all()
    assert (got[:, sk.O_FEAT] == 1).any()


@pytest.mark.parametrize("b", [16, 256])
def test_plan_nan_gains(b):
    hist, args, hp, _ = _case(b, "nan_gain")
    hp = SplitHyperParams(**hp)
    tables = sk.pack_inputs(*map(torch.as_tensor, args), hp)
    parent = tables[0].numpy()
    p = _params(hp, False)
    # some threshold has a NaN NaN-right gain beside a finite NaN-left one
    pref = np.cumsum(hist.astype(np.float64), 2).astype(np.float32)
    nan_s = hist[:, 1, b - 1]
    with np.errstate(all="ignore"):
        gr = np.stack([_eval_option(*pref[s_, 1].T, parent[s_], 0, p)
                       for s_ in range(_S)])
        gl = np.stack([_eval_option(*(pref[s_, 1] + nan_s[s_]).T,
                                    parent[s_], 0, p) for s_ in range(_S)])
    assert (np.isnan(gr) & np.isfinite(gl)).any()
    _run(b, "nan_gain")


@pytest.mark.parametrize("b", [64, 256])
def test_plan_monotone_penalty(b):
    got, _, _, tables = _run(b, "mono_penalty")
    assert tables[3] is not None and (tables[0].numpy()[:, sk.P_PEN] >
                                      0).all()
    assert got[:, sk.O_HAS].sum() >= 4


@pytest.mark.parametrize("b", [16, 256])
def test_plan_nonfinite_cells(b):
    got, _, hist, _ = _run(b, "nonfinite")
    assert not np.isfinite(hist).all()
    assert got[:, sk.O_HAS].sum() >= 4


@pytest.mark.parametrize("b", [16, 255, 256])
def test_plan_wide_magnitudes(b):
    got, _, hist, _ = _run(b, "wide")
    h = hist[..., 1]
    assert h.max() >= 1e6 and h[h > 0].min() <= 1e-9
    assert got[:, sk.O_HAS].sum() >= 4
