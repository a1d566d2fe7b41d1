"""Batched best-first tree growth with per-pass-sized histograms (PyTorch).

Port of the serial path of lightgbm_tpu/learner/grower_mxu.py. The first
ceil(log2(L)) growth passes run at doubling frontier capacities S_p =
2^(p+1); a bridge pass at full capacity and fix-up passes finish leaves
that did not split on schedule. With overshoot (growth_overshoot >= 1) the
tree is overgrown to ~overshoot*num_leaves leaves and then pruned back by
replaying the reference's strict best-first order over the recorded gains
(serial_tree_learner.cpp:159-210).

Each pass routes every row through the previous pass's split tables and
builds the new frontier's histograms, then scans splits, commits the top
candidates and packs the next tables. The histogram backend (the JAX
package's hist_backend, resolved before growth) picks how: "mxu" sweeps
with the fused kernel, or route_rows + build_histograms_auto where the
reference takes its two-kernel branch (histogram_mxu.fits_v2); "pallas"
routes with per-slot counts and builds with the slot-grouped scatter
kernel (histogram_pallas); "scatter" routes the same way and builds with
the segment-sum oracle (histogram.py). In the quantized posture all three
give bit-identical histograms. Only the smaller child of a fresh split gets
a kernel slot; the larger sibling is parent minus smaller
(serial_tree_learner.cpp:311-326). With packed4 the bin matrix is 4-bit
packed (histogram_mxu.pack_bins_4bit) and every kernel reads the nibbles;
the trees are the same.

With quantized_grad (the reference's use_quantized_grad) the tree grows
on stochastically rounded int8 gradients (histogram_mxu.quantize_gradients,
keyed per tree), whose integer histograms are scaled back to gradient
units; after the prune every leaf is refit from exact per-node sums of the
unquantized gradients (the node_sums kernel), so quantization perturbs the
split search only.

Where the JAX package had lax.cond / while_loop / fori_loop this runs
Python loops with host syncs for the loop conditions. Not ported: psum
(distributed), EFB, forced splits, CEGB, monotone and interaction
constraints, per-node feature sampling, extra_trees; boosting/gbdt.py
refuses the params that need them.
"""

from __future__ import annotations

import math
import time
import types
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..utils.log import Log
from . import histogram
from .grower import TreeArrays, _init_tree
from .histogram_mxu import (build_histograms_auto, fits_v2, fused_route_hist,
                            fused_row_block, node_sums, node_values,
                            pack_route_tables, quantize_gradients,
                            route_rows, unpack_bins_4bit)
from .histogram_pallas import build_histograms_scatter
from .split import BestSplits, SplitHyperParams, find_best_splits, leaf_output

__all__ = ["autotune_hist_backend", "grow_tree_mxu", "growth_plan"]

HIST_BACKENDS = ("mxu", "pallas", "scatter")

# the reference's default full-width fix-up frontier (its LGBM_TPU_SFIX)
_S_FIX = 512


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


def _kernel_cap(s: int) -> int:
    """Histogram-kernel slot capacity for a pass scanning `s` slots with
    sibling subtraction: the all-fresh bulk needs s/2 (one slot per smaller
    child), plus slack for stale pairs (leaves split later than the pass
    that scanned them need both children built, 2 slots)."""
    return min(s, s // 2 + 8)


def autotune_hist_backend(bins, *, num_slots: int, bmax: int,
                          num_features: int = 0, quantized: bool = True,
                          const_hess: float = 0.0):
    """One-shot on-device histogram-backend measurement (hist_backend=
    auto), as the JAX package's: build one frontier histogram at the
    dominant frontier width with the mxu kernel (build_histograms_auto)
    and the slot-grouped scatter kernel, on the real bin matrix with
    synthetic gradients and slots (linspace(-127, 127), rounded when
    quantized; slot = row % num_slots), and time the second call of each —
    the first builds the kernels and warms them. Returns (choice,
    timings_ms). A backend that raises times as +inf; if both do, the
    choice is mxu."""
    n = bins.shape[0]
    dev = bins.device
    g = torch.linspace(-127.0, 127.0, n, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    if quantized:
        g, h = torch.round(g).to(torch.int8), ones.to(torch.int8)
    else:
        g, h = g * 1e-2, ones
    slot = (torch.arange(n, dtype=torch.int32, device=dev) % num_slots) \
        .to(torch.int32)
    kw = dict(num_slots=num_slots, bmax=bmax, num_features=num_features,
              quantized=quantized, const_hess=const_hess)

    def _mxu():
        return build_histograms_auto(bins, g, h, ones, slot, **kw)

    def _pallas():
        return build_histograms_scatter(bins, g, h, ones, slot, **kw)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    for name, fn in (("mxu", _mxu), ("pallas", _pallas)):
        try:
            fn()                                  # build + warm
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            timings[name] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:
            Log.warning("hist_backend autotune: %s backend failed (%s)",
                        name, exc)
            timings[name] = float("inf")
    choice = min(timings, key=timings.get)
    if timings[choice] == float("inf"):
        choice = "mxu"
    return choice, timings


def growth_plan(*, num_leaves: int, overshoot: float = 0.0,
                tail_split_cap: int = 0, hist_subtraction: bool = True,
                bridge_gate: float = 0.0):
    """Static growth schedule (same as the JAX package's growth_plan):
    doubling pass capacities, fix-up capacities and the bridge gate."""
    over = overshoot if overshoot and overshoot >= 1.0 else 0.0
    if over:
        tail_split_cap = 0
    L_g = int(math.ceil(num_leaves * over)) if over else num_leaves
    m_pad = _round_up(2 * L_g, 128)
    s_max = L_g + 1
    schedule = []
    s_p = 1
    while s_p < s_max and len(schedule) < 32:
        schedule.append(min(max(2 * s_p, 2), s_max))
        s_p *= 2
    if over:
        s_fix = min(_S_FIX, s_max)
        sk_fix = s_fix if hist_subtraction else None
    elif tail_split_cap <= 0:
        s_fix = min(64, s_max)
        sk_fix = _kernel_cap(s_fix) if hist_subtraction else None
    else:
        s_fix = min(s_max, max(16, 2 * tail_split_cap))
        sk_fix = _kernel_cap(s_fix) if hist_subtraction else None
    k_fix = max(1, s_fix // 2)
    if over and bridge_gate > 0:
        gate_leaves = max(int(bridge_gate * L_g), num_leaves)
    else:
        gate_leaves = None

    def m_cap_of(s_p):
        # pass p holds < 2*S_p node ids: route against a table that wide
        return min(m_pad, _round_up(max(2 * s_p, 2), 128))

    return types.SimpleNamespace(
        over=over, L_g=L_g, m_pad=m_pad, s_max=s_max, schedule=schedule,
        s_fix=s_fix, sk_fix=sk_fix, k_fix=k_fix, gate_leaves=gate_leaves,
        m_cap_of=m_cap_of, tail_split_cap=tail_split_cap)


class _GrowState(NamedTuple):
    tree: TreeArrays
    row_node: torch.Tensor     # [N] i32
    tbl: torch.Tensor          # [m_pad, 8] i32 route table of the last pass
    member: torch.Tensor       # [m_pad, W] i32 categorical left sets
    slot_nodes: torch.Tensor   # [s_max] i32 node id per scan slot (m = none)
    best: BestSplits           # per-NODE arrays [m1]
    done: bool
    parent_hist: torch.Tensor  # [P, F*B*3] parent scan rows, pair-indexed
    pair_parent: torch.Tensor  # [P] i32 parent's scan slot (-1 = stale)
    pair_sleft: torch.Tensor   # [P] bool smaller child is the left one
    pair_kstart: torch.Tensor  # [P] i32 first kernel slot of the pair


def _set_dropping(base: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """base.at[idx].set(vals) with out-of-range indices dropped (the JAX
    scatter semantics the reference relies on)."""
    out = base.clone()
    keep = (idx >= 0) & (idx < base.shape[0])
    out[idx[keep].to(torch.int64)] = vals[keep]
    return out


def _prune_to_best_first(tree: TreeArrays, row_node: torch.Tensor, *,
                         num_leaves: int, m_grow: int
                         ) -> Tuple[TreeArrays, torch.Tensor]:
    """Replay the reference's strict best-first growth order over an
    OVERGROWN tree's recorded split gains, keep the winning num_leaves-1
    splits, compact, and move rows to their nearest kept-leaf ancestor.
    The replay is a short sequential loop over <= 2*L nodes: it runs on
    the host (numpy f32, first-index argmax as the JAX package's)."""
    dev = row_node.device
    m1g = m_grow + 1
    mf = 2 * num_leaves - 1
    mf1 = mf + 1
    left = tree.left.cpu().numpy().astype(np.int64)
    right = tree.right.cpu().numpy().astype(np.int64)
    parent = tree.parent.cpu().numpy().astype(np.int64)
    gains = np.where(left >= 0, tree.gain.cpu().numpy(),
                     np.float32(-np.inf)).astype(np.float32)

    avail = np.full(m1g, -np.inf, np.float32)
    avail[0] = gains[0]
    sel = np.zeros(m1g, bool)
    for _ in range(num_leaves - 1):
        j = int(np.argmax(avail))
        ok = avail[j] > -np.inf
        sel[j] |= ok
        avail[j] = -np.inf
        cl = min(max(int(left[j]), 0), m_grow) if ok else m_grow
        cr = min(max(int(right[j]), 0), m_grow) if ok else m_grow
        avail[cl] = gains[cl] if cl < m_grow else -np.inf
        avail[cr] = gains[cr] if cr < m_grow else -np.inf

    # kept iff every proper ancestor was selected (pointer doubling)
    par = np.clip(parent, 0, m_grow)
    ids = np.arange(m1g)
    is_root = ids == 0
    ptr = np.where(is_root, ids, par)
    acc = np.where(is_root, True, sel[par])
    for _ in range(max(1, (m1g - 1).bit_length())):
        acc = acc & acc[ptr]
        ptr = ptr[ptr]
    kept = acc & (is_root | (parent >= 0))
    final_leaf = kept & ~sel
    # rows ascend to the nearest kept-leaf ancestor
    nxt = np.where(final_leaf | is_root, ids, par)
    for _ in range(max(1, (m1g - 1).bit_length())):
        nxt = nxt[nxt]
    new_id = np.cumsum(kept) - 1

    sel_d = torch.as_tensor(sel, device=dev)
    kept_d = torch.as_tensor(kept, device=dev)
    dst = torch.as_tensor(new_id[kept], device=dev)
    new_id_d = torch.as_tensor(new_id, device=dev)
    par_d = torch.as_tensor(par, device=dev)

    def compact(arr, fill):
        out = torch.full((mf1,) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=dev)
        out[dst] = arr[kept_d]
        return out

    def child_new(c):
        cc = c.to(torch.int64).clamp(0, m_grow)
        return torch.where(sel_d & (c >= 0), new_id_d[cc], -1) \
            .to(torch.int32)

    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    parent_new = torch.where(tree.parent >= 0, new_id_d[par_d], -1) \
        .to(torch.int32)
    pruned = TreeArrays(
        split_feature=compact(torch.where(sel_d, tree.split_feature, -1), -1),
        threshold_bin=compact(torch.where(sel_d, tree.threshold_bin, 0), 0),
        default_left=compact(sel_d & tree.default_left, False),
        is_cat=compact(sel_d & tree.is_cat, False),
        cat_bitset=compact(torch.where(sel_d[:, None], tree.cat_bitset, 0), 0),
        left=compact(child_new(tree.left), -1),
        right=compact(child_new(tree.right), -1),
        parent=compact(parent_new, -1),
        leaf_value=compact(tree.leaf_value, 0.0),
        sum_grad=compact(tree.sum_grad, 0.0),
        sum_hess=compact(tree.sum_hess, 0.0),
        count=compact(tree.count, 0.0),
        gain=compact(torch.where(sel_d, tree.gain, zero_f), 0.0),
        depth=compact(tree.depth, 0),
        is_leaf=compact(torch.as_tensor(final_leaf, device=dev), False),
        num_nodes=torch.tensor(int(kept.sum()), dtype=torch.int32,
                               device=dev),
        num_leaves=torch.tensor(int(final_leaf.sum()), dtype=torch.int32,
                                device=dev))
    # per-row lookup of the compacted kept-leaf id (ids are f32-exact)
    composed = torch.as_tensor(new_id[nxt].astype(np.float32), device=dev)
    row_new = node_values(row_node, composed).to(torch.int32)
    return pruned, row_new


def grow_tree_mxu(bins: torch.Tensor, grad: torch.Tensor,
                  hess: torch.Tensor, cnt_weight: torch.Tensor,
                  feature_mask: torch.Tensor, num_bins: torch.Tensor,
                  missing_is_nan: torch.Tensor, is_cat_feat: torch.Tensor,
                  *, num_leaves: int, max_depth: int, hp: SplitHyperParams,
                  bmax: int, tail_split_cap: int = 0,
                  hist_subtraction: bool = True, overshoot: float = 0.0,
                  bridge_gate: float = 0.0, const_hessian: float = 0.0,
                  quantized_grad: bool = False,
                  rng_key: Optional[torch.Tensor] = None,
                  packed4: bool = False, hist_backend: str = "mxu",
                  partition_impl: str = "auto"
                  ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree. Returns (TreeArrays, row_node [N] i32: each row's
    leaf node id). Same contract and same trees as the JAX package's
    grow_tree_mxu (serial mode) with the same arguments.

    bins: [N, F] uint8; grad/hess/cnt_weight: [N] f32; feature_mask: [F];
    num_bins: [F] i32; missing_is_nan, is_cat_feat: [F] bool; all on one
    device. const_hessian != 0: per-row hessians are const x cnt_weight
    and the kernels drop the hessian channel. quantized_grad: grow on
    quantized gradients drawn under rng_key (a key of lightgbm_tpu_torch.
    rng; None = PRNGKey(0)), then refit the leaves exactly. packed4: bins
    are [N, ceil(F/2)] 4-bit packed (histogram_mxu.pack_bins_4bit), F taken
    from num_bins. hist_backend: "mxu", "pallas" or "scatter" (module
    docstring) — a resolved backend, never "auto", which the booster
    resolves first (autotune_hist_backend); partition_impl: the pallas
    backend's partition_rows impl."""
    if hist_backend not in HIST_BACKENDS:
        raise ValueError(f"grow_tree_mxu needs a resolved hist_backend, one "
                         f"of {HIST_BACKENDS}; got {hist_backend!r} (the "
                         "booster resolves 'auto' before growth)")
    dev = bins.device
    n = bins.shape[0]
    f = int(num_bins.shape[0]) if packed4 else bins.shape[1]
    nf_packed = f if packed4 else 0
    plan = growth_plan(num_leaves=num_leaves, overshoot=overshoot,
                       tail_split_cap=tail_split_cap,
                       hist_subtraction=hist_subtraction,
                       bridge_gate=bridge_gate)
    over, L_g, m_pad, s_max = plan.over, plan.L_g, plan.m_pad, plan.s_max
    tail_split_cap = plan.tail_split_cap
    m = 2 * L_g - 1
    m1 = m + 1
    k_top = L_g - 1
    w_cat = (bmax + 31) // 32
    P_all = (s_max + 1) // 2 + 2   # pair-state capacity (subtraction)
    ch = const_hessian
    quant = quantized_grad
    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)

    def ifull(size, v):
        return torch.full((size,), v, dtype=torch.int32, device=dev)

    def farange(size):
        return torch.arange(size, dtype=torch.int32, device=dev)

    root_c = torch.sum(cnt_weight)
    if quant:
        # the JAX package's key schedule: a fixed fold, then the bits of
        # sum(grad), so each iteration's rounding noise differs (the sum
        # stays on the device: no host sync)
        qkey = rng_key if rng_key is not None else rng.PRNGKey(0, dev)
        qkey = rng.fold_in(rng.fold_in(qkey, 6271),
                           torch.sum(grad).view(torch.int32))
        g_q, h_q, gscale, hscale = quantize_gradients(
            grad, None if ch else hess, qkey)
        h_grad = g_q.to(torch.int8)
        # const hessian: the kernels never read the hessian channel
        h_hess = h_grad if h_q is None else h_q.to(torch.int8)
        hist_scale = torch.stack([gscale, hscale, torch.ones_like(gscale)])
        # histogram-consistent root sums (exact integer sums x scale), so
        # right = parent - left stays consistent
        root_g = torch.sum(h_grad, dtype=torch.int64).to(torch.float32) * \
            gscale
        root_h = root_c * ch if ch else \
            torch.sum(h_hess, dtype=torch.int64).to(torch.float32) * hscale
    else:
        h_grad, h_hess = grad, hess
        root_g = torch.sum(grad)
        root_h = root_c * ch if ch else torch.sum(hess)
    root_val = leaf_output(root_g, root_h, hp.lambda_l1, hp.lambda_l2,
                           hp.max_delta_step)
    tree0 = _init_tree(m, root_g, root_h, root_c, root_val,
                       bitset_words=w_cat, device=dev)
    zf = torch.zeros(m1, dtype=torch.float32, device=dev)
    best0 = BestSplits(
        gain=ninf.expand(m1).clone(), feature=ifull(m1, -1),
        threshold_bin=ifull(m1, 0),
        default_left=torch.zeros(m1, dtype=torch.bool, device=dev),
        left_grad=zf, left_hess=zf, left_count=zf, left_output=zf,
        right_output=zf,
        cat_bitset=torch.zeros((m1, w_cat), dtype=torch.int64, device=dev))
    feat_tbl = torch.stack([num_bins.to(torch.int32),
                            missing_is_nan.to(torch.int32)], dim=1) \
        .contiguous()

    def sweep(row_node, tbl, member, nslots, m_cap=None):
        """Route rows through the previous pass's tables and build the
        frontier histograms. mxu: fused sweep where the reference takes
        its fused kernel, else route_rows + build_histograms_auto. pallas
        and scatter: route_rows with per-slot counts, then the scatter
        kernel over the slot partition, or the segment-sum oracle."""
        if m_cap is not None and m_cap < m_pad:
            tbl = tbl[:m_cap]
            member = member[:m_cap]
        if hist_backend != "mxu":
            rn, rs, cts = route_rows(bins, row_node, tbl, member, feat_tbl,
                                     num_features=nf_packed,
                                     emit_counts=True, num_slots=nslots)
            if hist_backend == "pallas":
                h = build_histograms_scatter(
                    bins, h_grad, h_hess, cnt_weight, rs, num_slots=nslots,
                    bmax=bmax, num_features=nf_packed, quantized=quant,
                    const_hess=ch, slot_counts=cts,
                    partition_impl=partition_impl)
            else:
                ub = unpack_bins_4bit(bins, f) if packed4 else bins
                h = histogram.build_histograms(ub, h_grad, h_hess, rs,
                                               cnt_weight, num_slots=nslots,
                                               bmax=bmax)
                if ch:
                    # const x count, as the kernel backends' channel drop
                    h[..., 1] = h[..., 2] * ch
        elif fits_v2(nslots, f, bmax, quant,
                     row_block=fused_row_block(nslots, f, bmax, ch, quant),
                     const_hess=ch):
            h, rn = fused_route_hist(bins, h_grad, h_hess, cnt_weight,
                                     row_node, tbl, member, feat_tbl,
                                     num_slots=nslots, bmax=bmax,
                                     const_hess=ch, quantized=quant,
                                     num_features=nf_packed)
        else:
            rn, rs = route_rows(bins, row_node, tbl, member, feat_tbl,
                                num_features=nf_packed)
            h = build_histograms_auto(bins, h_grad, h_hess, cnt_weight, rs,
                                      num_slots=nslots, bmax=bmax,
                                      const_hess=ch, quantized=quant,
                                      num_features=nf_packed)
        if quant:
            h = h * hist_scale   # integer sums -> gradient units
        return h, rn

    def one_pass(s, st: _GrowState, k_cap=None, sk_next=None, m_cap=None,
                 sk_self=None) -> _GrowState:
        """One growth pass at scan capacity `s`; sk_next is the kernel-slot
        capacity of the NEXT pass (selection is throttled so committed
        splits' children fit it)."""
        tree, best = st.tree, st.best
        sn = st.slot_nodes[:s].to(torch.int64)
        if sk_next is None:
            sk_next = _kernel_cap(min(2 * s, s_max)) if hist_subtraction \
                else min(2 * s, s_max)

        if hist_subtraction:
            # build only the slots assigned by the previous pass (smaller
            # siblings + both children of stale parents) ...
            sk = sk_self if sk_self is not None else _kernel_cap(s)
            kern, row_node = sweep(st.row_node, st.tbl, st.member, sk,
                                   m_cap=m_cap)
            # ... and assemble the full scan tensor: slot s of pair i = s//2
            # is kern[ks_i] (smaller side), parent_hist[i] - kern[ks_i]
            # (larger side of a fresh pair) or kern[ks_i + 1] (other side
            # of a stale pair); kernel slots outside [0, sk) read zeros
            npairs = (s + 1) // 2
            ks = st.pair_kstart[:npairs]
            stale = st.pair_parent[:npairs] < 0
            sl = st.pair_sleft[:npairs]
            kern_z = torch.cat([kern.reshape(sk, -1),
                                torch.zeros_like(kern[:1].reshape(1, -1))])
            sides = torch.arange(s, device=dev)
            pi = sides // 2
            is_small = (sides % 2 == 0) == sl[pi]
            st_i = stale[pi]
            ks_i = ks[pi].to(torch.int64)

            def kidx(k):
                return torch.where((k >= 0) & (k < sk), k, sk)

            small_rows = kern_z[kidx(ks_i)]
            stale2 = kern_z[kidx(torch.where(st_i & (ks_i >= 0), ks_i + 1,
                                             -1))]
            large = st.parent_hist[pi] - small_rows
            hist = torch.where(is_small[:, None], small_rows,
                               torch.where(st_i[:, None], stale2, large)) \
                .reshape(s, f, bmax, 3)
        else:
            hist, row_node = sweep(st.row_node, st.tbl, st.member, s,
                                   m_cap=m_cap)

        slot_fmask = feature_mask[None, :].expand(s, f)
        bs = find_best_splits(
            hist, tree.sum_grad[sn], tree.sum_hess[sn], tree.count[sn],
            tree.leaf_value[sn], num_bins, missing_is_nan, is_cat_feat,
            slot_fmask, hp)
        best = BestSplits(*[_set_dropping(getattr(best, fld), sn,
                                          getattr(bs, fld))
                            for fld in BestSplits._fields])

        # ---- choose splits: top-budget by gain; children fit next pass
        eligible = tree.is_leaf & torch.isfinite(best.gain) & (best.gain > 0)
        if max_depth > 0:
            eligible &= tree.depth < max_depth
        gains = torch.where(eligible[:m], best.gain[:m], ninf)
        budget = L_g - int(tree.num_leaves)
        if k_cap is None:
            k_cap = min(k_top, s)   # children fill the next pass (2*s)
        k_allowed = min(k_cap, budget)
        if tail_split_cap > 0:
            # hybrid growth: once fewer leaves remain than candidates the
            # commit order matters — throttle and re-rank
            n_elig = int(torch.sum(gains > ninf))
            if n_elig >= budget:
                k_allowed = min(k_allowed, tail_split_cap)
        # top_k with ties broken lower index first, as lax.top_k does
        top_vals, top_idx = torch.sort(gains, descending=True, stable=True)
        top_vals, top_idx = top_vals[:k_top], top_idx[:k_top]
        take = (torch.arange(k_top, device=dev) < k_allowed) & \
            torch.isfinite(top_vals)
        ssn = _set_dropping(ifull(m1, -1), sn, farange(s))
        ssn[m] = -1
        if hist_subtraction:
            # fresh parents cost 1 kernel slot (smaller child only), stale
            # parents 2 (both children built)
            cand_fresh = ssn[top_idx] >= 0
            cumcost = torch.cumsum(torch.where(cand_fresh, 1, 2), dim=0)
            take &= cumcost <= sk_next
        split_mask = torch.zeros(m1, dtype=torch.bool, device=dev)
        split_mask[top_idx] = take
        split_mask[m] = False
        k = int(torch.sum(split_mask))

        # ---- apply splits
        order = (torch.cumsum(split_mask.to(torch.int32), dim=0) - 1) \
            .to(torch.int32)
        child_l = torch.where(split_mask, tree.num_nodes + 2 * order, m) \
            .to(torch.int32)
        child_r = torch.where(split_mask, tree.num_nodes + 2 * order + 1, m) \
            .to(torch.int32)
        rg = tree.sum_grad - best.left_grad
        rh = tree.sum_hess - best.left_hess
        rc = tree.count - best.left_count
        feat = best.feature
        fclip = feat.to(torch.int64).clamp(0, f - 1)
        sm2 = split_mask[:, None]
        new_tree = tree._replace(
            split_feature=torch.where(split_mask, feat, tree.split_feature),
            threshold_bin=torch.where(split_mask, best.threshold_bin,
                                      tree.threshold_bin),
            default_left=torch.where(split_mask, best.default_left,
                                     tree.default_left),
            is_cat=torch.where(split_mask, is_cat_feat[fclip], tree.is_cat),
            cat_bitset=torch.where(sm2, best.cat_bitset, tree.cat_bitset),
            left=torch.where(split_mask, child_l, tree.left),
            right=torch.where(split_mask, child_r, tree.right),
            gain=torch.where(split_mask, best.gain, tree.gain),
            is_leaf=tree.is_leaf & ~split_mask,
            num_nodes=tree.num_nodes + 2 * k,
            num_leaves=tree.num_leaves + k)
        # children of the committed splits (unsplit nodes write nowhere;
        # the JAX package parks those writes in the scratch node m)
        cl = child_l[split_mask].to(torch.int64)
        cr = child_r[split_mask].to(torch.int64)

        def scat(arr, lv, rv):
            out = arr.clone()
            out[cl] = lv[split_mask]
            out[cr] = rv[split_mask]
            return out

        nodes = farange(m1)
        neg1 = ifull(m1, -1)
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
        ninf_m1 = ninf.expand(m1)
        best = best._replace(gain=scat(best.gain, ninf_m1, ninf_m1))

        # ---- scan slots for the children (find_best_splits ordering)
        slot_l = torch.where(split_mask, 2 * order, -1)
        slot_r = torch.where(split_mask, 2 * order + 1, -1)
        slot_nodes = _set_dropping(ifull(s_max, m), slot_l, child_l)
        slot_nodes = _set_dropping(slot_nodes, slot_r, child_r)

        # ---- kernel slots + pair bookkeeping for the next pass
        parent_hist, pair_parent = st.parent_hist, st.pair_parent
        pair_sleft, pair_kstart = st.pair_sleft, st.pair_kstart
        if hist_subtraction:
            fresh_node = ssn >= 0
            small_left = best.left_count <= rc
            cost_node = torch.where(split_mask,
                                    torch.where(fresh_node, 1, 2), 0)
            kstart = (torch.cumsum(cost_node, dim=0) - cost_node) \
                .to(torch.int32)
            route_l = torch.where(~fresh_node | small_left, kstart, -1)
            route_r = torch.where(~fresh_node, kstart + 1,
                                  torch.where(small_left, -1, kstart))
            pidx = torch.where(split_mask, order, P_all)
            pair_parent = _set_dropping(
                ifull(P_all, -1), pidx, torch.where(fresh_node, ssn, -1))
            pair_sleft = _set_dropping(
                torch.ones(P_all, dtype=torch.bool, device=dev), pidx,
                fresh_node & small_left | ~fresh_node)
            pair_kstart = _set_dropping(ifull(P_all, -1), pidx, kstart)
            # carry the fresh pairs' parent scan rows into the next pass
            # (stale pairs keep zero rows, never read)
            hist_z = torch.cat([hist.reshape(s, -1),
                                torch.zeros_like(hist[:1].reshape(1, -1))])
            pp = pair_parent.to(torch.int64)
            parent_hist = hist_z[torch.where((pp >= 0) & (pp < s), pp, s)]
        else:
            route_l, route_r = slot_l, slot_r
        slot_of_node = ifull(m1, -1)
        slot_of_node[cl] = route_l[split_mask].to(torch.int32)
        slot_of_node[cr] = route_r[split_mask].to(torch.int32)

        # ---- pack the split tables; the NEXT pass's sweep routes rows
        # through them (the final flush after the loops applies the last
        # pass's tables — routing is idempotent)
        tbl, member = pack_route_tables(
            split_mask, fclip, best.threshold_bin, best.default_left,
            new_tree.is_cat, child_l, child_r, slot_of_node,
            new_tree.cat_bitset, m_pad)

        done = k == 0 or int(new_tree.num_leaves) >= L_g
        return _GrowState(new_tree, row_node, tbl, member, slot_nodes, best,
                          done, parent_hist, pair_parent, pair_sleft,
                          pair_kstart)

    # initial tables: nothing split, the root (node 0) sits in kernel slot
    # 0, so the first sweep is an identity route + a root histogram. Pair 0
    # of the first pass is the root, built as a "stale" pair so its
    # histogram comes straight from kernel slot 0
    slot0 = ifull(m1, -1)
    slot0[0] = 0
    zb = torch.zeros(m1, dtype=torch.bool, device=dev)
    tbl0, member0 = pack_route_tables(
        zb, ifull(m1, 0), ifull(m1, 0), zb, zb, ifull(m1, m), ifull(m1, m),
        slot0, torch.zeros((m1, w_cat), dtype=torch.int64, device=dev),
        m_pad)
    slot_nodes0 = ifull(s_max, m)
    slot_nodes0[0] = 0
    kstart0 = ifull(P_all, -1)
    kstart0[0] = 0
    state = _GrowState(
        tree0, torch.zeros(n, dtype=torch.int32, device=dev), tbl0, member0,
        slot_nodes0, best0, False,
        torch.zeros((P_all if hist_subtraction else 1,
                     f * bmax * 3 if hist_subtraction else 1),
                    dtype=torch.float32, device=dev),
        ifull(P_all, -1), torch.ones(P_all, dtype=torch.bool, device=dev),
        kstart0)

    # ---- unrolled doubling schedule
    for s_p in plan.schedule:
        if not state.done:
            state = one_pass(s_p, state, m_cap=plan.m_cap_of(s_p))
    if plan.gate_leaves is not None and \
            int(state.tree.num_leaves) >= plan.gate_leaves:
        state = state._replace(done=True)
    # ---- bridge pass at full capacity, then fix-ups for the leftovers
    if plan.schedule and not state.done:
        state = one_pass(s_max, state, k_cap=plan.k_fix,
                         sk_next=plan.sk_fix)
    it = len(plan.schedule) + 1
    while not state.done and it < L_g:
        state = one_pass(plan.s_fix, state, k_cap=plan.k_fix,
                         sk_next=plan.sk_fix, sk_self=plan.sk_fix)
        it += 1

    # ---- epilogue: flush the routing of the last pass's splits (sweeps
    # route at the START of a pass), then prune to best-first
    row_node, _ = route_rows(bins, state.row_node, state.tbl, state.member,
                             feat_tbl, num_features=nf_packed)
    tree = state.tree
    if over:
        tree, row_node = _prune_to_best_first(
            tree, row_node, num_leaves=num_leaves, m_grow=m)
    if quant:
        # exact leaf refit from the unquantized gradients (reference closed
        # form, feature_histogram.hpp:737); path smoothing pulls toward the
        # parent's growth-time (quantized) output, as in the JAX package
        nn = tree.leaf_value.shape[0]
        sums = node_sums(row_node, grad, hess, cnt_weight, num_nodes=nn)
        pout = tree.leaf_value[tree.parent.to(torch.int64).clamp(0, nn - 1)]
        ex_val = leaf_output(sums[:, 0], sums[:, 1], hp.lambda_l1,
                             hp.lambda_l2, hp.max_delta_step, hp.path_smooth,
                             sums[:, 2], pout)
        lf = tree.is_leaf
        tree = tree._replace(
            leaf_value=torch.where(lf, ex_val, tree.leaf_value),
            sum_grad=torch.where(lf, sums[:, 0], tree.sum_grad),
            sum_hess=torch.where(lf, sums[:, 1], tree.sum_hess),
            count=torch.where(lf, sums[:, 2], tree.count))
    return tree, row_node
