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
give bit-identical histograms; with exact gradients the kernels of mxu and
pallas do (integer sums of fixed-point values under one scale per tree,
histogram_mxu.exact_scale; the root's sums take the same fixed point,
exact_sums), and the float64 oracle agrees within its rounding. Only the
smaller child of a fresh split gets
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

The split-search options of the JAX grower ride every pass: basic
monotone constraints (per-node output bounds carried through the passes
and moved to the split midpoint, clipped child outputs, and after
quantized growth the refit leaves clipped too), interaction constraints
(each node's path features; a slot may use the features of every group
that holds its whole path), feature_fraction_bynode (a per-slot mask of
the k smallest uniforms under fold_in(rng_key, pass index)) and
extra_trees (one random threshold per slot and feature under
fold_in(fold_in(rng_key, 7919), pass index)). Passes are numbered as in
the JAX package: doubling pass p is p, the bridge len(schedule), fix-up
pass `it` it + 1000; skipped passes still consume their number.
use_scan_kernel=True scans splits with the fused kernel
(split_kernel.find_best_splits_kernel) wherever it covers the pass: no
categorical features, no extra_trees.

No pass reads the device: the budget, the split count and `done` stay
device tensors, writes the JAX package parks in the scratch node m go to
pad rows that are sliced off, and a pass that finds the tree done returns
its state unchanged (the JAX package's lax.cond), so the doubling
schedule, the gate and the bridge are one fixed sequence. Only the fix-up
loop (the JAX package's while_loop) reads `done`, once before each fix-up
pass. The prune's replay is one kernel (prune.prune_best_first, the JAX
package's fori_loop). `Grower` holds these programs apart, so the fused
trainer (boosting/fused.py) can capture each in a CUDA graph;
grow_tree_mxu runs them eagerly. Not ported: psum (distributed);
boosting/gbdt.py refuses the params that need it.

Forced splits (forced=, the JAX package's grower_mxu.py:519-534,
774-865, 940-955, 1131-1141; reference ForceSplits,
serial_tree_learner.cpp:459): the root takes spec 0; a scanned node with
a spec has its best split replaced by the spec's feature and threshold,
its sums gathered from the scan tensor; such a split is taken whatever
the sign of its gain and ranks at 1e30 + gain, above every gain-chosen
one; its children take the spec's subtrees, and a node whose forced split
cannot apply (a child without rows) ends the spec's BFS there. The prune
ranks forced splits first (rank_gain). CEGB (cegb_cfg=, split and coupled
terms; the lazy term is the portable grower's): a per-(slot, feature)
gain penalty (grower.cegb_penalty) that the split scan subtracts, and
the model's feature-used flags carried from tree to tree. The split-scan
kernel K8 takes no penalty, so a CEGB pass always scans with
find_best_splits, as in the JAX package.

EFB (efb=, an efb.EfbDev; the JAX package's grower_mxu.py:392-401,
585-620, 696-753, 1025-1044, 1124-1126): `bins` is the bundled [N, Fb]
matrix, so the histograms, the sibling subtraction and the parent rows
live in bundle space ([S, Fb, Bb, 3]), and the split scan, the trees and
the feature masks in original features. With the plan's scan tables the
routing kernels run their efb_range mode and the split scan is
split_bundled.find_best_splits_bundled (efb_segmented_scan); without them
routing decodes each row's original bin through the loc table and every
pass's histogram is expanded back to original features
(efb.expand_histograms) for the unbundled scan. EFB takes the mxu sweep
whatever the hist_backend, with the JAX package's row block of 1024 (and
the route width of the original features in the expansion mode) in the
fused kernel's fit.
"""

from __future__ import annotations

import functools
import math
import time
import types
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..efb import EfbDev, _empty_to_zero, expand_histograms
from ..utils.log import Log
from . import histogram
from .grower import (CegbParams, CegbState, TreeArrays, _init_tree,
                     cegb_penalty, force_splits, forced_children, mark_used)
from .histogram_mxu import (build_histograms_auto, exact_scale, exact_sums,
                            fits_v2, fused_route_hist, fused_row_block,
                            node_sums, node_values, pack_route_tables,
                            quantize_gradients, route_rows,
                            single_prec_hess, unpack_bins_4bit)
from .histogram_pallas import build_histograms_scatter
from .prune import prune_best_first
from .split import BestSplits, SplitHyperParams, find_best_splits, leaf_output
from .split_bundled import find_best_splits_bundled
from .split_kernel import find_best_splits_kernel, kernel_supports

__all__ = ["Grower", "autotune_hist_backend", "grow_tree_mxu", "growth_plan"]

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
    choice is mxu. On the card build_histograms is itself the partition
    and the scatter kernel, so the two timings differ by noise; either
    choice grows the same trees (both sum the same integers)."""
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
    done: torch.Tensor         # [] bool: growth is over, passes are no-ops
    parent_hist: torch.Tensor  # [P, F*B*3] parent kernel-space rows, by pair
    pair_parent: torch.Tensor  # [P] i32 parent's scan slot (-1 = stale)
    pair_sleft: torch.Tensor   # [P] bool smaller child is the left one
    pair_kstart: torch.Tensor  # [P] i32 first kernel slot of the pair
    cons_min: torch.Tensor     # [m1] f32 monotone output bounds per node
    cons_max: torch.Tensor
    path_mask: torch.Tensor    # [m1, F] bool features on the node's path
    # forced splits ([m1], None without a spec, so a booster without one
    # runs no op for them): each node's spec index (-1 none), whether its
    # forced split applies, whether it was forced
    node_force: Optional[torch.Tensor]
    forced_ok: Optional[torch.Tensor]
    was_forced: Optional[torch.Tensor]
    feat_used: Optional[torch.Tensor]  # [F] bool CEGB (else None): the
    #                                    model's features used


class _TreeInputs(NamedTuple):
    """What one tree grows from, fixed through its passes."""
    grad: torch.Tensor           # [N] f32
    hess: torch.Tensor
    cnt: torch.Tensor
    feature_mask: torch.Tensor   # [F]
    rng_key: Optional[torch.Tensor]
    h_grad: torch.Tensor         # what the histograms sum (int8 quantized)
    h_hess: torch.Tensor
    hist_scale: Optional[torch.Tensor]   # [3] f32 quantized sums' scales
    hist_fixed: Optional[torch.Tensor]   # [3] i32 exact fixed point
    cegb_coupled: Optional[torch.Tensor]  # [F] f32 CEGB coupled penalty


def _set_dropping(base: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """base.at[idx].set(vals) with out-of-range indices dropped (the JAX
    scatter semantics the reference relies on): they write a pad row that
    is sliced off, so no index is selected on the host."""
    n = base.shape[0]
    i = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    out = torch.cat([base, base[:1]])
    out[i] = vals
    return out[:n]


def _expand_feature(hist_b: torch.Tensor, efb: EfbDev,
                    ff: torch.Tensor) -> torch.Tensor:
    """[S, bmax, C]: slot i's bundled histogram [S, Fb, Bb, C] expanded
    to original feature ff[i] alone, the same gather and default-mass
    reconstruction as efb.expand_histograms (equal to its [i, ff[i]]
    row), without the [S, F, bmax, C] tensor."""
    s, fb, bb, c = hist_b.shape
    ar = torch.arange(s, device=hist_b.device)
    fp = efb.flat_pos[ff]                                   # [S, bmax]
    gath = torch.gather(hist_b.reshape(s, fb * bb, c), 1,
                        fp[..., None].expand(-1, -1, c))
    h64 = hist_b.to(torch.float64)
    csum = torch.cumsum(h64, dim=2)
    total = h64[:, 0].sum(dim=1)                            # [S, C]
    col = efb.col_of_feat[ff].to(torch.int64)
    hi_s = csum[ar, col, efb.seg_hi[ff].to(torch.int64)]
    lo_s = torch.where((efb.seg_lo[ff] > 0)[:, None],
                       csum[ar, col, (efb.seg_lo[ff] - 1).clamp(min=0)
                            .to(torch.int64)], 0.0)
    dmass = _empty_to_zero(total - (hi_s - lo_s)).to(torch.float32)
    zero = torch.zeros((), dtype=hist_b.dtype, device=hist_b.device)
    out = torch.where(efb.is_valid_pos[ff][..., None], gath, zero)
    return torch.where(efb.is_default_pos[ff][..., None], dmass[:, None],
                       out)


def _select(done: torch.Tensor, old, new):
    """torch.where(done, old, new) over a state (nested named tuples of
    tensors): a pass that finds growth over leaves the state as it was,
    bit for bit, as the JAX package's lax.cond does."""
    if isinstance(old, tuple):
        return type(old)(*[_select(done, o, n) for o, n in zip(old, new)])
    if old is None or old is new:
        return new
    return torch.where(done, old, new)


def _prune_to_best_first(tree: TreeArrays, row_node: torch.Tensor, *,
                         num_leaves: int, m_grow: int, aux: Tuple = (),
                         rank_gain: Optional[torch.Tensor] = None) -> Tuple:
    """Replay the reference's strict best-first growth order over an
    OVERGROWN tree's recorded split gains, keep the winning num_leaves-1
    splits, compact, and move rows to their nearest kept-leaf ancestor.
    The replay and its closure are one kernel (prune.prune_best_first);
    the compaction writes dropped nodes to a pad row, so nothing here
    syncs. `aux`: (per-node array, fill) pairs compacted the same way and
    returned as a third element. rank_gain [m1] f32, where given, orders
    the replay in place of the gains (forced splits rank first,
    serial_tree_learner.cpp:459); the tree keeps its true gains."""
    dev = row_node.device
    mf1 = 2 * num_leaves
    sel, kept, new_id, composed = prune_best_first(
        tree.left, tree.right, tree.parent,
        tree.gain if rank_gain is None else rank_gain,
        num_leaves=num_leaves)
    final_leaf = kept & ~sel
    dst = torch.where(kept, new_id, mf1).to(torch.int64)
    par = tree.parent.to(torch.int64).clamp(0, m_grow)

    def compact(arr, fill):
        out = torch.full((mf1 + 1,) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=dev)
        out[dst] = arr
        return out[:mf1]

    def child_new(c):
        cc = c.to(torch.int64).clamp(0, m_grow)
        return torch.where(sel & (c >= 0), new_id[cc], -1).to(torch.int32)

    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    parent_new = torch.where(tree.parent >= 0, new_id[par], -1) \
        .to(torch.int32)
    pruned = TreeArrays(
        split_feature=compact(torch.where(sel, tree.split_feature, -1), -1),
        threshold_bin=compact(torch.where(sel, tree.threshold_bin, 0), 0),
        default_left=compact(sel & tree.default_left, False),
        is_cat=compact(sel & tree.is_cat, False),
        cat_bitset=compact(torch.where(sel[:, None], tree.cat_bitset, 0), 0),
        left=compact(child_new(tree.left), -1),
        right=compact(child_new(tree.right), -1),
        parent=compact(parent_new, -1),
        leaf_value=compact(tree.leaf_value, 0.0),
        sum_grad=compact(tree.sum_grad, 0.0),
        sum_hess=compact(tree.sum_hess, 0.0),
        count=compact(tree.count, 0.0),
        gain=compact(torch.where(sel, tree.gain, zero_f), 0.0),
        depth=compact(tree.depth, 0),
        is_leaf=compact(final_leaf, False),
        num_nodes=torch.sum(kept, dtype=torch.int32),
        num_leaves=torch.sum(final_leaf, dtype=torch.int32))
    # per-row lookup of the compacted kept-leaf id (ids are f32-exact)
    row_new = node_values(row_node, composed).to(torch.int32)
    if aux:
        return pruned, row_new, tuple(compact(a, fill) for a, fill in aux)
    return pruned, row_new


class Grower:
    """One configuration's tree growth, cut into programs with static
    shapes and no host sync, which a CUDA graph can capture (the fused
    trainer, boosting/fused.py) or eager code runs in turn (grow, the
    per-iteration path):

      start      the prologue: quantization or the exact fixed point, root
                 sums, the initial tables and state
      scheduled  the doubling passes, then the bridge gate and the bridge
                 pass, a fixed sequence: a pass that finds the tree done
                 leaves the state as it was (_select)
      fixup      one fix-up pass at the fix-up width, numbered pass_idx
      finish     the epilogue: the last routing flush, the prune, the
                 quantized refit

    The fix-up loop (grow) is the only code that reads the device: `done`,
    once before each fix-up pass. Settings as grow_tree_mxu's. A forced
    spec (forced=) is held here, made before any capture, and its node
    state is reset by start, so the fused trainer's graphs replay it
    tree after tree; CEGB (cegb_cfg=) takes each tree's feature-used
    flags and coupled penalties through start's cegb_state."""

    def __init__(self, bins: torch.Tensor, num_bins: torch.Tensor,
                 missing_is_nan: torch.Tensor, is_cat_feat: torch.Tensor,
                 *, num_leaves: int, max_depth: int, hp: SplitHyperParams,
                 bmax: int, monotone: Optional[torch.Tensor] = None,
                 interaction_groups: Optional[tuple] = None,
                 feature_fraction_bynode: float = 1.0,
                 tail_split_cap: int = 0, hist_subtraction: bool = True,
                 overshoot: float = 0.0, bridge_gate: float = 0.0,
                 const_hessian: float = 0.0, quantized_grad: bool = False,
                 packed4: bool = False, hist_backend: str = "mxu",
                 partition_impl: str = "auto",
                 use_scan_kernel: bool = False,
                 efb: Optional[EfbDev] = None,
                 hist_double_prec: bool = True,
                 forced: Optional[Tuple[torch.Tensor, ...]] = None,
                 cegb_cfg: Optional[CegbParams] = None):
        if hist_backend not in HIST_BACKENDS:
            raise ValueError(f"grow_tree_mxu needs a resolved hist_backend, "
                             f"one of {HIST_BACKENDS}; got {hist_backend!r} "
                             "(the booster resolves 'auto' before growth)")
        self.bins, self.num_bins = bins, num_bins
        self.missing_is_nan, self.is_cat_feat = missing_is_nan, is_cat_feat
        self.dev = dev = bins.device
        self.n = bins.shape[0]
        self.f = f = int(num_bins.shape[0]) if (packed4 or efb is not None) \
            else bins.shape[1]
        self.nf_packed = f if packed4 else 0
        # kernel-space dims: bundle columns and bins under EFB
        self.efb = efb
        self.fk = bins.shape[1] if efb is not None else f
        self.bk = efb.bundle_bmax if efb is not None else bmax
        # the routing mode: bundle ranges with the segmented scan, else the
        # loc table's decode (expansion)
        self.efb_range = efb is not None and efb.scan is not None
        self.loc_table = efb.loc_table \
            if efb is not None and efb.scan is None else None
        self.plan = plan = growth_plan(
            num_leaves=num_leaves, overshoot=overshoot,
            tail_split_cap=tail_split_cap, hist_subtraction=hist_subtraction,
            bridge_gate=bridge_gate)
        self.num_leaves, self.max_depth, self.hp = num_leaves, max_depth, hp
        self.bmax, self.monotone = bmax, monotone
        self.hist_subtraction = hist_subtraction
        self.tail_split_cap = plan.tail_split_cap
        self.ch, self.quant = const_hessian, quantized_grad
        self.double_prec = hist_double_prec
        self.hist_backend, self.partition_impl = hist_backend, partition_impl
        self.m = 2 * plan.L_g - 1
        self.m1 = self.m + 1
        self.k_top = plan.L_g - 1
        self.w_cat = (bmax + 31) // 32
        self.P_all = (plan.s_max + 1) // 2 + 2   # pair-state capacity
        self.feat_tbl = torch.stack([num_bins.to(torch.int32),
                                     missing_is_nan.to(torch.int32)],
                                    dim=1).contiguous()
        self.group_masks = None
        if interaction_groups:
            gm = np.zeros((len(interaction_groups), f), np.bool_)
            for gi, grp in enumerate(interaction_groups):
                for fi in grp:
                    if 0 <= fi < f:
                        gm[gi, fi] = True
            self.group_masks = torch.as_tensor(gm, device=dev)
        self.feature_fraction_bynode = feature_fraction_bynode
        self.k_bynode = max(1, int(round(feature_fraction_bynode * f)))
        self.use_kernel = use_scan_kernel and kernel_supports(hp)
        # forced splits: (feature, threshold bin, left spec, right spec)
        # [K] i32 each on the device, the spec tree in BFS order, held as
        # one [K, 4] table (one gather a lookup)
        self.spec = torch.stack(forced, dim=1).contiguous() \
            if forced is not None else None
        if cegb_cfg is not None and cegb_cfg.has_lazy:
            raise NotImplementedError(
                "cegb_penalty_feature_lazy runs on the portable grower")
        self.cegb = cegb_cfg
        #: the host counter of the first fix-up pass; pass it + 1000 runs
        #: while it < L_g
        self.first_fixup = len(plan.schedule) + 1
        #: the last grow()'s fix-up passes and reads of `done`
        self.last_fixups = (0, 0)

    # ---- small constructors on the device (fills: no host copies)
    def _ifull(self, size, v):
        return torch.full((size,), v, dtype=torch.int32, device=self.dev)

    def _farange(self, size):
        return torch.arange(size, dtype=torch.int32, device=self.dev)

    def _ninf(self):
        return torch.full((), float("-inf"), dtype=torch.float32,
                          device=self.dev)

    # ------------------------------------------------------------------
    def start(self, grad: torch.Tensor, hess: torch.Tensor,
              cnt_weight: torch.Tensor, feature_mask: torch.Tensor,
              rng_key: Optional[torch.Tensor] = None,
              cegb_state: Optional[CegbState] = None
              ) -> Tuple[_TreeInputs, _GrowState]:
        """The prologue: the tree's inputs and its initial state.
        cegb_state (with cegb_cfg): the booster's CegbState."""
        if (cegb_state is None) != (self.cegb is None):
            raise ValueError("cegb_state goes with cegb_cfg")
        dev, hp, ch = self.dev, self.hp, self.ch
        m, m1, w_cat, P_all = self.m, self.m1, self.w_cat, self.P_all
        ifull = self._ifull
        ninf = self._ninf()
        root_c = torch.sum(cnt_weight)
        if self.quant:
            # the JAX package's key schedule: a fixed fold, then the bits
            # of sum(grad), so each iteration's rounding noise differs
            qkey = rng_key if rng_key is not None else rng.PRNGKey(0, dev)
            qkey = rng.fold_in(rng.fold_in(qkey, 6271),
                               torch.sum(grad).view(torch.int32))
            g_q, h_q, gscale, hscale = quantize_gradients(
                grad, None if ch else hess, qkey)
            h_grad = g_q.to(torch.int8)
            # const hessian: the kernels never read the hessian channel
            h_hess = h_grad if h_q is None else h_q.to(torch.int8)
            hist_scale = torch.stack([gscale, hscale,
                                      torch.ones_like(gscale)])
            # histogram-consistent root sums (exact integer sums x scale),
            # so right = parent - left stays consistent
            root_g = torch.sum(h_grad, dtype=torch.int64) \
                .to(torch.float32) * gscale
            root_h = root_c * ch if ch else \
                torch.sum(h_hess, dtype=torch.int64).to(torch.float32) * \
                hscale
            hist_fixed = None
        else:
            # the single-precision mode's histograms sum bf16-rounded
            # hessians; the root and every backend take the same values,
            # so every node's hessian sum is its rows' (ROADMAP C15: the
            # JAX package's root sums the unrounded ones, and the larger
            # siblings, parent minus smaller, carry the difference down to
            # leaves near 0). The kernels round again: bf16 rounding is
            # idempotent, so their bits do not change
            h_hess = hess if self.double_prec or ch else \
                single_prec_hess(hess)
            h_grad, hist_scale = grad, None
            # the fixed point of every exact histogram of the tree
            hist_fixed = exact_scale(grad, h_hess, cnt_weight)
            # root sums in the same fixed point, so they are the same bits
            # on every device (an f32 torch.sum adds in another order on
            # the card than on the CPU) and right = parent - left is exact
            root_g, root_h, _ = exact_sums(grad, h_hess, cnt_weight,
                                           hist_fixed)
            if ch:
                root_h = root_c * ch
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
            cat_bitset=torch.zeros((m1, w_cat), dtype=torch.int64,
                                   device=dev))
        # initial tables: nothing split, the root (node 0) sits in kernel
        # slot 0, so the first sweep is an identity route + a root
        # histogram. Pair 0 of the first pass is the root, built as a
        # "stale" pair so its histogram comes straight from kernel slot 0
        slot0 = ifull(m1, -1)
        slot0[0].fill_(0)
        zb = torch.zeros(m1, dtype=torch.bool, device=dev)
        tbl0, member0 = pack_route_tables(
            zb, ifull(m1, 0), ifull(m1, 0), zb, zb, ifull(m1, m),
            ifull(m1, m), slot0,
            torch.zeros((m1, w_cat), dtype=torch.int64, device=dev),
            self.plan.m_pad, efb=self.efb)
        slot_nodes0 = ifull(self.plan.s_max, m)
        slot_nodes0[0].fill_(0)
        forced0 = (None, None, None)
        if self.spec is not None:
            # the root takes spec 0
            node_force0 = ifull(m1, -1)
            node_force0[0].fill_(0)
            forced0 = (node_force0, torch.zeros(m1, dtype=torch.bool,
                                                device=dev),
                       torch.zeros(m1, dtype=torch.bool, device=dev))
        kstart0 = ifull(P_all, -1)
        kstart0[0].fill_(0)
        sub = self.hist_subtraction
        state = _GrowState(
            tree0, torch.zeros(self.n, dtype=torch.int32, device=dev), tbl0,
            member0, slot_nodes0, best0,
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros((P_all if sub else 1,
                         self.fk * self.bk * 3 if sub else 1),
                        dtype=torch.float32, device=dev),
            ifull(P_all, -1),
            torch.ones(P_all, dtype=torch.bool, device=dev), kstart0,
            ninf.expand(m1).clone(), (-ninf).expand(m1).clone(),
            torch.zeros((m1, self.f) if self.group_masks is not None
                        else (1, 1), dtype=torch.bool, device=dev),
            *forced0,
            cegb_state.feat_used if cegb_state is not None else None)
        inputs = _TreeInputs(grad, hess, cnt_weight, feature_mask, rng_key,
                             h_grad, h_hess, hist_scale, hist_fixed,
                             cegb_state.coupled if cegb_state is not None
                             else None)
        return inputs, state

    def scheduled(self):
        """[(name, fn(inputs, state) -> state)]: the doubling passes (pass
        p numbered p, as in the JAX package), then "bridge": the gate and
        the bridge pass at full capacity (numbered len(schedule))."""
        plan = self.plan
        out = [(f"pass{p}", functools.partial(self._doubling, p, s_p))
               for p, s_p in enumerate(plan.schedule)]
        return out + [("bridge", self._bridge)]

    def _doubling(self, p, s_p, inputs, state):
        return self.one_pass(s_p, inputs, state, p,
                             m_cap=self.plan.m_cap_of(s_p))

    def _bridge(self, inputs, state):
        plan = self.plan
        if plan.gate_leaves is not None:
            state = state._replace(done=state.done | (
                state.tree.num_leaves >= plan.gate_leaves))
        if plan.schedule:
            state = self.one_pass(plan.s_max, inputs, state,
                                  len(plan.schedule), k_cap=plan.k_fix,
                                  sk_next=plan.sk_fix)
        return state

    def fixup(self, inputs: _TreeInputs, state: _GrowState,
              pass_idx) -> _GrowState:
        """One fix-up pass for the leaves left over; pass_idx (an int, or
        a device int32 scalar that a replayed graph advances) numbers its
        random draws: host counter it gives it + 1000."""
        plan = self.plan
        return self.one_pass(plan.s_fix, inputs, state, pass_idx,
                             k_cap=plan.k_fix, sk_next=plan.sk_fix,
                             sk_self=plan.sk_fix)

    def fixup_loop(self, is_done: Callable[[], bool],
                   run: Callable[[int], None], warm: bool = False
                   ) -> Tuple[int, int, bool]:
        """The fix-up loop, the only place growth reads the device: while
        fix-up passes are left, one read of `done` (is_done()) before each,
        and run(pass_idx) runs the pass numbered pass_idx (host counter
        + 1000, as in the JAX package) if the tree is not done. warm: the
        first pass runs even on a done tree, where it changes nothing (a
        caller that captures runs it to size its buffers). Returns (fix-up
        passes, reads of `done`, whether the warm pass ran on a done
        tree)."""
        it, reads = self.first_fixup, 0
        while it < self.plan.L_g:
            reads += 1
            done = is_done()
            if done and not warm:
                break
            run(it + 1000)
            if done:
                return it - self.first_fixup, reads, True
            warm = False
            it += 1
        return it - self.first_fixup, reads, False

    def grow(self, grad, hess, cnt_weight, feature_mask, rng_key=None,
             cegb_state=None) -> Tuple:
        """Grow one tree eagerly: start, the scheduled passes, the fix-up
        loop, finish. last_fixups: the loop's (passes, reads of `done`).
        Returns (tree, row_node); with CEGB, cegb_state's feat_used is set
        to the flags the next tree starts from (row_feat_used stays: the
        lazy term is the portable grower's)."""
        inputs, state = self.start(grad, hess, cnt_weight, feature_mask,
                                   rng_key, cegb_state)
        for _, fn in self.scheduled():
            state = fn(inputs, state)

        def run(pass_idx):
            nonlocal state
            state = self.fixup(inputs, state, pass_idx)

        passes, reads, _ = self.fixup_loop(lambda: bool(state.done), run)
        self.last_fixups = (passes, reads)
        tree, row_node = self.finish(inputs, state)
        if cegb_state is not None:
            cegb_state.feat_used = state.feat_used
        return tree, row_node

    # ------------------------------------------------------------------
    def slot_masks(self, inputs: _TreeInputs, s, sn, path_mask, pass_idx):
        """[s, F] feature mask of each scan slot (the tree's mask, bynode
        sampling, interaction groups) and the extra_trees draws."""
        f, dev, key = self.f, self.dev, inputs.rng_key
        feature_mask = inputs.feature_mask
        slot_fmask = feature_mask[None, :].expand(s, f)
        if self.feature_fraction_bynode < 1.0 and key is not None:
            u = rng.uniform(rng.fold_in(key, pass_idx), (s, f))
            u = torch.where(feature_mask[None, :] > 0, u,
                            torch.full((), float("inf"), device=dev))
            kth = torch.sort(u, dim=1).values[:, self.k_bynode - 1][:, None]
            slot_fmask = slot_fmask * (u <= kth)
        if self.group_masks is not None:
            gmask = self.group_masks
            pm = path_mask[sn]
            subset = torch.all((~pm[:, None, :]) | gmask[None, :, :], dim=2)
            allowed = (subset.to(torch.float32) @
                       gmask.to(torch.float32)) > 0
            slot_fmask = slot_fmask * (allowed | pm)
        rand_bins = None
        if self.hp.extra_trees and key is not None:
            kr = rng.fold_in(rng.fold_in(key, 7919), pass_idx)
            rand_bins = rng.randint(kr, (s, f), 0, self.bmax)
        return slot_fmask, rand_bins

    def sweep(self, inputs: _TreeInputs, row_node, tbl, member, nslots,
              m_cap=None):
        """Route rows through the previous pass's tables and build the
        frontier histograms. mxu: fused sweep where the reference takes
        its fused kernel, else route_rows + build_histograms_auto. pallas
        and scatter: route_rows with per-slot counts (for pallas per slot
        and partition chunk, which the partition takes as they are), then
        the scatter kernel over the slot partition, or the segment-sum
        oracle. EFB: the mxu sweep on bundle columns in the plan's routing
        mode, the fused kernel's fit at the JAX package's row block of
        1024 (the expansion's route side as wide as the original
        features)."""
        bins, f, bmax, ch = self.bins, self.f, self.bmax, self.ch
        quant, nfp, feat_tbl = self.quant, self.nf_packed, self.feat_tbl
        fk, bk = self.fk, self.bk
        h_grad, h_hess, cnt = inputs.h_grad, inputs.h_hess, inputs.cnt
        efb_kw = dict(loc_table=self.loc_table, efb_range=self.efb_range)
        if m_cap is not None and m_cap < self.plan.m_pad:
            tbl = tbl[:m_cap]
            member = member[:m_cap]
        dp = self.double_prec
        if self.efb is not None:
            rw, rb = (0 if self.efb_range else f), 1024
        else:
            rw, rb = 0, fused_row_block(nslots, f, bmax, ch, quant, dp)
        if self.hist_backend != "mxu" and self.efb is None:
            pallas = self.hist_backend == "pallas"
            rn, rs, cts = route_rows(bins, row_node, tbl, member, feat_tbl,
                                     num_features=nfp, emit_counts=True,
                                     num_slots=nslots, chunk_tallies=pallas)
            if pallas:
                h = build_histograms_scatter(
                    bins, h_grad, h_hess, cnt, rs, num_slots=nslots,
                    bmax=bmax, num_features=nfp, quantized=quant,
                    const_hess=ch, slot_tallies=cts,
                    partition_impl=self.partition_impl,
                    scale=inputs.hist_fixed, double_prec=dp)
            else:
                ub = unpack_bins_4bit(bins, f) if nfp else bins
                h = histogram.build_histograms(ub, h_grad, h_hess, rs, cnt,
                                               num_slots=nslots, bmax=bmax)
                if ch:
                    # const x count, as the kernel backends' channel drop
                    h[..., 1] = h[..., 2] * ch
        elif fits_v2(nslots, fk, bk, quant, route_width=rw, row_block=rb,
                     const_hess=ch, double_prec=dp):
            h, rn = fused_route_hist(bins, h_grad, h_hess, cnt, row_node,
                                     tbl, member, feat_tbl,
                                     num_slots=nslots, bmax=bk,
                                     const_hess=ch, quantized=quant,
                                     num_features=nfp,
                                     scale=inputs.hist_fixed,
                                     double_prec=dp, **efb_kw)
        else:
            rn, rs = route_rows(bins, row_node, tbl, member, feat_tbl,
                                num_features=nfp, **efb_kw)
            h = build_histograms_auto(bins, h_grad, h_hess, cnt, rs,
                                      num_slots=nslots, bmax=bk,
                                      const_hess=ch, quantized=quant,
                                      num_features=nfp,
                                      scale=inputs.hist_fixed,
                                      double_prec=dp)
        if quant:
            h = h * inputs.hist_scale   # integer sums -> gradient units
        return h, rn

    def one_pass(self, s, inputs: _TreeInputs, st: _GrowState, pass_idx,
                 k_cap=None, sk_next=None, m_cap=None, sk_self=None
                 ) -> _GrowState:
        """One growth pass at scan capacity `s`, number `pass_idx` (its
        random draws); sk_next is the kernel-slot capacity of the NEXT pass
        (selection is throttled so committed splits' children fit it). No
        host sync: the budget, the split count and `done` stay on the
        device, and writes that the JAX package parks in the scratch node
        go to pad rows. A pass on a done state returns it unchanged."""
        dev, f, bmax, hp = self.dev, self.f, self.bmax, self.hp
        m, m1, k_top, P_all = self.m, self.m1, self.k_top, self.P_all
        s_max, L_g = self.plan.s_max, self.plan.L_g
        sub = self.hist_subtraction
        ifull, farange = self._ifull, self._farange
        ninf = self._ninf()
        monotone = self.monotone
        tree, best = st.tree, st.best
        cons_min, cons_max, path_mask = st.cons_min, st.cons_max, \
            st.path_mask
        sn = st.slot_nodes[:s].to(torch.int64)
        if sk_next is None:
            sk_next = _kernel_cap(min(2 * s, s_max)) if sub \
                else min(2 * s, s_max)

        if sub:
            # build only the slots assigned by the previous pass (smaller
            # siblings + both children of stale parents) ...
            sk = sk_self if sk_self is not None else _kernel_cap(s)
            kern, row_node = self.sweep(inputs, st.row_node, st.tbl,
                                        st.member, sk, m_cap=m_cap)
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
                .reshape(s, self.fk, self.bk, 3)
        else:
            hist, row_node = self.sweep(inputs, st.row_node, st.tbl,
                                        st.member, s, m_cap=m_cap)
        efb = self.efb
        # the expansion mode scans original features; the segmented scan
        # takes the bundle-space histogram as it is (the subtraction and the
        # parent rows stay in bundle space either way)
        hist_scan = expand_histograms(hist, efb) \
            if efb is not None and efb.scan is None else hist

        slot_fmask, rand_bins = self.slot_masks(inputs, s, sn, path_mask,
                                                pass_idx)
        gp = None if self.cegb is None else cegb_penalty(
            self.cegb, tree.count[sn], f, inputs.cegb_coupled, st.feat_used)
        args = (hist_scan, tree.sum_grad[sn], tree.sum_hess[sn],
                tree.count[sn], tree.leaf_value[sn], self.num_bins,
                self.missing_is_nan, self.is_cat_feat, slot_fmask, hp)
        mono_kw = dict(monotone=monotone, cons_min=cons_min[sn],
                       cons_max=cons_max[sn], depth=tree.depth[sn]) \
            if hp.has_monotone else {}
        if self.efb_range:
            bs = find_best_splits_bundled(*args, efb, **mono_kw,
                                          rand_bins=rand_bins,
                                          gain_penalty=gp)
        elif self.use_kernel and rand_bins is None and gp is None:
            # the fused scan kernel takes no gain penalty
            bs = find_best_splits_kernel(*args, **mono_kw)
        else:
            bs = find_best_splits(*args, **mono_kw, rand_bins=rand_bins,
                                  gain_penalty=gp)
        forced_ok = st.forced_ok
        if self.spec is not None:
            bs, valid_f = force_splits(
                hist_scan, args[1:5], sn, st.node_force, self.spec, bs, hp,
                m, f, expand=functools.partial(_expand_feature, hist_scan,
                                               efb) if self.efb_range
                else None)
            forced_ok = _set_dropping(forced_ok, sn, valid_f)
            forced_ok[m].fill_(False)
        best = BestSplits(*[_set_dropping(getattr(best, fld), sn,
                                          getattr(bs, fld))
                            for fld in BestSplits._fields])

        # ---- choose splits: top-budget by gain; children fit next pass
        positive = best.gain > 0
        if self.spec is not None:
            # forced nodes split whatever the sign of their gain
            positive = positive | forced_ok
        eligible = tree.is_leaf & torch.isfinite(best.gain) & positive
        if self.max_depth > 0:
            eligible &= tree.depth < self.max_depth
        gains = torch.where(eligible[:m], best.gain[:m], ninf)
        if self.spec is not None:
            # and outrank every gain-chosen candidate (the reference's BFS
            # of forced splits comes first)
            gains = torch.where(eligible[:m] & forced_ok[:m],
                                1e30 + best.gain[:m], gains)
        budget = L_g - tree.num_leaves
        if k_cap is None:
            k_cap = min(k_top, s)   # children fill the next pass (2*s)
        k_allowed = torch.clamp(budget, max=k_cap)
        if self.tail_split_cap > 0:
            # hybrid growth: once fewer leaves remain than candidates the
            # commit order matters — throttle and re-rank
            n_elig = torch.sum(gains > ninf)
            k_allowed = torch.where(
                n_elig >= budget,
                torch.clamp(k_allowed, max=self.tail_split_cap), k_allowed)
        # top_k with ties broken lower index first, as lax.top_k does
        top_vals, top_idx = torch.sort(gains, descending=True, stable=True)
        top_vals, top_idx = top_vals[:k_top], top_idx[:k_top]
        take = (torch.arange(k_top, device=dev) < k_allowed) & \
            torch.isfinite(top_vals)
        ssn = _set_dropping(ifull(m1, -1), sn, farange(s))
        ssn[m].fill_(-1)
        if sub:
            # fresh parents cost 1 kernel slot (smaller child only), stale
            # parents 2 (both children built)
            cand_fresh = ssn[top_idx] >= 0
            cumcost = torch.cumsum(torch.where(cand_fresh, 1, 2), dim=0)
            take &= cumcost <= sk_next
        split_mask = torch.zeros(m1, dtype=torch.bool, device=dev)
        split_mask[top_idx] = take
        split_mask[m].fill_(False)
        k = torch.sum(split_mask, dtype=torch.int32)

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
            is_cat=torch.where(split_mask, self.is_cat_feat[fclip],
                               tree.is_cat),
            cat_bitset=torch.where(sm2, best.cat_bitset, tree.cat_bitset),
            left=torch.where(split_mask, child_l, tree.left),
            right=torch.where(split_mask, child_r, tree.right),
            gain=torch.where(split_mask, best.gain, tree.gain),
            is_leaf=tree.is_leaf & ~split_mask,
            num_nodes=tree.num_nodes + 2 * k,
            num_leaves=tree.num_leaves + k)
        # the children of the committed splits, each with the node that
        # split and its side: unsplit nodes point their writes at a pad
        # row (the JAX package parks them in the scratch node m), so
        # every child write below is a gather
        nodes = torch.arange(m1, dtype=torch.int64, device=dev)
        writer = torch.full((m1 + 1,), -1, dtype=torch.int64, device=dev)
        writer[torch.where(split_mask, child_l, m1).to(torch.int64)] = nodes
        writer[torch.where(split_mask, child_r, m1).to(torch.int64)] = \
            nodes + m1
        writer = writer[:m1]
        is_child = writer >= 0
        from_right = writer >= m1
        src = torch.where(from_right, writer - m1, writer).clamp(min=0)

        def scat(arr, lv, rv):
            if arr.dim() == 2:
                return torch.where(is_child[:, None], torch.where(
                    from_right[:, None], rv[src], lv[src]), arr)
            return torch.where(is_child, torch.where(from_right, rv[src],
                                                     lv[src]), arr)

        nodes32 = farange(m1)
        neg1 = ifull(m1, -1)
        d1 = tree.depth + 1
        new_tree = new_tree._replace(
            parent=scat(new_tree.parent, nodes32, nodes32),
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
        best = best._replace(gain=torch.where(is_child, ninf, best.gain))
        node_force, was_forced = st.node_force, st.was_forced
        if self.spec is not None:
            # children of an applied forced split take the spec's subtrees;
            # a node whose forced split did not apply ends the BFS there
            node_force = scat(node_force, *forced_children(
                self.spec, node_force, split_mask, forced_ok))
            was_forced = was_forced | (split_mask & forced_ok)
            forced_ok = forced_ok & ~is_child
        feat_used = st.feat_used
        if self.cegb is not None and self.cegb.has_coupled:
            feat_used = mark_used(feat_used, fclip, split_mask)
        if hp.has_monotone:
            # children's output bounds meet at the split's midpoint on the
            # side the constraint orders (the reference's basic method)
            mcf = monotone[fclip]
            mid = (best.left_output + best.right_output) * 0.5
            lmin = torch.where(mcf < 0, torch.maximum(cons_min, mid), cons_min)
            lmax = torch.where(mcf > 0, torch.minimum(cons_max, mid), cons_max)
            rmin = torch.where(mcf > 0, torch.maximum(cons_min, mid), cons_min)
            rmax = torch.where(mcf < 0, torch.minimum(cons_max, mid), cons_max)
            cons_min = scat(cons_min, lmin, rmin)
            cons_max = scat(cons_max, lmax, rmax)
        if self.group_masks is not None:
            fsel = (torch.arange(f, device=dev)[None, :] == fclip[:, None]) \
                & split_mask[:, None]
            child_pm = path_mask | fsel
            path_mask = scat(path_mask, child_pm, child_pm)

        # ---- scan slots for the children (find_best_splits ordering)
        slot_l = torch.where(split_mask, 2 * order, -1)
        slot_r = torch.where(split_mask, 2 * order + 1, -1)
        slot_nodes = _set_dropping(ifull(s_max, m), slot_l, child_l)
        slot_nodes = _set_dropping(slot_nodes, slot_r, child_r)

        # ---- kernel slots + pair bookkeeping for the next pass
        parent_hist, pair_parent = st.parent_hist, st.pair_parent
        pair_sleft, pair_kstart = st.pair_sleft, st.pair_kstart
        if sub:
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
        slot_of_node = scat(ifull(m1, -1), route_l.to(torch.int32),
                            route_r.to(torch.int32))

        # ---- pack the split tables; the NEXT pass's sweep routes rows
        # through them (the final flush after the loops applies the last
        # pass's tables — routing is idempotent)
        tbl, member = pack_route_tables(
            split_mask, fclip, best.threshold_bin, best.default_left,
            new_tree.is_cat, child_l, child_r, slot_of_node,
            new_tree.cat_bitset, self.plan.m_pad,
            bcol=efb.col_of_feat[fclip] if efb is not None else None,
            efb=efb)

        done = (k == 0) | (new_tree.num_leaves >= L_g)
        new = _GrowState(new_tree, row_node, tbl, member, slot_nodes, best,
                         st.done | done, parent_hist, pair_parent,
                         pair_sleft, pair_kstart, cons_min, cons_max,
                         path_mask, node_force, forced_ok, was_forced,
                         feat_used)
        return _select(st.done, st, new)

    def finish(self, inputs: _TreeInputs, st: _GrowState
               ) -> Tuple[TreeArrays, torch.Tensor]:
        """The epilogue: flush the routing of the last pass's splits
        (sweeps route at the START of a pass), prune to best-first, and
        refit the leaves of a quantized tree exactly."""
        hp = self.hp
        row_node, _ = route_rows(self.bins, st.row_node, st.tbl, st.member,
                                 self.feat_tbl, num_features=self.nf_packed,
                                 loc_table=self.loc_table,
                                 efb_range=self.efb_range)
        tree = st.tree
        cmin, cmax = st.cons_min, st.cons_max
        # forced splits outrank every gain-chosen split in the replay
        # order; the tree keeps their true gains
        rank = tree.gain + torch.where(st.was_forced, 1e30, 0.0) \
            if self.spec is not None else None
        if self.plan.over and self.quant and hp.has_monotone:
            tree, row_node, (cmin, cmax) = _prune_to_best_first(
                tree, row_node, num_leaves=self.num_leaves, m_grow=self.m,
                aux=((cmin, float("-inf")), (cmax, float("inf"))),
                rank_gain=rank)
        elif self.plan.over:
            tree, row_node = _prune_to_best_first(
                tree, row_node, num_leaves=self.num_leaves, m_grow=self.m,
                rank_gain=rank)
        if self.quant:
            # exact leaf refit from the unquantized gradients (reference
            # closed form, feature_histogram.hpp:737); path smoothing pulls
            # toward the parent's growth-time (quantized) output, as in the
            # JAX package
            nn = tree.leaf_value.shape[0]
            sums = node_sums(row_node, inputs.grad, inputs.hess, inputs.cnt,
                             num_nodes=nn)
            pout = tree.leaf_value[tree.parent.to(torch.int64)
                                   .clamp(0, nn - 1)]
            ex_val = leaf_output(sums[:, 0], sums[:, 1], hp.lambda_l1,
                                 hp.lambda_l2, hp.max_delta_step,
                                 hp.path_smooth, sums[:, 2], pout)
            if hp.has_monotone:
                ex_val = torch.clamp(ex_val, cmin, cmax)
            lf = tree.is_leaf
            tree = tree._replace(
                leaf_value=torch.where(lf, ex_val, tree.leaf_value),
                sum_grad=torch.where(lf, sums[:, 0], tree.sum_grad),
                sum_hess=torch.where(lf, sums[:, 1], tree.sum_hess),
                count=torch.where(lf, sums[:, 2], tree.count))
        return tree, row_node


def grow_tree_mxu(bins: torch.Tensor, grad: torch.Tensor,
                  hess: torch.Tensor, cnt_weight: torch.Tensor,
                  feature_mask: torch.Tensor, num_bins: torch.Tensor,
                  missing_is_nan: torch.Tensor, is_cat_feat: torch.Tensor,
                  *, rng_key: Optional[torch.Tensor] = None,
                  cegb_state: Optional[CegbState] = None, **settings
                  ) -> Tuple:
    """Grow one tree. Returns (TreeArrays, row_node [N] i32: each row's
    leaf node id). Same contract and same trees as the JAX package's
    grow_tree_mxu (serial mode) with the same arguments.

    bins: [N, F] uint8; grad/hess/cnt_weight: [N] f32; feature_mask: [F];
    num_bins: [F] i32; missing_is_nan, is_cat_feat: [F] bool; all on one
    device. Settings (Grower's): num_leaves, max_depth, hp (SplitHyper-
    Params), bmax; monotone: [F] int constraint per feature (with
    hp.has_monotone); interaction_groups: tuple of tuples of feature
    indices; feature_fraction_bynode < 1 and hp.extra_trees draw under
    rng_key (a key of lightgbm_tpu_torch.rng; None turns both off, as in
    the JAX package); tail_split_cap, hist_subtraction, overshoot,
    bridge_gate: the growth plan (growth_plan). const_hessian != 0:
    per-row hessians are const x cnt_weight and the kernels drop the
    hessian channel. quantized_grad: grow on quantized gradients drawn
    under rng_key (None = PRNGKey(0)), then refit the leaves exactly.
    use_scan_kernel: scan splits with the fused kernel where it covers the
    pass (module docstring). packed4: bins are [N, ceil(F/2)] 4-bit packed
    (histogram_mxu.pack_bins_4bit), F taken from num_bins. hist_backend:
    "mxu", "pallas" or "scatter" (module docstring) — a resolved backend,
    never "auto", which the booster resolves first (autotune_hist_backend);
    partition_impl: the pallas backend's partition_rows impl. efb: an
    efb.EfbDev when bins is the bundled [N, Fb] matrix (module docstring;
    num_bins and the other per-feature arrays stay original).
    hist_double_prec=False: exact histograms of bf16-rounded hessians (the
    JAX package's hist_double_prec, gpu_use_dp=false; histogram_mxu's
    single-precision mode), which also sizes the passes' kernel fit
    (fits_v2 at 4 channels). forced: the spec tree as (feature, threshold
    bin, left spec, right spec) [K] i32 tensors, BFS order, spec 0 the
    root's (GBDT._load_forced_splits). cegb_cfg (learner.grower.
    CegbParams, no lazy term) with cegb_state (learner.grower.CegbState,
    its feat_used advanced): the CEGB gain penalties. The only
    host reads are the fix-up loop's `done` (Grower.fixup_loop)."""
    return Grower(bins, num_bins, missing_is_nan, is_cat_feat,
                  **settings).grow(grad, hess, cnt_weight, feature_mask,
                                   rng_key, cegb_state)
