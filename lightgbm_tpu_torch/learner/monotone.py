"""Monotone-constraint bound recomputation (intermediate / advanced).

Port of lightgbm_tpu/learner/monotone.py. The reference implements three
constraint methods (src/treelearner/monotone_constraints.hpp:327
LeafConstraintsBase::Create):

- ``basic`` (:463): at each monotone split, cap/floor both children at the
  midpoint of their outputs; incremental, inline in the growers.
- ``intermediate`` (:514): seed children bounds with the actual sibling
  outputs and, whenever outputs change, walk the tree to refresh the
  bounds of opposite-subtree leaves and re-find their best splits
  (GoUpToFindLeavesToUpdate :622, leaves_to_update).
- ``advanced`` (:856): additionally make bounds threshold-dependent so
  only the contiguous part of the opposite subtree constrains a leaf.

This is the JAX package's formulation, not the reference's incremental
refresh: EVERY node's bounds are recomputed from the whole tree each
leaf-wise pass, dense boolean and matmul work on [M+1, M+1] arrays
(M+1 <= ~1k), equivalent to the incremental refresh at its fixed point:

- ``intermediate``: a node in the left subtree of an increasing monotone
  split is bounded above by the MINIMUM current leaf value of the right
  subtree (and symmetrically). More conservative than the reference's
  contiguity-refined refresh, looser than ``basic``'s midpoints.
- ``advanced``: exact region adjacency. Each node is a bin-space box
  (from its ancestors' thresholds); only leaves whose boxes ADJOIN it
  along a monotone feature (touching in that feature, overlapping in all
  others) bound it. The NaN bin sits outside the numeric order, so box
  extents leave it out.

Both need leaf-wise growth (one split a pass): batched splits of adjacent
leaves could move past each other within bounds computed at pass start.
learner/grower.py enforces that. The ancestor closure's matmuls multiply
0/1 matrices: every sum is a count of at most M+1, exact in f32 (and in
TF32), so the bounds are the same bits on the CPU and the card.
"""

from __future__ import annotations

import torch

__all__ = ["recompute_bounds"]


def recompute_bounds(tree, monotone: torch.Tensor, num_bins: torch.Tensor,
                     *, method: str, missing_is_nan=None,
                     directions=None):
    """Per-node monotone output bounds from the current tree.

    Args:
      tree: TreeArrays ([M+1] arrays incl. the scratch row).
      monotone: [F] int constraint direction per feature.
      num_bins: [F] per-feature bin counts (advanced box bounds).
      method: "intermediate" | "advanced".
      missing_is_nan: [F] bool, features whose LAST bin is the NaN bin,
        left out of the advanced box extents.
      directions: monotone as a host list (read from the device when
        None); advanced skips the unconstrained features' adjacency.

    Returns:
      (cons_min, cons_max): [M+1] f32 bounds (+-inf where unconstrained).
    """
    if method not in ("intermediate", "advanced"):
        raise ValueError(f"unknown monotone method {method!r}")
    m1 = tree.parent.shape[0]
    f = monotone.shape[0]
    dev = tree.parent.device
    ids = torch.arange(m1, dtype=torch.int64, device=dev)
    par = tree.parent.to(torch.int64).clamp(0, m1 - 1)
    nonroot = tree.parent >= 0

    # parent one-hot and left/right child masks                  [m1, m1]
    P = (par[:, None] == ids[None, :]) & nonroot[:, None]
    is_leftc = (tree.left[par].to(torch.int64) == ids) & nonroot
    L0 = P & is_leftc[:, None]
    R0 = P & (~is_leftc)[:, None]

    # ancestor-or-self closure by log2 matrix squaring (parent chains
    # compose exactly because each row has a single parent)
    A = (P | (ids[:, None] == ids[None, :])).to(torch.float32)
    for _ in range(max(1, (m1 - 1).bit_length())):
        A = torch.clamp(A @ A, max=1.0)
    left_of = (A @ L0.to(torch.float32)) > 0.5               # [m1, m1]
    right_of = (A @ R0.to(torch.float32)) > 0.5

    leaf = tree.is_leaf
    val = tree.leaf_value.to(torch.float32)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    feat_j = tree.split_feature.to(torch.int64).clamp(0, f - 1)
    is_num_split = (tree.left >= 0) & ~tree.is_cat
    mono_j = torch.where(is_num_split, monotone[feat_j].to(torch.int64),
                         0)                                  # [m1]

    if method == "intermediate":
        def subtree_ext(mask, sign):
            v = torch.where(mask & leaf[:, None], sign * val[:, None], inf)
            return sign * torch.amin(v, dim=0)               # [m1] (of j)

        min_l = subtree_ext(left_of, 1.0)
        max_l = subtree_ext(left_of, -1.0)
        min_r = subtree_ext(right_of, 1.0)
        max_r = subtree_ext(right_of, -1.0)

        up = (mono_j > 0)[None, :]
        dn = (mono_j < 0)[None, :]
        cap = torch.minimum(
            torch.where(left_of & up, min_r[None, :], inf),
            torch.where(right_of & dn, min_l[None, :], inf))
        flo = torch.maximum(
            torch.where(right_of & up, max_l[None, :], -inf),
            torch.where(left_of & dn, max_r[None, :], -inf))
        return torch.amax(flo, dim=1), torch.amin(cap, dim=1)

    # ---- advanced: bin-space boxes + exact adjacency ----
    thr = tree.threshold_bin.to(torch.int64)
    cons_min = (-inf).expand(m1).clone()
    cons_max = inf.expand(m1).clone()
    top_bin = num_bins.to(torch.int64) - 1
    if missing_is_nan is not None:
        top_bin = top_bin - missing_is_nan.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # box per node: ancestors' thresholds refine the interval on their
    # split feature (right child: f > thr; left child: f <= thr)
    lo, hi = [], []
    for g in range(f):
        mask_j = (is_num_split & (feat_j == g))[None, :]
        lo.append(torch.amax(torch.where(right_of & mask_j,
                                         (thr + 1)[None, :], zero), dim=1))
        hi.append(torch.amin(torch.where(left_of & mask_j, thr[None, :],
                                         top_bin[g]), dim=1))

    # pairwise overlap count over features (for all-but-one tests)
    ov_cnt = torch.zeros((m1, m1), dtype=torch.int32, device=dev)
    ovs = []
    for g in range(f):
        ov_g = (lo[g][:, None] <= hi[g][None, :]) & \
            (lo[g][None, :] <= hi[g][:, None])               # [m1, m1]
        ovs.append(ov_g)
        ov_cnt = ov_cnt + ov_g.to(torch.int32)

    kleaf = leaf[None, :]
    vrow = val[None, :]
    mono = monotone.tolist() if directions is None else list(directions)
    for g in range(f):
        if mono[g] == 0:
            continue
        ov_exc = (ov_cnt == f) | ((ov_cnt == f - 1) & ~ovs[g])
        adj_above = kleaf & ov_exc & \
            (hi[g][:, None] + 1 == lo[g][None, :])           # [i, k]
        adj_below = kleaf & ov_exc & \
            (lo[g][:, None] == hi[g][None, :] + 1)
        if mono[g] > 0:
            # increasing: value(i) <= values above along g, >= values below
            cons_max = torch.minimum(cons_max, torch.amin(
                torch.where(adj_above, vrow, inf), dim=1))
            cons_min = torch.maximum(cons_min, torch.amax(
                torch.where(adj_below, vrow, -inf), dim=1))
        else:
            # decreasing: value(i) <= values below, >= values above
            cons_max = torch.minimum(cons_max, torch.amin(
                torch.where(adj_below, vrow, inf), dim=1))
            cons_min = torch.maximum(cons_min, torch.amax(
                torch.where(adj_above, vrow, -inf), dim=1))
    return cons_min, cons_max
