"""Leaf-output renewal: a per-leaf percentile re-fit for the L1 family.

Port of lightgbm_tpu/learner/renew.py (reference
RegressionL1loss::RenewTreeOutput and friends, regression_objective.hpp;
called from serial_tree_learner.cpp:721-758). Every leaf's value becomes
a weighted percentile of the residuals (label - score) of its rows, for
all leaves at once: the rows are sorted by residual, then stably by node,
and each node's segment is searched for the first row whose cumulative
weight reaches pct x the node's total weight. Plain torch on the device
(sorts, cumulative sums, scatter reductions), with no read back to the
host; the JAX package's version is XLA glue with no Pallas kernel.

Quantile convention: the smallest residual whose cumulative weight
reaches pct x the leaf's total weight (the reference's weighted
PercentileFun; for unweighted data the reference interpolates, so the two
differ by at most one residual step there).
"""

from __future__ import annotations

import torch

from .grower import TreeArrays

__all__ = ["renew_tree_output"]


def renew_tree_output(tree: TreeArrays, row_node: torch.Tensor,
                      score: torch.Tensor, label: torch.Tensor,
                      weight: torch.Tensor, pct: float) -> TreeArrays:
    """The tree with each leaf's value replaced by the pct-percentile of
    its rows' residuals. row_node: [N] each row's leaf node id; weight:
    [N] f32 per-row weight (the sample's count x the data weight; a row of
    weight 0 counts nowhere)."""
    m1 = tree.leaf_value.shape[0]
    n = row_node.shape[0]
    dev = row_node.device
    residual = label - score
    # rows of weight 0 go to the scratch node m1 - 1
    node = torch.where(weight > 0, row_node.to(torch.int64), m1 - 1)
    # rows grouped by node, residuals ascending inside each group
    o1 = torch.sort(residual, stable=True).indices
    o2 = torch.sort(node[o1], stable=True).indices
    perm = o1[o2]
    s_node = node[perm]
    s_resid = residual[perm]
    cum_w = torch.cumsum(weight[perm], 0)

    ids = torch.arange(m1, dtype=torch.int64, device=dev)
    seg_start = torch.searchsorted(s_node, ids)
    seg_end = torch.searchsorted(s_node, ids, right=True)
    cum_before = torch.where(
        seg_start > 0, cum_w[(seg_start - 1).clamp(min=0)], 0.0)
    # each node's total weight from the same cumulative sums (a scatter
    # add's order would vary from run to run on the card)
    total_w = torch.where(seg_end > seg_start,
                          cum_w[(seg_end - 1).clamp(min=0)] - cum_before,
                          0.0)
    target = pct * total_w
    reach = (cum_w - cum_before[s_node]) >= target[s_node] - 1e-12
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    pos = torch.where(reach, rows, n)
    first = torch.full((m1,), n, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, s_node, pos, reduce="amin")
    leaf_pct = s_resid[first.clamp(0, n - 1)]
    ok = (tree.split_feature < 0) & (total_w > 0)
    return tree._replace(leaf_value=torch.where(ok, leaf_pct,
                                                tree.leaf_value))
