"""Device tree traversal for scoring binned rows.

Port of lightgbm_tpu/learner/predict.py (predict_binned_tree,
leaf_index_tree; reference Tree::Predict with NumericalDecision /
CategoricalDecision, include/LightGBM/tree.h:335-412) and of
lightgbm_tpu/boosting/fused.py stacked_score_traj, the valid-score
trajectory of a block of stacked trees. Inputs are BINNED values (a valid
set is quantized with the training set's mappers), so every decision is
an integer compare.

On CUDA tensors each function is one launch of the hand-written kernel
csrc/predict_binned.cu (a thread walks its row through the K trees in
turn, no host sync); on CPU tensors the plain versions run, the JAX
formulation in torch (`_traverse_ref`: every row one level a step until
all sit on a leaf). Leaf ids are integers and each score is the same
sequence of f32 adds, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .grower import TreeArrays
from .histogram_mxu import _check, _on_cpu, count_launch

__all__ = ["predict_binned_tree", "leaf_index_tree", "stacked_score_traj",
           "predict_binned_tree_ref", "leaf_index_tree_ref",
           "stacked_score_traj_ref", "stacked_leaf_nodes"]


def _traverse_ref(tree: TreeArrays, bins: torch.Tensor,
                  num_bins: torch.Tensor,
                  missing_is_nan: torch.Tensor) -> torch.Tensor:
    """[N] int64 leaf node id of each row in one tree (the JAX package's
    _traverse, lightgbm_tpu/learner/predict.py:25-58): a categorical node
    sends a row left iff its bin's bit is set (word bin // 32, clamped to
    the last word as the JAX gather clamps); a numerical node sends the
    NaN bin of a missing_is_nan feature the default_left way, any other
    bin left iff bin <= threshold_bin."""
    n = bins.shape[0]
    f = num_bins.shape[0]
    w = tree.cat_bitset.shape[-1]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    while bool((tree.split_feature[node] >= 0).any()):
        feat = tree.split_feature[node].to(torch.int64)
        internal = feat >= 0
        fc = feat.clamp(0, f - 1)
        binv = bins[rows, fc].to(torch.int64)
        is_nan_bin = missing_is_nan[fc] & (binv == num_bins[fc] - 1)
        word = torch.clamp(binv // 32, max=w - 1)
        in_set = ((tree.cat_bitset[node, word] >> (binv % 32)) & 1) == 1
        go_left = torch.where(
            tree.is_cat[node], in_set,
            torch.where(is_nan_bin, tree.default_left[node],
                        binv <= tree.threshold_bin[node]))
        nxt = torch.where(go_left, tree.left[node], tree.right[node])
        node = torch.where(internal, nxt.to(torch.int64), node)
    return node


def _tree_at(stacked: TreeArrays, i: int) -> TreeArrays:
    return TreeArrays(*[t[i] for t in stacked])


def stacked_score_traj_ref(stacked: TreeArrays, score0, bins, num_bins,
                           missing_is_nan, *, leaves: bool = False):
    """Plain version of stacked_score_traj (and, with leaves=True, also
    the [K, N] int32 leaf node ids)."""
    k = stacked.leaf_value.shape[0]
    score = score0
    traj, nodes = [], []
    for i in range(k):
        tree = _tree_at(stacked, i)
        node = _traverse_ref(tree, bins, num_bins, missing_is_nan)
        vals = tree.leaf_value[node]
        score = vals if score is None else score + vals
        traj.append(score)
        nodes.append(node.to(torch.int32))
    traj = torch.stack(traj)
    if leaves:
        return traj[-1], traj, torch.stack(nodes)
    return traj[-1], traj


def _launch(stacked: TreeArrays, score0, bins, num_bins, missing_is_nan,
            leaves: bool):
    k, m1 = stacked.split_feature.shape
    n, f = bins.shape
    words = stacked.cat_bitset.shape[-1]
    dev = bins.device
    _check(bins, "bins", torch.uint8, (n, f))
    _check(num_bins, "num_bins", torch.int32, (f,))
    _check(missing_is_nan, "missing_is_nan", torch.bool, (f,))
    if score0 is not None:
        _check(score0, "score0", torch.float32, (n,))
    fields = {}
    for name, dtype, shape in (
            ("split_feature", torch.int32, (k, m1)),
            ("threshold_bin", torch.int32, (k, m1)),
            ("default_left", torch.bool, (k, m1)),
            ("is_cat", torch.bool, (k, m1)),
            ("cat_bitset", torch.int64, (k, m1, words)),
            ("left", torch.int32, (k, m1)), ("right", torch.int32, (k, m1)),
            ("leaf_value", torch.float32, (k, m1))):
        t = getattr(stacked, name).contiguous()
        _check(t, name, dtype, shape)
        fields[name] = t
    if not 0 < words:
        raise ValueError("cat_bitset: no words")
    traj = torch.empty((k, n), dtype=torch.float32, device=dev)
    leaf = torch.empty((k, n), dtype=torch.int32, device=dev) \
        if leaves else None
    _cuda.call("predict_binned", dev, bins, fields["split_feature"],
               fields["threshold_bin"], fields["default_left"],
               fields["is_cat"], fields["cat_bitset"], fields["left"],
               fields["right"], fields["leaf_value"], num_bins,
               missing_is_nan, score0, traj, leaf, n, f, k, m1, words)
    count_launch("predict_binned")
    return traj, leaf


def stacked_score_traj(stacked: TreeArrays, score0: torch.Tensor, bins,
                       num_bins, missing_is_nan
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final score [N], trajectory [K, N] f32): the K stacked trees
    ([K, ...] TreeArrays, leaf values already shrunk) scored over the [N,
    F] uint8 bins in turn from score0, one f32 add a tree; point j is the
    score after tree j, what j + 1 per-iteration valid updates leave (the
    JAX package's stacked_score_traj). One kernel launch on the card."""
    if _on_cpu(bins, score0, num_bins, missing_is_nan,
               stacked.split_feature):
        return stacked_score_traj_ref(stacked, score0, bins, num_bins,
                                      missing_is_nan)
    traj, _ = _launch(stacked, score0, bins, num_bins, missing_is_nan,
                      leaves=False)
    return traj[-1], traj


def stacked_leaf_nodes(stacked: TreeArrays, bins, num_bins, missing_is_nan,
                       score0: Optional[torch.Tensor] = None):
    """(trajectory [K, N] f32, leaf node ids [K, N] int32) of the stacked
    trees: stacked_score_traj with the leaf ids it walked to (score0 None:
    the trajectory starts at the first tree's leaf values)."""
    if _on_cpu(bins, num_bins, missing_is_nan, stacked.split_feature):
        _, traj, nodes = stacked_score_traj_ref(
            stacked, score0, bins, num_bins, missing_is_nan, leaves=True)
        return traj, nodes
    return _launch(stacked, score0, bins, num_bins, missing_is_nan,
                   leaves=True)


def _stack1(tree: TreeArrays) -> TreeArrays:
    return TreeArrays(*[t.unsqueeze(0) for t in tree])


def predict_binned_tree_ref(tree: TreeArrays, bins, num_bins,
                            missing_is_nan) -> torch.Tensor:
    return tree.leaf_value[_traverse_ref(tree, bins, num_bins,
                                         missing_is_nan)]


def predict_binned_tree(tree: TreeArrays, bins, num_bins,
                        missing_is_nan) -> torch.Tensor:
    """[N] leaf values of one tree over [N, F] uint8 bins."""
    if _on_cpu(bins, num_bins, missing_is_nan, tree.split_feature):
        return predict_binned_tree_ref(tree, bins, num_bins, missing_is_nan)
    traj, _ = _launch(_stack1(tree), None, bins, num_bins, missing_is_nan,
                      leaves=False)
    return traj[0]


def _leaf_rank(tree: TreeArrays, node: torch.Tensor) -> torch.Tensor:
    """Leaf index of leaf node ids: leaves counted in node-id order (the
    order tree.py writes them in)."""
    is_leaf = tree.split_feature < 0
    rank = torch.cumsum(is_leaf.to(torch.int32), 0) - 1
    return rank[node.to(torch.int64)].to(torch.int32)


def leaf_index_tree_ref(tree: TreeArrays, bins, num_bins,
                        missing_is_nan) -> torch.Tensor:
    return _leaf_rank(tree, _traverse_ref(tree, bins, num_bins,
                                          missing_is_nan))


def leaf_index_tree(tree: TreeArrays, bins, num_bins,
                    missing_is_nan) -> torch.Tensor:
    """[N] int32 leaf index (0..num_leaves-1 in node-id order) of each row
    (predict_leaf_index)."""
    if _on_cpu(bins, num_bins, missing_is_nan, tree.split_feature):
        return leaf_index_tree_ref(tree, bins, num_bins, missing_is_nan)
    _, leaf = _launch(_stack1(tree), None, bins, num_bins, missing_is_nan,
                      leaves=True)
    return _leaf_rank(tree, leaf[0])
