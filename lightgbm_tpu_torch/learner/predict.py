"""Device tree traversal for scoring binned rows.

Port of lightgbm_tpu/learner/predict.py (predict_binned_tree,
leaf_index_tree; reference Tree::Predict with NumericalDecision /
CategoricalDecision, include/LightGBM/tree.h:335-412) and of
lightgbm_tpu/boosting/fused.py stacked_score_traj, the valid-score
trajectory of a block of stacked trees. Inputs are BINNED values (a valid
set is quantized with the training set's mappers), so every decision is
an integer compare.

With k trees an iteration (num_class > 1) a block's stacked trees are [K,
num_class, ...] and the scores [N, num_class]: stacked_score_traj adds
each class's tree into its own column, the trajectory [K, N, num_class]
(the JAX package's stacked_score_traj(num_class=...)), and
class_score_add adds one tree into one class's column (the per-iteration
valid update, the JAX package's score.at[:, cls].add(...)).

On CUDA tensors each function is one launch of the hand-written kernel
csrc/predict_binned.cu (no host sync: a CTA packs the trees into 16-byte
node records in shared memory, a thread walks one (row, tree) pair, and a
thread a row adds the leaf values in tree order onto the previous point;
in class mode into the class's column); on CPU tensors the plain versions
run, the JAX formulation in torch (`_traverse_ref`: every row one level a
step until all sit on a leaf). Leaf ids are integers and each score is
the same sequence of f32 adds, so kernel and plain version agree bit for
bit.

Bundled-matrix mode (efb=, an efb.EfbDev; the JAX package's
_traverse(efb=)): the bins are the bundled [N, Fb] training matrix, and a
node's feature reads its bundle column, decoded through the plan's loc
table to the original local bin (efb.route_bins); the trees stay in
original features. DART's and RF's re-predictions and rollback read the
training matrix so; validation matrices stay unbundled. Its launches count
as predict_binned_efb (predict_binned_class_efb in class mode).

Bins are uint8, or uint16 at max_bin > 256 (the kernel's wide mode, in
every mode above; its launches count with "_wide"): valid scores, DART's
re-prediction and RF at wide bins.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..efb import route_bins
from . import _cuda
from .grower import TreeArrays
from .histogram_mxu import _check, _on_cpu, count_launch, gather_bins

__all__ = ["predict_binned_tree", "leaf_index_tree", "stacked_score_traj",
           "class_score_add", "predict_binned_tree_ref",
           "leaf_index_tree_ref", "stacked_score_traj_ref",
           "class_score_add_ref", "stacked_leaf_nodes"]


def _traverse_ref(tree: TreeArrays, bins: torch.Tensor,
                  num_bins: torch.Tensor,
                  missing_is_nan: torch.Tensor, efb=None) -> torch.Tensor:
    """[N] int64 leaf node id of each row in one tree (the JAX package's
    _traverse, lightgbm_tpu/learner/predict.py:25-58): a categorical node
    sends a row left iff its bin's bit is set (word bin // 32, clamped to
    the last word as the JAX gather clamps); a numerical node sends the
    NaN bin of a missing_is_nan feature the default_left way, any other
    bin left iff bin <= threshold_bin. efb: bins are bundled, each bin
    decoded by efb.route_bins."""
    f = num_bins.shape[0]
    w = tree.cat_bitset.shape[-1]
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    while bool((tree.split_feature[node] >= 0).any()):
        feat = tree.split_feature[node].to(torch.int64)
        internal = feat >= 0
        fc = feat.clamp(0, f - 1)
        binv = route_bins(bins, fc, efb) if efb is not None \
            else gather_bins(bins, fc)
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


def _class_steps_ref(stacked: TreeArrays, score0, bins, num_bins,
                     missing_is_nan, cls0: int, efb=None):
    """[K, N, C] trajectory of K steps of G trees ([K, G, ...] stacked):
    tree g of a step adds into column cls0 + g, one f32 add."""
    k, g = stacked.leaf_value.shape[:2]
    score = score0
    traj = []
    for i in range(k):
        score = score.clone()
        for j in range(g):
            tree = TreeArrays(*[t[i, j] for t in stacked])
            vals = tree.leaf_value[_traverse_ref(tree, bins, num_bins,
                                                 missing_is_nan, efb)]
            score[:, cls0 + j] = score[:, cls0 + j] + vals
        traj.append(score)
    return torch.stack(traj)


def stacked_score_traj_ref(stacked: TreeArrays, score0, bins, num_bins,
                           missing_is_nan, *, leaves: bool = False,
                           num_class: int = 1, efb=None):
    """Plain version of stacked_score_traj (and, with leaves=True, also
    the [K, N] int32 leaf node ids)."""
    if num_class > 1:
        traj = _class_steps_ref(stacked, score0, bins, num_bins,
                                missing_is_nan, 0, efb)
        return traj[-1], traj
    k = stacked.leaf_value.shape[0]
    score = score0
    traj, nodes = [], []
    for i in range(k):
        tree = _tree_at(stacked, i)
        node = _traverse_ref(tree, bins, num_bins, missing_is_nan, efb)
        vals = tree.leaf_value[node]
        score = vals if score is None else score + vals
        traj.append(score)
        nodes.append(node.to(torch.int32))
    traj = torch.stack(traj)
    if leaves:
        return traj[-1], traj, torch.stack(nodes)
    return traj[-1], traj


def _launch(stacked: TreeArrays, score0, bins, num_bins, missing_is_nan,
            leaves: bool, num_class: int = 1, cls0: int = 0, efb=None):
    """One launch over the stacked trees: [K, ...] (num_class 1), or in
    class mode [K, G, ...] (G trees a step into columns cls0.. of the
    [N, num_class] score0); efb: the bundled-matrix mode."""
    lead = tuple(stacked.split_feature.shape[:-1])
    m1 = stacked.split_feature.shape[-1]
    k = lead[0]
    group = lead[1] if num_class > 1 else 1
    n, rs = bins.shape
    f = num_bins.shape[0]
    words = stacked.cat_bitset.shape[-1]
    dev = bins.device
    wide = bins.dtype == torch.uint16
    _check(bins, "bins", torch.uint16 if wide else torch.uint8, (n, rs))
    col = loc = None
    bb = 0
    if efb is not None:
        col, loc = efb.col_of_feat, efb.loc_table
        bb = loc.shape[1]
        _check(col, "col_of_feat", torch.int32, (f,))
        _check(loc, "loc_table", torch.int32, (f, bb))
    elif rs != f:
        raise ValueError(f"bins: {rs} columns for {f} features")
    _check(num_bins, "num_bins", torch.int32, (f,))
    _check(missing_is_nan, "missing_is_nan", torch.bool, (f,))
    if num_class > 1:
        if score0 is None or leaves or len(lead) != 2 or \
                not 0 <= cls0 <= num_class - group:
            raise ValueError("class mode: score0 [N, C], no leaf ids, "
                             "[K, G, ...] trees into columns cls0..")
        _check(score0, "score0", torch.float32, (n, num_class))
    elif score0 is not None:
        _check(score0, "score0", torch.float32, (n,))
    fields = {}
    for name, dtype, shape in (
            ("split_feature", torch.int32, lead + (m1,)),
            ("threshold_bin", torch.int32, lead + (m1,)),
            ("default_left", torch.bool, lead + (m1,)),
            ("is_cat", torch.bool, lead + (m1,)),
            ("cat_bitset", torch.int64, lead + (m1, words)),
            ("left", torch.int32, lead + (m1,)),
            ("right", torch.int32, lead + (m1,)),
            ("leaf_value", torch.float32, lead + (m1,))):
        t = getattr(stacked, name).contiguous()
        _check(t, name, dtype, shape)
        fields[name] = t
    if not 0 < words:
        raise ValueError("cat_bitset: no words")
    traj = torch.empty((k, n) if num_class == 1 else (k, n, num_class),
                       dtype=torch.float32, device=dev)
    leaf = torch.empty((k, n), dtype=torch.int32, device=dev) \
        if leaves else None
    _cuda.call("predict_binned", dev, bins, fields["split_feature"],
               fields["threshold_bin"], fields["default_left"],
               fields["is_cat"], fields["cat_bitset"], fields["left"],
               fields["right"], fields["leaf_value"], num_bins,
               missing_is_nan, score0, traj, leaf, col, loc, n, f, rs, bb, k,
               m1, words, num_class, group, cls0, int(wide))
    count_launch(("predict_binned_class" if num_class > 1
                  else "predict_binned") + ("_efb" if efb is not None else ""),
                 wide=wide)
    return traj, leaf


def stacked_score_traj(stacked: TreeArrays, score0: torch.Tensor, bins,
                       num_bins, missing_is_nan, *, num_class: int = 1,
                       efb=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final score [N], trajectory [K, N] f32): the K stacked trees
    ([K, ...] TreeArrays, leaf values already shrunk) scored over the [N,
    F] uint8 bins in turn from score0, one f32 add a tree; point j is the
    score after tree j, what j + 1 per-iteration valid updates leave (the
    JAX package's stacked_score_traj). With num_class > 1 the trees are
    [K, num_class, ...], score0 [N, num_class] and the trajectory [K, N,
    num_class]: iteration j's class-c tree adds into column c. efb: the
    bins are the bundled training matrix (module docstring). One kernel
    launch on the card."""
    if _on_cpu(bins, score0, num_bins, missing_is_nan,
               stacked.split_feature):
        return stacked_score_traj_ref(stacked, score0, bins, num_bins,
                                      missing_is_nan, num_class=num_class,
                                      efb=efb)
    traj, _ = _launch(stacked, score0, bins, num_bins, missing_is_nan,
                      leaves=False, num_class=num_class, efb=efb)
    return traj[-1], traj


def class_score_add_ref(tree: TreeArrays, score: torch.Tensor, cls: int,
                        bins, num_bins, missing_is_nan,
                        efb=None) -> torch.Tensor:
    """Plain version of class_score_add."""
    stacked = TreeArrays(*[t[None, None] for t in tree])
    return _class_steps_ref(stacked, score, bins, num_bins,
                            missing_is_nan, cls, efb)[0]


def class_score_add(tree: TreeArrays, score: torch.Tensor, cls: int, bins,
                    num_bins, missing_is_nan, efb=None) -> torch.Tensor:
    """A new [N, C] score: `score` with one tree's leaf values added into
    column cls, one f32 add (the per-iteration path's valid update with k
    trees an iteration). One launch of V's class mode on the card."""
    if _on_cpu(bins, score, num_bins, missing_is_nan, tree.split_feature):
        return class_score_add_ref(tree, score, cls, bins, num_bins,
                                   missing_is_nan, efb)
    traj, _ = _launch(TreeArrays(*[t[None, None] for t in tree]), score,
                      bins, num_bins, missing_is_nan, leaves=False,
                      num_class=score.shape[1], cls0=cls, efb=efb)
    return traj[0]


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
                            missing_is_nan, efb=None) -> torch.Tensor:
    return tree.leaf_value[_traverse_ref(tree, bins, num_bins,
                                         missing_is_nan, efb)]


def predict_binned_tree(tree: TreeArrays, bins, num_bins,
                        missing_is_nan, efb=None) -> torch.Tensor:
    """[N] leaf values of one tree over [N, F] uint8 bins (efb: the
    bundled [N, Fb] training matrix)."""
    if _on_cpu(bins, num_bins, missing_is_nan, tree.split_feature):
        return predict_binned_tree_ref(tree, bins, num_bins, missing_is_nan,
                                       efb)
    traj, _ = _launch(_stack1(tree), None, bins, num_bins, missing_is_nan,
                      leaves=False, efb=efb)
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
