"""SHAP feature contributions (TreeSHAP).

Reference: Tree::PredictContrib / TreeSHAP recursion in src/io/tree.cpp
(Lundberg & Lee algorithm; `PredictContrib` path from c_api predict with
predict_contrib=true). Host NumPy implementation over HostTree — prediction
contributions are an offline/analysis path, not a training hot loop.
Output layout matches the reference: [n, (num_features + 1) * k] with the
expected value in the last slot per class.

Copy of lightgbm_tpu/shap.py for the PyTorch/CUDA port (host numpy, the
same model text gives the same contributions in both packages).
"""

from __future__ import annotations

import numpy as np

__all__ = ["tree_shap_model", "tree_shap_single"]


def _tree_expected_value(tree) -> float:
    """Weighted average of leaf values (used as the base value)."""
    w = tree.leaf_weight if tree.leaf_weight.sum() > 0 else \
        np.maximum(tree.leaf_count, 1)
    return float((tree.leaf_value * w).sum() / w.sum())


def tree_shap_single(tree, x: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate SHAP values of one tree into phi [num_features + 1]."""
    # node cover (weight reaching each node)
    ni = tree.num_leaves - 1
    if ni <= 0:
        phi[-1] += float(tree.leaf_value[0])
        return

    leaf_w = tree.leaf_weight if tree.leaf_weight.sum() > 0 else \
        np.maximum(tree.leaf_count, 1).astype(np.float64)
    internal_w = np.zeros(ni)

    def node_weight(i):
        if i < 0:
            return float(leaf_w[~i])
        if internal_w[i] == 0:
            internal_w[i] = node_weight(int(tree.left_child[i])) + \
                node_weight(int(tree.right_child[i]))
        return internal_w[i]

    node_weight(0)

    def node_value(i):
        if i < 0:
            return float(tree.leaf_value[~i])
        wl = node_weight(int(tree.left_child[i]))
        wr = node_weight(int(tree.right_child[i]))
        return (node_value(int(tree.left_child[i])) * wl +
                node_value(int(tree.right_child[i])) * wr) / (wl + wr)

    # Path-dependent TreeSHAP (EXTEND/UNWIND recursion)
    class Path:
        __slots__ = ("d", "z", "o", "w")

        def __init__(self, depth):
            self.d = np.zeros(depth, np.int32)
            self.z = np.zeros(depth)
            self.o = np.zeros(depth)
            self.w = np.zeros(depth)

    def extend(p, length, pz, po, pi):
        p.d[length] = pi
        p.z[length] = pz
        p.o[length] = po
        p.w[length] = 1.0 if length == 0 else 0.0
        for i in range(length - 1, -1, -1):
            p.w[i + 1] += po * p.w[i] * (i + 1) / (length + 1)
            p.w[i] = pz * p.w[i] * (length - i) / (length + 1)

    def unwind(p, length, path_index):
        one = p.o[path_index]
        n = p.w[length]
        for j in range(length - 1, -1, -1):
            if one != 0:
                t = p.w[j]
                p.w[j] = n * (length + 1) / ((j + 1) * one)
                n = t - p.w[j] * p.z[path_index] * (length - j) / (length + 1)
            else:
                p.w[j] = p.w[j] * (length + 1) / \
                    (p.z[path_index] * (length - j))
        for j in range(path_index, length):
            p.d[j] = p.d[j + 1]
            p.z[j] = p.z[j + 1]
            p.o[j] = p.o[j + 1]

    def unwound_sum(p, length, path_index):
        one = p.o[path_index]
        total = 0.0
        n = p.w[length]
        for j in range(length - 1, -1, -1):
            if one != 0:
                t = n * (length + 1) / ((j + 1) * one)
                total += t
                n = p.w[j] - t * p.z[path_index] * (length - j) / (length + 1)
            else:
                total += p.w[j] / (p.z[path_index] * (length - j) /
                                   (length + 1))
        return total

    max_depth = tree.num_leaves + 2

    def decide_left(i, xv) -> bool:
        f = int(tree.split_feature[i])
        v = xv[f]
        dt = int(tree.decision_type[i])
        if dt & 1:  # categorical
            if not np.isfinite(v) or v < 0:
                return False
            iv = int(v)
            c = int(tree.threshold[i])
            lo, hi = tree.cat_boundaries[c], tree.cat_boundaries[c + 1]
            word = iv // 32
            if word < hi - lo:
                return bool((int(tree.cat_threshold[lo + word]) >>
                             (iv % 32)) & 1)
            return False
        missing_t = (dt >> 2) & 3
        if np.isnan(v):
            if missing_t == 2:
                return bool(dt & 2)
            v = 0.0
        if missing_t == 1 and abs(v) <= 1e-35:
            return bool(dt & 2)
        return v <= tree.threshold[i]

    def recurse(i, xv, p, length, pz, po, pf):
        p2 = Path(max_depth)
        p2.d[:length] = p.d[:length]
        p2.z[:length] = p.z[:length]
        p2.o[:length] = p.o[:length]
        p2.w[:length] = p.w[:length]
        extend(p2, length, pz, po, pf)
        length += 1
        if i < 0:
            for j in range(1, length):
                w = unwound_sum(p2, length - 1, j)
                phi[p2.d[j]] += w * (p2.o[j] - p2.z[j]) * \
                    float(tree.leaf_value[~i])
            return
        f = int(tree.split_feature[i])
        hot = int(tree.left_child[i]) if decide_left(i, xv) \
            else int(tree.right_child[i])
        cold = int(tree.right_child[i]) if decide_left(i, xv) \
            else int(tree.left_child[i])
        w_all = node_weight(i)
        iz, io = 1.0, 1.0
        # undo previous split on same feature
        path_index = -1
        for j in range(1, length):
            if p2.d[j] == f:
                path_index = j
                break
        if path_index >= 0:
            iz = p2.z[path_index]
            io = p2.o[path_index]
            unwind(p2, length - 1, path_index)
            length -= 1
        recurse(hot, xv, p2, length, iz * node_weight(hot) / w_all, io, f)
        recurse(cold, xv, p2, length, iz * node_weight(cold) / w_all, 0.0, f)

    phi[-1] += node_value(0)
    recurse(0, x, Path(max_depth), 0, 1.0, 1.0, -1)


def tree_shap_model(model, X: np.ndarray, start_iteration: int,
                    end_iteration: int) -> np.ndarray:
    k = max(model.num_tree_per_iteration, 1)
    n, nf_x = X.shape
    nf = max(model.max_feature_idx + 1, nf_x)
    out = np.zeros((n, k, nf + 1), np.float64)
    for ti in range(start_iteration * k, end_iteration * k):
        cls = model.tree_class[ti] if ti < len(model.tree_class) else ti % k
        tree = model.trees[ti]
        for r in range(n):
            phi = np.zeros(nf + 1)
            if tree.num_leaves > 1:
                tree_shap_single(tree, X[r], phi)
            else:
                phi[-1] = float(tree.leaf_value[0])
            out[r, cls] += phi
    return out.reshape(n, k * (nf + 1)) if k > 1 else out[:, 0, :]
