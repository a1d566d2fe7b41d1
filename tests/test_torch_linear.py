"""The port's leaf models (learner/linear.py) against the JAX package's.

The same hand-built tree (a categorical split on one path, a scratch row
that parents itself, as the JAX grower leaves it) and the same numpy-made
rows go through lightgbm_tpu.learner.linear and the port's plain
versions: the path masks and each leaf's features exactly, the fitted
models and their values within the tolerances stated at each test. The
kernels' plain versions are what the card's kernels are held to bit for
bit (chip_smoke.py), so the fixed-point sums are also held here to a
float64 numpy sum and to themselves on permuted rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.learner import linear as jlin
from lightgbm_tpu.learner.grower import TreeArrays as JaxTree
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.learner import linear as tlin
from tests.test_torch_one_thread import one_thread  # noqa: F401

F = 5
N = 600
M1 = 10          # 5 leaves: nodes 0..8, scratch row 9
IS_CAT = np.array([False, False, True, False, False])


def _tree() -> dict:
    """Node 0 splits feature 0; its left child 1 the categorical feature
    2, its right child 2 feature 1; node 2's left child 5 feature 4, so
    leaves 7 and 8 sit three numerical splits deep. Leaves 3, 4 (path:
    0 and the categorical 2), 6 (0, 1), 7, 8 (0, 1, 4). Row 9 is the
    scratch row, its own parent."""
    sf = np.full(M1, -1, np.int32)
    left = np.full(M1, -1, np.int32)
    right = np.full(M1, -1, np.int32)
    parent = np.full(M1, -1, np.int32)
    for node, feat, lo, hi in ((0, 0, 1, 2), (1, 2, 3, 4), (2, 1, 5, 6),
                               (5, 4, 7, 8)):
        sf[node], left[node], right[node] = feat, lo, hi
        parent[lo] = parent[hi] = node
    parent[9] = 9
    sf[9] = 3                      # scratch garbage: must not leak
    is_leaf = np.zeros(M1, bool)
    is_leaf[[3, 4, 6, 7, 8]] = True
    r = np.random.RandomState(5)
    return dict(
        split_feature=sf, threshold_bin=np.zeros(M1, np.int32),
        default_left=np.zeros(M1, bool), is_cat=sf == 2,
        cat_bitset=np.zeros((M1, 1), np.uint32), left=left, right=right,
        parent=parent,
        leaf_value=r.randn(M1).astype(np.float32),
        sum_grad=np.zeros(M1, np.float32), sum_hess=np.zeros(M1, np.float32),
        count=np.zeros(M1, np.float32), gain=np.zeros(M1, np.float32),
        depth=np.array([0, 1, 1, 2, 2, 2, 2, 3, 3, 0], np.int32),
        is_leaf=is_leaf, num_nodes=np.int32(9), num_leaves=np.int32(5))


def _rows(seed=0):
    """(raw [N, F] f32, row_node [N] i32, grad, hess, cnt): rows on the 5
    leaves; NaN values on a few rows (on model features and off them);
    out-of-bag rows; leaf 4 with one usable row (under nfeat + 1 = 2);
    feature 1 constant zero on leaf 6 (an exactly singular system at
    lambda 0)."""
    r = np.random.RandomState(seed)
    raw = r.randn(N, F).astype(np.float32)
    node = r.choice([3, 6, 7, 8], N).astype(np.int32)
    node[:3] = 4
    raw[node == 6, 1] = 0.0
    raw[5:25:4, 4] = np.nan        # a model feature of leaves 7, 8
    raw[30:40:3, 3] = np.nan       # on no leaf's model
    grad = r.randn(N).astype(np.float32)
    hess = r.uniform(0.5, 2.0, N).astype(np.float32)
    cnt = (r.uniform(size=N) > 0.2).astype(np.float32)
    cnt[0] = 1.0
    cnt[1:3] = 0.0
    return raw, node, grad, hess, cnt


def _jax_tree(d):
    return JaxTree(**{k: jnp.asarray(v) for k, v in d.items()})


def test_path_feature_masks_match_jax():
    d = _tree()
    want = np.asarray(jlin._path_feature_masks(
        _jax_tree(d), F, M1, jnp.asarray(IS_CAT)))
    got = tlin.path_feature_masks(convert.tree_arrays_from_numpy(d), F,
                                  torch.as_tensor(IS_CAT)).numpy()
    np.testing.assert_array_equal(got, want)
    # categorical feature 2 never enters, the scratch row stays empty
    assert not got[:, 2].any() and not got[9].any()
    assert got[7].tolist() == [True, True, False, False, True]


@pytest.mark.parametrize("lam", [0.0, 0.5])
@pytest.mark.parametrize("dmax", [2, 3])
def test_fit_linear_leaves_matches_jax(lam, dmax):
    """Exactly the JAX package's feature lists and kept constants; the
    solved models within 2e-4 relative + 1e-5: the JAX package sums f32
    outer products and solves in f32, the port sums fixed-point integers
    and solves in float64 (test-side float64 normal equations agree with
    the port within 1e-5). dmax 2 cuts leaves 7 and 8 to their first two
    path features (0 and 1)."""
    d = _tree()
    raw, node, grad, hess, cnt = _rows()
    want = jlin.fit_linear_leaves(
        _jax_tree(d), jnp.asarray(node), jnp.asarray(raw),
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(cnt),
        jnp.asarray(IS_CAT), jnp.float32(lam), dmax=dmax)
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = convert.linear_leaves_to_numpy(tlin.fit_linear_leaves_ref(
        convert.tree_arrays_from_numpy(d), torch.as_tensor(node),
        torch.as_tensor(raw), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.as_tensor(cnt), torch.as_tensor(IS_CAT), lam, dmax=dmax))
    np.testing.assert_array_equal(got["feat"], want["feat"])
    np.testing.assert_array_equal(got["nfeat"], want["nfeat"])
    np.testing.assert_allclose(got["const"], want["const"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["coeff"], want["coeff"], rtol=2e-4,
                               atol=1e-5)
    # leaf 4 (one usable row) keeps its constant; leaf 6 (feature 1 all
    # zero) keeps it at lambda 0 and gets coefficient 0 for it at 0.5
    assert got["nfeat"][4] == 0 and got["const"][4] == d["leaf_value"][4]
    if lam == 0.0:
        assert got["nfeat"][6] == 0
        assert got["const"][6] == d["leaf_value"][6]
    else:
        assert got["nfeat"][6] == 2 and got["coeff"][6, 1] == 0.0
    # the port's models solve the float64 normal equations of their rows
    for leaf in (7, 8):
        fs = got["feat"][leaf][got["feat"][leaf] >= 0]
        rows = (node == leaf) & (cnt > 0) & \
            ~np.isnan(raw[:, fs]).any(1)
        x = np.c_[raw[rows][:, fs], np.ones(rows.sum())].astype(np.float64)
        a = x.T @ (x * hess[rows, None].astype(np.float64))
        a[np.arange(len(fs)), np.arange(len(fs))] += lam
        sol = -np.linalg.solve(a, x.T @ grad[rows].astype(np.float64))
        np.testing.assert_allclose(got["coeff"][leaf, :len(fs)], sol[:-1],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["const"][leaf], sol[-1], rtol=1e-5,
                                   atol=1e-6)


def test_linear_gram_ref_is_order_free_and_near_float64():
    """The fixed-point sums: the same bits on permuted rows; within 1e-6
    relative of float64 numpy sums (each product's rounding is at most
    2^-(61 - lg) of the entry's bound, the f32 result's is 6e-8)."""
    d = _tree()
    raw, node, grad, hess, cnt = _rows(seed=1)
    feat = tlin.leaf_features(tlin.path_feature_masks(
        convert.tree_arrays_from_numpy(d), F, torch.as_tensor(IS_CAT)), 3)
    args = [torch.as_tensor(a) for a in (raw, node, grad, hess, cnt)]
    xthx, xtg, count = tlin.linear_gram_ref(*args, feat)
    perm = torch.as_tensor(np.random.RandomState(2).permutation(N))
    p = tlin.linear_gram_ref(*[a[perm] for a in args], feat)
    for a, b in zip((xthx, xtg, count), p):
        assert torch.equal(a, b)
    fe = feat.numpy()
    for leaf in (3, 6, 7, 8):
        act = fe[leaf] >= 0
        rows = (node == leaf) & (cnt > 0) & \
            ~np.isnan(raw[:, fe[leaf][act]]).any(1)
        x = np.zeros((rows.sum(), 4))
        x[:, :3][:, act] = raw[rows][:, fe[leaf][act]]
        x[:, 3] = 1.0
        h = hess[rows].astype(np.float64)
        want = x.T @ (x * h[:, None])
        np.testing.assert_allclose(xthx[leaf].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        g = x.T @ grad[rows].astype(np.float64)
        np.testing.assert_allclose(xtg[leaf].numpy(), g, rtol=1e-6,
                                   atol=1e-6 * np.abs(g).max())
        assert int(count[leaf]) == rows.sum()


def test_linear_gram_ref_non_finite_leaf_is_nan():
    """A leaf with an infinite hessian comes out NaN (its constant is
    kept); the other leaves are untouched."""
    d = _tree()
    raw, node, grad, hess, cnt = _rows(seed=3)
    feat = tlin.leaf_features(tlin.path_feature_masks(
        convert.tree_arrays_from_numpy(d), F, torch.as_tensor(IS_CAT)), 3)
    args = [torch.as_tensor(a) for a in (raw, node, grad, hess, cnt)]
    clean = tlin.linear_gram_ref(*args, feat)
    hess = hess.copy()
    hess[np.flatnonzero((node == 7) & (cnt > 0))[0]] = np.inf
    args[3] = torch.as_tensor(hess)
    xthx, xtg, _ = tlin.linear_gram_ref(*args, feat)
    assert torch.isnan(xthx[7]).all() and torch.isfinite(xtg[7]).all()
    assert torch.equal(xthx[8], clean[0][8])


def test_linear_leaf_values_match_jax():
    """Values within 1e-6 relative of the largest (the JAX package sums
    coeff x x by XLA's reduction, the port slot after slot); NaN rows the
    leaf's constant leaf_value exactly, on both sides."""
    d = _tree()
    raw, node, grad, hess, cnt = _rows(seed=4)
    jt = _jax_tree(d)
    lin = jlin.fit_linear_leaves(
        jt, jnp.asarray(node), jnp.asarray(raw), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(cnt), jnp.asarray(IS_CAT),
        jnp.float32(0.1), dmax=3)
    want = np.asarray(jlin.linear_leaf_values(
        jt, lin, jnp.asarray(node), jnp.asarray(raw)))
    tl = convert.linear_leaves_from_numpy(
        {k: np.asarray(v) for k, v in lin._asdict().items()})
    got = tlin.linear_leaf_values(convert.tree_arrays_from_numpy(d), tl,
                                  torch.as_tensor(node),
                                  torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    nan_rows = np.isnan(raw[:, 4]) & np.isin(node, [7, 8])
    assert nan_rows.any()
    np.testing.assert_array_equal(got[nan_rows],
                                  d["leaf_value"][node[nan_rows]])
    np.testing.assert_array_equal(got[nan_rows], want[nan_rows])
