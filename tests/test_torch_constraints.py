"""The port's split-search options against the JAX package, on the CPU.

The threefry draws (bits, uniform, randint, permutation) bit for bit; the
feature_fraction masks; split.find_best_splits with monotone constraints
and extra_trees draws; grow_tree_mxu with monotone constraints,
interaction constraints, feature_fraction_bynode, extra_trees and all four
together (the JAX grower in Pallas interpret mode, the port on CPU tensors)
in exact and quantized growth; and the booster with each option.

The grower and booster option tests are spread over this file and
tests/test_torch_constraints_{grower,quantized,train,train_all}.py (one JAX
interpret compile each, ~20-45 s under -n 6), so that --dist loadfile
spreads them; their bodies live here.

A node's NaN direction is compared wherever a row with the split feature's
NaN bin reaches the node. Where none does, both directions send the same
rows and their gains are equal: the JAX histograms leave an empty NaN cell
at a few ulps of noise after sibling subtraction (the port's float64 cells
rounded once leave it at zero), so that tie falls either way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu.learner.split import find_best_splits as jax_find
from lightgbm_tpu_torch import convert, rng
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from lightgbm_tpu_torch.learner.split import find_best_splits
from tests.conftest import make_binary, make_regression
from tests.test_torch_grower import _data
from tests.test_torch_train import _assert_same_model, _jax_booster
from tests.test_torch_one_thread import one_thread  # noqa: F401

_KEYS = (0, 1, 42, 2 ** 33 + 5)
_SHAPES = ((7,), (3, 5), (28,), (63, 28))


def _tkey(key):
    return convert.key_from_numpy(np.asarray(key))


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", _KEYS)
def test_bits_and_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    for shape in _SHAPES:
        np.testing.assert_array_equal(
            rng.bits(_tkey(key), shape).numpy(),
            np.asarray(jax.random.bits(key, shape)).astype(np.int64))
        got = rng.uniform(_tkey(key), shape).numpy()
        assert got.shape == shape
        np.testing.assert_array_equal(
            got.view(np.int32),
            np.asarray(jax.random.uniform(key, shape)).view(np.int32))


@pytest.mark.parametrize("seed", _KEYS)
def test_randint_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    # spans below and above 2^16 (the multiplier wraps in uint32) and the
    # full int32 range
    for lo, hi in ((0, 256), (0, 63), (-5, 17), (0, 1), (0, 70000),
                   (-2 ** 31, 2 ** 31 - 1)):
        for shape in _SHAPES:
            got = rng.randint(_tkey(key), shape, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(jax.random.randint(key, shape, lo, hi)),
                err_msg=f"[{lo}, {hi}) {shape}")


@pytest.mark.parametrize("seed", _KEYS)
def test_permutation_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    for n in (1, 2, 5, 28, 100, 3000, 100_000):    # one round, then two
        np.testing.assert_array_equal(
            rng.permutation(_tkey(key), n).numpy(),
            np.asarray(jax.random.permutation(key, n)), err_msg=str(n))


def test_feature_mask_matches_jax_booster():
    X, y = make_binary(n=300, f=10)
    params = {"objective": "binary", "verbosity": -1, "feature_fraction": 0.6,
              "feature_fraction_seed": 9}
    j = lgb.Booster(params, lgb.Dataset(X, label=y)).gbdt
    t = lgt.Booster(dict(params, device_type="cpu"),
                    lgt.Dataset(X, label=y)).gbdt
    for it in range(6):
        got = t._feature_mask_at(it).numpy()
        assert got.sum() == 6
        np.testing.assert_array_equal(got, np.asarray(j._feature_mask_at(it)))


# ---------------------------------------------------------------------------
# split.find_best_splits
# ---------------------------------------------------------------------------

def _split_inputs(seed=3, s=6, f=5, b=31):
    r = np.random.RandomState(seed)
    hist = np.abs(r.rand(s, f, b, 3)) * np.array([1.0, 1.0, 50.0])
    tot = hist.sum(2).mean(1)                                      # [S, 3]
    hist = hist / hist.sum(2, keepdims=True) * tot[:, None, None, :]
    hist[..., 0] -= hist[..., 0].mean(2, keepdims=True) * 0.9  # signed grads
    tot = hist[:, 0].sum(1)
    return (hist.astype(np.float32), tot[:, 0].astype(np.float32),
            tot[:, 1].astype(np.float32), tot[:, 2].astype(np.float32),
            (r.randn(s) * 0.1).astype(np.float32))


@pytest.mark.parametrize("case", ["monotone", "monotone_penalty",
                                  "extra_trees", "all"])
def test_find_best_splits_options_match_jax(case):
    hist, pg, ph, pc, po = _split_inputs()
    s, f, b, _ = hist.shape
    num_bins = np.full(f, b, np.int32)
    num_bins[2] = 17
    mnan = np.array([True, False, True, False, False])
    fmask = (np.random.RandomState(4).rand(s, f) < 0.8).astype(np.float32)
    kw = dict(min_data_in_leaf=3)
    extra = {}
    if case != "extra_trees":
        kw.update(has_monotone=True,
                  monotone_penalty=0.0 if case == "monotone" else 1.5)
        extra.update(monotone=np.array([1, -1, 0, 1, 0], np.int32),
                     cons_min=np.full(s, -0.2, np.float32),
                     cons_max=np.array([0.2, 0.1, 1.0, 0.05, np.inf, 0.3],
                                       np.float32),
                     depth=np.arange(s, dtype=np.int32))
    if case in ("extra_trees", "all"):
        kw.update(extra_trees=True)
        extra.update(rand_bins=np.random.RandomState(5).randint(
            0, b, (s, f)).astype(np.int32))
    args = (hist, pg, ph, pc, po, num_bins, mnan, np.zeros(f, bool), fmask)
    want = jax_find(*map(jnp.asarray, args), JaxHP(**kw),
                    **{k: jnp.asarray(v) for k, v in extra.items()})
    got = find_best_splits(*map(torch.as_tensor, args),
                           SplitHyperParams(**kw),
                           **{k: torch.as_tensor(v) for k, v in extra.items()})
    assert int((got.feature >= 0).sum()) >= 3       # real splits happen
    for fld in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), fld)
    for fld in ("gain", "left_grad", "left_hess", "left_count",
                "left_output", "right_output"):
        np.testing.assert_allclose(getattr(got, fld).numpy(),
                                   np.asarray(getattr(want, fld)),
                                   rtol=1e-4, atol=1e-5, err_msg=fld)
    if "cons_min" in extra:     # outputs inside each slot's bounds
        split = got.feature.numpy() >= 0
        for out in (got.left_output, got.right_output):
            o = out.numpy()[split]
            assert (o >= extra["cons_min"][split]).all()
            assert (o <= extra["cons_max"][split]).all()


# ---------------------------------------------------------------------------
# grow_tree_mxu
# ---------------------------------------------------------------------------

_MONO = np.array([1, -1, 0, 0, 0, 0], np.int32)
_OPTIONS = {
    "monotone": dict(hp=dict(has_monotone=True, monotone_penalty=0.5),
                     monotone=True),
    "interaction": dict(groups=((0, 1, 2), (3, 4), (0, 5))),
    "bynode": dict(bynode=0.6),
    "extra_trees": dict(hp=dict(extra_trees=True)),
    "all": dict(hp=dict(has_monotone=True, extra_trees=True),
                monotone=True, groups=((0, 1, 2), (2, 3, 4, 5)), bynode=0.7),
}


def _grow_both(ds, grad, hess, option, quantized=False, scan_kernel=False):
    f = ds.num_features
    fmask = np.ones(f, np.float32)
    fmask[4] = 0.0                          # the tree's feature_fraction mask
    key = jax.random.PRNGKey(5)
    kw = dict(num_leaves=15, max_depth=-1, overshoot=2.0, tail_split_cap=8,
              hist_subtraction=True, bmax=int(ds.num_bins.max()),
              interaction_groups=option.get("groups"),
              feature_fraction_bynode=option.get("bynode", 1.0),
              quantized_grad=quantized)
    mono = _MONO[:f] if option.get("monotone") else None
    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(ds.num_data, jnp.float32), jnp.asarray(fmask),
        jnp.asarray(ds.num_bins), jnp.asarray(ds.missing_types == 2),
        jnp.asarray(ds.is_categorical), hp=JaxHP(**option.get("hp", {})),
        monotone=None if mono is None else jnp.asarray(mono), rng_key=key,
        interpret=True, use_scan_kernel=scan_kernel, **kw)
    t_torch, r_torch = torch_grower.grow_tree_mxu(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(ds.num_data),
        torch.as_tensor(fmask), torch.as_tensor(ds.num_bins),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical),
        hp=SplitHyperParams(**option.get("hp", {})),
        monotone=None if mono is None else torch.as_tensor(mono),
        rng_key=_tkey(key), use_scan_kernel=scan_kernel, **kw)
    want = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in t_jax._asdict().items()})
    return want, np.asarray(r_jax), t_torch, r_torch.numpy()


def _under(parent, node):
    """[nodes] bool: the node and its descendants."""
    out = np.zeros(len(parent), bool)
    for x in range(len(parent)):
        a = x
        while a >= 0 and a != node:
            a = parent[a]
        out[x] = a == node
    return out


def _nan_rows_reach(tree, row_node, bins, num_bins, missing_is_nan):
    """[nodes] bool: a row in the split feature's NaN bin reaches the
    node (the node's NaN direction decides something)."""
    nn = int(tree.num_nodes)
    parent = tree.parent[:nn].numpy()
    feat = tree.split_feature[:nn].numpy()
    out = np.zeros(nn, bool)
    for node in np.nonzero(feat >= 0)[0]:
        if missing_is_nan[feat[node]]:
            rows = _under(parent, node)[row_node]
            out[node] = (bins[rows, feat[node]] ==
                         num_bins[feat[node]] - 1).any()
    return out


def assert_same_tree(want, r_want, got, r_got, ds, quantized=False,
                     leaf_rtol=1e-4):
    """Structure, routing and NaN directions identical; leaves at rtol
    leaf_rtol / atol 1e-5 (exact growth) or bit for bit (quantized
    growth, the exact refit); a quantized threshold may differ across bins
    no row of the node occupies (prefix sums round differently in the two
    packages)."""
    nn = int(want.num_nodes)
    assert int(got.num_nodes) == nn
    assert int(got.num_leaves) == int(want.num_leaves)
    np.testing.assert_array_equal(r_got, r_want)

    def field(t, name):
        return getattr(t, name)[:nn].numpy()
    for fld in ("split_feature", "left", "right", "parent", "depth",
                "is_leaf", "count"):
        np.testing.assert_array_equal(field(got, fld), field(want, fld), fld)
    decides = _nan_rows_reach(want, r_want, ds.bins, ds.num_bins,
                              ds.missing_types == 2)
    np.testing.assert_array_equal(field(got, "default_left")[decides],
                                  field(want, "default_left")[decides])
    thr_g, thr_w = field(got, "threshold_bin"), field(want, "threshold_bin")
    leaf = field(want, "is_leaf")
    if not quantized:
        np.testing.assert_array_equal(thr_g, thr_w)
        np.testing.assert_allclose(field(got, "leaf_value"),
                                   field(want, "leaf_value"),
                                   rtol=leaf_rtol, atol=1e-5)
        return
    # the refit leaves: bit for bit where the leaf is its rows' -G/H; a
    # leaf clipped to its monotone bounds (set at growth time from
    # quantized outputs, whose prefix sums round differently in the two
    # packages) within 1e-6
    value_g, value_w = field(got, "leaf_value"), field(want, "leaf_value")
    free = leaf & (value_g == -field(got, "sum_grad") / field(got, "sum_hess"))
    np.testing.assert_array_equal(value_g[free].view(np.int32),
                                  value_w[free].view(np.int32))
    np.testing.assert_allclose(value_g[leaf], value_w[leaf], rtol=1e-6)
    feat, parent = field(want, "split_feature"), field(want, "parent")
    for node in np.nonzero(thr_g != thr_w)[0]:
        b = ds.bins[_under(parent, node)[r_got], feat[node]]
        lo, hi = sorted((thr_g[node], thr_w[node]))
        assert not ((b > lo) & (b <= hi)).any(), node


def _grower_option_case(name):
    """test_grower_options_match_jax's body (its cases are spread over
    this file and tests/test_torch_constraints_grower.py, so that
    --dist loadfile spreads their JAX interpret compiles)."""
    ds, grad, hess = _data(3000, 6, seed=2, with_nan=True)
    want, r_want, got, r_got = _grow_both(ds, grad, hess, _OPTIONS[name])
    assert int(got.num_leaves) == 15
    feat = got.split_feature[:int(got.num_nodes)].numpy()
    assert 4 not in feat                        # the tree's mask holds
    assert_same_tree(want, r_want, got, r_got, ds)


@pytest.mark.parametrize("name", ["monotone", "interaction", "bynode"])
def test_grower_options_match_jax(name):
    _grower_option_case(name)


def test_monotone_growth_keeps_children_ordered():
    # every split on a constrained feature orders its children's outputs,
    # and every leaf lies within the bounds its ancestors set
    ds, grad, hess = _data(3000, 6, seed=8, with_nan=True)
    tree, _ = torch_grower.grow_tree_mxu(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(ds.num_data),
        torch.ones(ds.num_features), torch.as_tensor(ds.num_bins),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical), num_leaves=15, max_depth=-1,
        bmax=int(ds.num_bins.max()), overshoot=2.0,
        hp=SplitHyperParams(has_monotone=True),
        monotone=torch.as_tensor(_MONO))
    nn = int(tree.num_nodes)
    feat = tree.split_feature[:nn].numpy()
    left, right = tree.left[:nn].numpy(), tree.right[:nn].numpy()
    value = tree.leaf_value[:nn].numpy().astype(np.float64)

    def leaves(node):
        if feat[node] < 0:
            return [node]
        return leaves(left[node]) + leaves(right[node])
    constrained = 0
    for node in np.nonzero(feat >= 0)[0]:
        c = _MONO[feat[node]]
        if c == 0:
            continue
        constrained += 1
        lo = value[leaves(left[node])]
        hi = value[leaves(right[node])]
        if c < 0:
            lo, hi = hi, lo
        assert lo.max() <= hi.min() + 1e-6, node
    assert constrained >= 2


# ---------------------------------------------------------------------------
# booster
# ---------------------------------------------------------------------------

# the options together, as the card's constrained configuration sets them:
# monotone +1/-1 on two features, three interaction groups, per-tree and
# per-node feature sampling
_ALL_OPTIONS = {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0, 0, 0],
                "interaction_constraints": [[0, 1, 2], [3, 4, 5, 6],
                                            [7, 8, 9]],
                "feature_fraction": 0.8, "feature_fraction_bynode": 0.8}


# test_train_options_match_jax_package's cases, by id; they run in
# tests/test_torch_constraints_train.py and
# tests/test_torch_constraints_train_all.py, so that --dist loadfile
# spreads their JAX interpret compiles
_TRAIN_OPTIONS = {
    "feature_fraction": {"feature_fraction": 0.6},
    "bynode": {"feature_fraction_bynode": 0.5},
    "extra_trees": {"extra_trees": True},
    "monotone": {"monotone_constraints": [1, 0, -1, 0, 0, 0, 0, 0, 0, 0],
                 "monotone_penalty": 1.0},
    "interaction": {"interaction_constraints": [[0, 1], [2, 3, 4],
                                                [5, 6, 7, 8, 9]]},
    "all": _ALL_OPTIONS,
}


def _train_option_case(extra):
    """test_train_options_match_jax_package's body."""
    X, y = make_binary(n=2000, f=10)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1}, **extra)
    b_jax = _jax_booster(X, y, params, 3)
    p = dict(params, device_type="cpu")
    b_torch = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    _assert_same_model(b_jax.model_to_string(), b_torch.model_to_string())
    np.testing.assert_allclose(b_torch.predict(X, raw_score=True),
                               b_jax.predict(X, raw_score=True),
                               rtol=1e-5, atol=5e-5)


def test_train_monotone_predictions():
    r = np.random.RandomState(0)
    n = 3000
    X = r.randn(n, 4)
    # feature 0's true effect is not monotone: the constraint flattens it
    y = (np.sin(2 * X[:, 0]) - np.cos(2 * X[:, 2]) + X[:, 1] +
         0.1 * r.randn(n)).astype(np.float32)
    params = {"objective": "regression", "verbosity": -1, "num_leaves": 15,
              "monotone_constraints": [1, 0, -1, 0], "device_type": "cpu"}
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), 10)
    base = np.median(X, axis=0)
    for feature, sign in ((0, 1), (2, -1)):
        grid = np.linspace(X[:, feature].min(), X[:, feature].max(), 25)
        rows = np.tile(base, (25, 1))
        rows[:, feature] = grid
        pred = bst.predict(rows, raw_score=True)
        assert np.all(sign * np.diff(pred) >= -1e-9), feature
    # and unconstrained it is not monotone in feature 0
    free = lgt.train(dict(params, monotone_constraints=None),
                     lgt.Dataset(X, label=y, params=params), 10)
    grid = np.linspace(X[:, 0].min(), X[:, 0].max(), 25)
    rows = np.tile(base, (25, 1))
    rows[:, 0] = grid
    assert not np.all(np.diff(free.predict(rows, raw_score=True)) >= -1e-9)


def test_interaction_groups_map_to_used_features():
    # a constant column is dropped from the used features; the groups of
    # original indices must follow the renumbering
    X, y = make_regression(n=1000, f=6)
    X[:, 1] = 3.0
    params = {"objective": "regression", "verbosity": -1, "num_leaves": 7,
              "interaction_constraints": [[0, 1, 2], [3, 4, 5]],
              "device_type": "cpu"}
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    groups = bst.gbdt._interaction_groups
    assert groups == ((0, 1), (2, 3, 4))
    for _ in range(3):
        bst.update()
    for tree in bst.gbdt.trees:
        feat = tree.split_feature.numpy()
        parent = tree.parent.numpy()
        for leaf in np.nonzero(tree.is_leaf.numpy())[0]:
            path, a = set(), parent[leaf]
            while a >= 0:
                path.add(int(feat[a]))
                a = parent[a]
            assert any(path <= set(g) for g in groups), path
