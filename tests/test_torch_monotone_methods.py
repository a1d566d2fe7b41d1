"""The intermediate and advanced monotone methods against the JAX package.

learner/monotone.recompute_bounds is held to the JAX function bit for bit
on the same trees: trees the portable grower grew (leaf-wise, monotone
+1/-1 on two features, NaN and categorical features), with their leaf
values replaced by random ones so every bound is live, both methods, with
and without the NaN-bin exclusion. Then boosters with
monotone_constraints_method intermediate and advanced (the portable
grower, leaf-wise) against the JAX booster on the CPU (its portable
grower, hist_impl scatter): tree structure and pred_leaf identical, raw
predictions within 5e-5, and predictions swept over each constrained
feature monotone in its direction; the same on uint16 bins (max_bin 1023)
and with use_pallas=false. Data: numpy seeds 0-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import grower as jax_grower
from lightgbm_tpu.learner import monotone as jax_mono
from lightgbm_tpu_torch.data import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner import grower as torch_grower
from lightgbm_tpu_torch.learner import monotone as torch_mono
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

_MONO = [1, -1, 0, 0, 0, 0]


def _data(seed, n=2500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 3] = rng.randint(0, 7, n)
    X[rng.rand(n) < 0.08, 1] = np.nan
    y = (X[:, 0] - np.nan_to_num(X[:, 1]) + 0.5 * X[:, 2] +
         (X[:, 3] == 2) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _grown_tree(seed):
    X, y = _data(seed)
    n = len(y)
    ds = BinnedDataset.from_raw(X, Metadata(n, label=y), max_bin=31,
                                categorical_features=[3])
    rng = np.random.RandomState(seed + 100)
    # a binary objective's sign: the output -G/H rises with the label
    grad = (0.5 * rng.randn(n) + 0.5 - y).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    f = ds.num_features
    tree, _ = torch_grower.grow_tree(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(n), torch.ones(f),
        torch.as_tensor(ds.num_bins).to(torch.int32),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(np.asarray(ds.is_categorical)), num_leaves=31,
        max_depth=-1, hp=SplitHyperParams(has_monotone=True,
                                          has_categorical=True,
                                          min_data_in_leaf=5),
        leafwise=True, bmax=int(ds.num_bins.max()),
        monotone=torch.tensor(_MONO, dtype=torch.int32),
        monotone_method="advanced")
    # random leaf values: every bound is live, ties are rare
    lv = torch.as_tensor(rng.randn(tree.leaf_value.shape[0])
                         .astype(np.float32))
    return tree._replace(leaf_value=lv), ds


@pytest.mark.parametrize("nan_aware", [False, True])
@pytest.mark.parametrize("method", ["intermediate", "advanced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recompute_bounds_equals_jax(seed, method, nan_aware):
    tree, ds = _grown_tree(seed)
    assert int(tree.num_leaves) == 31 and bool(tree.is_cat.any())
    mono = np.asarray(_MONO, np.int32)
    nan = ds.missing_types == 2
    assert nan.any()
    jt = jax_grower.TreeArrays(**{
        k: jnp.asarray(v.numpy().astype(np.uint32) if k == "cat_bitset"
                       else v.numpy()) for k, v in tree._asdict().items()})
    lo_j, hi_j = jax_mono.recompute_bounds(
        jt, jnp.asarray(mono), jnp.asarray(ds.num_bins), method=method,
        missing_is_nan=jnp.asarray(nan) if nan_aware else None)
    lo_t, hi_t = torch_mono.recompute_bounds(
        tree, torch.as_tensor(mono), torch.as_tensor(ds.num_bins),
        method=method,
        missing_is_nan=torch.as_tensor(nan) if nan_aware else None)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    # some bounds bind, and directions given on the host change nothing
    assert np.isfinite(lo_t.numpy()).any() and np.isfinite(hi_t.numpy()).any()
    lo_h, hi_h = torch_mono.recompute_bounds(
        tree, torch.as_tensor(mono), torch.as_tensor(ds.num_bins),
        method=method, directions=_MONO,
        missing_is_nan=torch.as_tensor(nan) if nan_aware else None)
    assert torch.equal(lo_h, lo_t) and torch.equal(hi_h, hi_t)


@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
def test_leaf_values_are_clamped_row_sums(method):
    """Every leaf holds -G/H of its rows clamped into the bounds its
    parent's scan used (grow_tree's node_bounds), within 1e-5 of the
    float64 value: a wrong histogram shows in a clamped leaf too, unless
    -G/H lies beyond the bound on the side it clamps. Numerical features
    only (a categorical split's outputs add cat_l2)."""
    X, y = _data(5)
    n = len(y)
    ds = BinnedDataset.from_raw(X, Metadata(n, label=y), max_bin=31)
    rng = np.random.RandomState(105)
    grad = (0.5 * rng.randn(n) + 0.5 - y).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    f = ds.num_features
    stats = {}
    tree, row_node = torch_grower.grow_tree(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(n), torch.ones(f),
        torch.as_tensor(ds.num_bins).to(torch.int32),
        torch.as_tensor(ds.missing_types == 2),
        torch.zeros(f, dtype=torch.bool), num_leaves=31, max_depth=-1,
        hp=SplitHyperParams(has_monotone=True, min_data_in_leaf=5),
        leafwise=method != "basic", bmax=int(ds.num_bins.max()),
        monotone=torch.tensor(_MONO, dtype=torch.int32),
        monotone_method=method, stats=stats)
    nn = int(tree.num_nodes)
    lo, hi = stats["node_bounds"][:nn].double().unbind(1)
    node = row_node.numpy().astype(np.int64)
    g_rows = np.bincount(node, grad.astype(np.float64), minlength=nn)
    h_rows = np.bincount(node, hess.astype(np.float64), minlength=nn)
    leaf = tree.is_leaf[:nn].numpy() & (np.bincount(node, minlength=nn) > 0)
    free = torch.as_tensor(-g_rows / np.where(leaf, h_rows, 1.0))
    want = torch.clamp(free, lo, hi).numpy()
    value = tree.leaf_value[:nn].double().numpy()
    np.testing.assert_allclose(value[leaf], want[leaf], rtol=1e-5,
                               atol=1e-5)
    # the bounds bind at some leaves and not at others
    clamped = leaf & (np.abs(free.numpy() - want) > 1e-4)
    assert int(tree.num_leaves) == 31 and 0 < clamped.sum() < leaf.sum()
    assert lo[0] == -np.inf and hi[0] == np.inf


def _sweep_monotone(bst, X, directions):
    """Predictions of 40 rows with each constrained feature swept over a
    grid (NaN left out) move in its direction."""
    rows = X[:40].copy()
    grid = np.linspace(-3, 3, 41)
    for j, d in enumerate(directions):
        if d == 0:
            continue
        batch = np.repeat(rows, len(grid), axis=0)
        batch[:, j] = np.tile(grid, len(rows))
        pred = bst.predict(batch, raw_score=True).reshape(len(rows),
                                                          len(grid))
        step = np.diff(pred, axis=1) * d
        assert (step >= -1e-6).all(), (j, step.min())


_CASES = [("intermediate", {}), ("advanced", {}),
          ("intermediate", {"max_bin": 1023}),
          ("advanced", {"use_pallas": False})]

# ROADMAP C3, pinned by name: in the max_bin 1023 case, tree 3's node 6
# splits categorical feature 3 with both children clamped to one monotone
# bound (leaf value -0.0538 on both sides), so a left set and its
# complement have one gain up to f32 rounding; the JAX package sends
# {2, 4, 6} left, the port {0, 1, 3, 5} (its sums round once). The
# partition, the tree's other lines and every prediction agree.
_TIES = {2: (3, 6)}


def _unswap_tie(s_jax, s_torch, tree, node):
    """s_torch with tree `tree`'s categorical node `node` given the JAX
    model's left set and its two leaves' counts swapped back, after
    checking that the sets are complements over the node's categories and
    that both leaves hold one value."""
    from tests.test_torch_train import _trees
    a, b = _trees(s_jax)[tree], _trees(s_torch)[tree]
    kind = int(a["decision_type"].split()[node])
    assert kind & 1 and kind == int(b["decision_type"].split()[node])
    cat = sum(int(d) & 1 for d in a["decision_type"].split()[:node])
    bits_a = int(a["cat_threshold"].split()[cat])
    bits_b = int(b["cat_threshold"].split()[cat])
    assert bits_a & bits_b == 0 and bits_a != bits_b
    leaves = [-1 - int(b[k].split()[node])
              for k in ("left_child", "right_child")]
    values = [float(b["leaf_value"].split()[i]) for i in leaves]
    assert values[0] == values[1], values
    counts = b["leaf_count"].split()
    counts[leaves[0]], counts[leaves[1]] = counts[leaves[1]], \
        counts[leaves[0]]
    head, rest = s_torch.split(f"Tree={tree}\n", 1)
    block, tail = rest.split("\n\n", 1)
    block = block.replace("cat_threshold=" + b["cat_threshold"],
                          "cat_threshold=" + a["cat_threshold"]) \
        .replace("leaf_count=" + b["leaf_count"],
                 "leaf_count=" + " ".join(counts))
    return f"{head}Tree={tree}\n{block}\n\n{tail}", leaves


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_booster_matches_jax(case):
    method, extra = _CASES[case]
    X, y = _data(4)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1, "monotone_constraints": _MONO,
                   "monotone_constraints_method": method,
                   "categorical_feature": "3"}, **extra)
    jbst = lgb.Booster(dict(params, pipeline=False),
                       lgb.Dataset(X, label=y, params=params))
    assert jbst.gbdt._hist_impl == "scatter"   # the JAX portable grower
    for _ in range(4):
        jbst.update()
    p = dict(params, device_type="cpu")
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    g = bst.gbdt
    assert g._hist_impl == ("scatter" if "use_pallas" in extra
                            else "pallas")
    assert g._mono_method == method
    if "max_bin" in extra:
        assert g.bins.dtype == torch.uint16
    # leaf-wise: a pass a split
    assert g.grow_stats["passes"] == sum(
        int(t.num_leaves) - 1 for t in g.trees)
    s_jax, s_torch = jbst.model_to_string(), bst.model_to_string()
    leaf_j = jbst.predict(X, pred_leaf=True)
    leaf_t = bst.predict(X, pred_leaf=True)
    if case in _TIES:
        tree, node = _TIES[case]
        s_torch, pair = _unswap_tie(s_jax, s_torch, tree, node)
        col = leaf_t[:, tree].copy()
        for x, z in (pair, pair[::-1]):
            leaf_t[col == x, tree] = z
    _assert_same_model(s_jax, s_torch)
    np.testing.assert_array_equal(leaf_t, leaf_j)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jbst.predict(X, raw_score=True), rtol=1e-5,
                               atol=5e-5)
    _sweep_monotone(bst, X, _MONO)


def test_methods_differ_from_basic():
    """The rescanning methods grow other trees than basic's midpoints
    (looser bounds), and each stays monotone."""
    X, y = _data(5)
    texts = {}
    for method in ("basic", "intermediate", "advanced"):
        p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
             "device_type": "cpu", "monotone_constraints": _MONO,
             "monotone_constraints_method": method}
        bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
        _sweep_monotone(bst, X, _MONO)
        text = bst.model_to_string()
        texts[method] = text[text.index("Tree=0"):text.index("end of")]
    assert texts["basic"] != texts["intermediate"]
    assert texts["basic"] != texts["advanced"]
