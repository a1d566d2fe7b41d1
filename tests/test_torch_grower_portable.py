"""The port's portable grower (learner/grower.py grow_tree) against the
JAX package's, on the CPU.

The same binned matrix and gradients (numpy seeds 0-4) go through the JAX
grow_tree(hist_impl="scatter") (its f32 segment sums) and the port's
grow_tree with hist_impl "pallas" (the scatter kernel's plain version:
fixed-point sums) and "scatter" (float64 segment sums): batched and
leaf-wise growth; uint8 bins at max_bin 63 with NaN and categorical
features, uint16 bins at max_bin 1023; EFB at max_bin 511 on sparse data
(the bundled matrix is uint16: a dense feature keeps its 511-bin column);
feature_fraction_bynode, extra_trees and interaction groups under one
key. Tree structure and every row's leaf must be identical; leaf values
and gains agree within rtol 1e-4 / atol 5e-5 (JAX sums f32 cells, the
port sums exactly and rounds once).

Then the booster's choice of grower (the JAX package's _mxu_exclusions
and hist_impl rules), the per-iteration dispatch of train on the portable
grower (byte-equal to update(), no fused trainer) and its pass counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu import efb as jax_efb
from lightgbm_tpu.data import BinnedDataset as JaxBinned
from lightgbm_tpu.data import Metadata as JaxMetadata
from lightgbm_tpu.learner import grower as jax_grower
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu_torch import efb as torch_efb
from lightgbm_tpu_torch import rng as trng
from lightgbm_tpu_torch.learner import grower as torch_grower
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.conftest import make_binary
from tests.test_torch_one_thread import one_thread  # noqa: F401

_STRUCT = ("split_feature", "threshold_bin", "left", "right", "is_cat",
           "default_left", "parent", "depth", "is_leaf", "cat_bitset")


def _dense(seed, n=3000, f=6, max_bin=63):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 2] = rng.randint(0, 9, n)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) +
         (X[:, 2] == 4) > 0).astype(np.float32)
    cat = [2] if max_bin <= 256 else None
    ds = JaxBinned.from_raw(X, JaxMetadata(n, label=y), max_bin=max_bin,
                            categorical_features=cat)
    return ds, y, None, None


def _sparse_raw(seed, n=3000):
    """24 sparse features in groups of 8 (one nonzero a group and row, 5
    levels each) and two dense ones, and a binary label."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 26))
    for g in range(0, 24, 8):
        which = rng.randint(g, g + 8, size=n)
        X[np.arange(n), which] = rng.randint(1, 6, n)
    X[:, 24:] = rng.randn(n, 2)
    y = (X[:, 0] - X[:, 9] + X[:, 24] + 0.3 * rng.randn(n) > 0.5) \
        .astype(np.float32)
    return X, y


def _sparse(seed, n=3000, max_bin=511):
    """_sparse_raw binned at max_bin: the sparse features bundle, the dense
    ones keep max_bin-bin columns, so the bundled matrix is uint16."""
    X, y = _sparse_raw(seed, n)
    ds = JaxBinned.from_raw(X, JaxMetadata(n, label=y), max_bin=max_bin)
    args = (np.asarray(ds.bins), ds.num_bins, ds.default_bins,
            np.asarray(ds.is_categorical))
    plan_j = jax_efb.build_plan(*args, max_bundle_bins=256)
    plan_t = torch_efb.build_plan(*args, max_bundle_bins=256)
    assert plan_t.effective and plan_t.bundle_bmax > 256
    efb_j = jax_efb.make_device_tables(plan_j, ds.default_bins)
    efb_t = torch_efb.make_device_tables(plan_t, ds.default_bins)
    bundled = torch_efb.bundle_matrix(np.asarray(ds.bins), plan_t)
    assert bundled.dtype == np.uint16 and bundled.shape[1] < 26
    return ds, y, (efb_j, efb_t), bundled


def _grow_both(ds, y, efbs, bundled, *, seed, impl, leafwise,
               options=False, num_leaves=15):
    rng = np.random.RandomState(seed)
    n, f = ds.num_data, ds.num_features
    grad = (rng.randn(n) + y - 0.5).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    cnt = (rng.rand(n) < 0.9).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    has_cat = bool(np.asarray(ds.is_categorical).any())
    bmax = int(ds.num_bins.max())
    kw = dict(num_leaves=num_leaves, max_depth=-1, leafwise=leafwise,
              bmax=bmax)
    hp = dict(has_categorical=has_cat, min_data_in_leaf=10)
    jkw, tkw = {}, {}
    if options:
        hp["extra_trees"] = True
        kw["feature_fraction_bynode"] = 0.7
        kw["interaction_groups"] = ((0, 1, 2), (2, 3, 4, 5))
        jkw["rng_key"] = jax.random.PRNGKey(7)
        tkw["rng_key"] = trng.PRNGKey(7)
    bins = np.asarray(ds.bins) if bundled is None else bundled
    efb_j, efb_t = efbs if efbs is not None else (None, None)
    t_j, r_j = jax_grower.grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.ones(f, jnp.float32),
        jnp.asarray(ds.num_bins), jnp.asarray(ds.missing_types == 2),
        jnp.asarray(ds.is_categorical), hp=JaxHP(**hp), hist_impl="scatter",
        efb=efb_j, **jkw, **kw)
    stats = {}
    t_t, r_t = torch_grower.grow_tree(
        torch.as_tensor(bins), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.as_tensor(cnt), torch.ones(f),
        torch.as_tensor(ds.num_bins).to(torch.int32),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(np.asarray(ds.is_categorical)),
        hp=SplitHyperParams(**hp), hist_impl=impl, efb=efb_t, stats=stats,
        **tkw, **kw)
    return t_j, np.asarray(r_j), t_t, r_t.numpy(), stats


def _assert_same(t_j, r_j, t_t, r_t):
    nn = int(t_j.num_nodes)
    assert int(t_t.num_nodes) == nn and int(t_t.num_leaves) == \
        int(t_j.num_leaves)
    assert nn > 7
    for fld in _STRUCT:
        a = np.asarray(getattr(t_j, fld))[:nn]
        b = getattr(t_t, fld)[:nn].numpy()
        if fld == "cat_bitset":
            a = a.astype(np.int64)
        np.testing.assert_array_equal(b, a, err_msg=fld)
    np.testing.assert_array_equal(r_t, r_j)
    for fld in ("leaf_value", "sum_grad", "sum_hess", "count", "gain"):
        np.testing.assert_allclose(
            getattr(t_t, fld)[:nn].numpy(), np.asarray(getattr(t_j, fld))[:nn],
            rtol=1e-4, atol=5e-5 * (1 if fld != "gain" else 10), err_msg=fld)


_CASES = {"dense63": (_dense, 63), "dense1023": (_dense, 1023),
          "efb511": (_sparse, 511)}


@pytest.mark.parametrize("leafwise", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "scatter"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_grow_tree_matches_jax(case, impl, leafwise):
    make, max_bin = _CASES[case]
    ds, y, efbs, bundled = make(1, max_bin=max_bin)
    if max_bin > 256 and efbs is None:
        assert np.asarray(ds.bins).dtype == np.uint16
    t_j, r_j, t_t, r_t, stats = _grow_both(ds, y, efbs, bundled, seed=2,
                                           impl=impl, leafwise=leafwise)
    _assert_same(t_j, r_j, t_t, r_t)
    # one host read of `done` a pass; leaf-wise takes a pass a split
    assert 1 <= stats["passes"] <= 14
    if leafwise:
        assert stats["passes"] == int(t_t.num_leaves) - 1


@pytest.mark.parametrize("leafwise", [False, True])
def test_grow_tree_options_match_jax(leafwise):
    """feature_fraction_bynode, extra_trees and interaction groups draw
    under the JAX package's key schedule (fold_in(key, pass), 7919)."""
    ds, y, _, _ = _dense(3)
    t_j, r_j, t_t, r_t, _ = _grow_both(ds, y, None, None, seed=4,
                                       impl="pallas", leafwise=leafwise,
                                       options=True)
    _assert_same(t_j, r_j, t_t, r_t)


def test_rescan_needs_leafwise():
    ds, y, _, _ = _dense(0)
    n, f = ds.num_data, ds.num_features
    with pytest.raises(ValueError, match="leaf-wise"):
        torch_grower.grow_tree(
            torch.as_tensor(np.asarray(ds.bins)), torch.ones(n),
            torch.ones(n), torch.ones(n), torch.ones(f),
            torch.as_tensor(ds.num_bins).to(torch.int32),
            torch.zeros(f, dtype=torch.bool),
            torch.zeros(f, dtype=torch.bool), num_leaves=7, max_depth=-1,
            hp=SplitHyperParams(has_monotone=True), bmax=63,
            monotone=torch.ones(f, dtype=torch.int32),
            monotone_method="advanced")
    with pytest.raises(ValueError, match="hist_impl"):
        torch_grower.grow_tree(
            torch.as_tensor(np.asarray(ds.bins)), torch.ones(n),
            torch.ones(n), torch.ones(n), torch.ones(f),
            torch.as_tensor(ds.num_bins).to(torch.int32),
            torch.zeros(f, dtype=torch.bool),
            torch.zeros(f, dtype=torch.bool), num_leaves=7, max_depth=-1,
            hp=SplitHyperParams(), bmax=63, hist_impl="mxu")


_CHOICES = [({}, "mxu"), ({"gpu_use_dp": False}, "mxu"),
            ({"max_bin": 1023}, "pallas"), ({"use_pallas": False}, "scatter"),
            ({"max_bin": 1023, "use_pallas": False}, "scatter"),
            ({"monotone_constraints": [1, 0, 0, 0],
              "monotone_constraints_method": "intermediate"}, "pallas"),
            ({"monotone_constraints": [1, 0, 0, 0],
              "monotone_constraints_method": "advanced"}, "pallas"),
            ({"monotone_constraints": [1, 0, 0, 0]}, "mxu")]


@pytest.mark.parametrize("extra,impl", _CHOICES)
def test_booster_picks_the_jax_packages_grower(extra, impl):
    """The JAX package's rule (gbdt.py:225-247 and _mxu_exclusions): the
    MXU grower unless max_bin > 256 or a rescanning monotone method
    excludes it, then the portable grower with the scatter kernel
    ("pallas"); use_pallas=false takes the segment sums ("scatter")."""
    X, y = make_binary(n=2000, f=4)
    p = dict({"objective": "binary", "verbosity": -1, "device_type": "cpu",
              "num_leaves": 7}, **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    g = bst.gbdt
    assert g._hist_impl == impl
    assert g._fused_eligible() == (impl == "mxu")
    bst.update()
    assert (g.grow_stats["trees"] > 0) == (impl != "mxu")


def test_train_on_portable_grower_equals_update():
    """engine.train dispatches one iteration at a time on the portable
    grower (no fused trainer) and writes update()'s bytes; quantized
    gradients warn and train full-precision there."""
    X, y = make_binary(n=2000, f=6)
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
         "num_leaves": 15, "max_bin": 1023, "fused_block_size": 4}
    ds = lgt.Dataset(X, label=y, params=p).construct()
    trained = lgt.train(p, ds, 6)
    stepped = lgt.Booster(p, ds)
    for _ in range(6):
        stepped.update()
    assert not trained.gbdt.fused_stats
    assert trained.model_to_string() == stepped.model_to_string()
    st = stepped.gbdt.grow_stats
    assert st["trees"] == 6 and st["passes"] > 6
    pq = dict(p, use_quantized_grad=True)
    quant = lgt.train(pq, lgt.Dataset(X, label=y, params=pq), 6)
    assert _tree_text(quant) == _tree_text(trained)


def _tree_text(bst):
    """The model text's trees, without the header and parameter echo."""
    text = bst.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]
