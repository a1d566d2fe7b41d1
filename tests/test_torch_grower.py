"""The port's grow_tree_mxu against the JAX package's, on the CPU.

The same binned matrix (carried across with lightgbm_tpu_torch.convert)
and the same gradients go through the JAX grower in Pallas interpret mode
and through the port's grower on CPU tensors (its kernels' plain
versions), in the library's default growth posture (overshoot 2 with
best-first pruning, sibling subtraction). Tree structure and row routing
must be identical; leaf values agree to the bar tests/test_mxu_kernels.py
holds the MXU grower to (the JAX histograms sum double-bf16 channels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.data import BinnedDataset, Metadata
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.test_torch_one_thread import one_thread  # noqa: F401

_STRUCT = ("split_feature", "threshold_bin", "left", "right", "is_cat",
           "default_left", "parent", "depth", "is_leaf")


def _data(n, f, seed, with_nan=False, with_cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    if with_cat:
        X[:, 2] = rng.randint(0, 12, size=n)
    if with_nan:
        X[rng.rand(n) < 0.05, 1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > 0)
    ds = BinnedDataset.from_raw(
        X, Metadata(n, label=y.astype(np.float32)), max_bin=63,
        categorical_features=[2] if with_cat else None)
    grad = (rng.randn(n) + y - 0.5).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return ds, grad, hess


_DEFAULT = dict(max_depth=-1, overshoot=2.0, tail_split_cap=8,
                hist_subtraction=True)


def _grow_both(ds, grad, hess, num_leaves, posture=_DEFAULT):
    kw = dict(posture, num_leaves=num_leaves, bmax=int(ds.num_bins.max()))
    has_cat = bool(ds.is_categorical.any())
    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(ds.num_data, jnp.float32),
        jnp.ones(ds.num_features, jnp.float32), jnp.asarray(ds.num_bins),
        jnp.asarray(ds.missing_types == 2), jnp.asarray(ds.is_categorical),
        hp=JaxHP(has_categorical=has_cat), interpret=True, **kw)
    pds = convert.binned_from_numpy(
        ds.bins, ds.num_bins, ds.missing_types, ds.is_categorical,
        [m.to_dict() for m in ds.mappers])
    t_torch, r_torch = torch_grower.grow_tree_mxu(
        torch.as_tensor(pds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(pds.num_data),
        torch.ones(pds.num_features), torch.as_tensor(pds.num_bins),
        torch.as_tensor(pds.missing_types == 2),
        torch.as_tensor(pds.is_categorical),
        hp=SplitHyperParams(has_categorical=has_cat), **kw)
    jax_np = {k: np.asarray(v) for k, v in t_jax._asdict().items()}
    return jax_np, np.asarray(r_jax), t_torch, r_torch.numpy()


def _assert_same_tree(jax_np, r_jax, t_torch, r_torch):
    t_jax = convert.tree_arrays_from_numpy(jax_np)
    nn = int(t_jax.num_nodes)
    assert int(t_torch.num_nodes) == nn
    assert int(t_torch.num_leaves) == int(t_jax.num_leaves)
    for fld in _STRUCT + ("cat_bitset",):
        np.testing.assert_array_equal(getattr(t_torch, fld)[:nn].numpy(),
                                      getattr(t_jax, fld)[:nn].numpy(),
                                      err_msg=fld)
    np.testing.assert_allclose(t_torch.leaf_value[:nn].numpy(),
                               t_jax.leaf_value[:nn].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t_torch.count[:nn].numpy(),
                                  t_jax.count[:nn].numpy())
    np.testing.assert_array_equal(r_torch, r_jax)


@pytest.mark.parametrize("num_leaves,posture", [
    (15, _DEFAULT),
    # the bridge gate and a depth cap on the overshoot path
    (7, dict(_DEFAULT, max_depth=3, bridge_gate=0.9)),
    # hybrid growth (no overshoot: tail-throttled passes, no prune) with
    # every child's histogram built from rows
    (7, dict(_DEFAULT, overshoot=0.0, tail_split_cap=2,
             hist_subtraction=False)),
], ids=["default", "gate_depth", "hybrid_no_subtraction"])
def test_grower_matches_jax_nan_and_categorical(num_leaves, posture):
    ds, grad, hess = _data(4000, 6, seed=2, with_nan=True, with_cat=True)
    assert ds.is_categorical.any() and (ds.missing_types == 2).any()
    jax_np, r_jax, t_torch, r_torch = _grow_both(ds, grad, hess, num_leaves,
                                                 posture)
    assert int(t_torch.num_leaves) == num_leaves
    if posture is _DEFAULT:
        assert bool(t_torch.is_cat.any())  # a categorical split was taken
    _assert_same_tree(jax_np, r_jax, t_torch, r_torch)


def test_grower_matches_jax_255_leaves():
    # overshoot 2 grows toward 510 leaves: node ids well past 256 (the
    # base-256 packing of the JAX route tables) before the prune
    ds, grad, hess = _data(20000, 8, seed=3)
    jax_np, r_jax, t_torch, r_torch = _grow_both(ds, grad, hess, 255)
    assert int(t_torch.num_leaves) == 255
    assert int(t_torch.num_nodes) == 509
    _assert_same_tree(jax_np, r_jax, t_torch, r_torch)


def test_convert_round_trips():
    rng = np.random.RandomState(0)
    m1 = 9
    arrays = {
        "split_feature": rng.randint(-1, 4, m1).astype(np.int32),
        "threshold_bin": rng.randint(0, 60, m1).astype(np.int32),
        "default_left": rng.rand(m1) < 0.5, "is_cat": rng.rand(m1) < 0.5,
        "cat_bitset": rng.randint(0, 2 ** 32, (m1, 2), dtype=np.uint64)
        .astype(np.uint32),
        "left": rng.randint(-1, m1, m1).astype(np.int32),
        "right": rng.randint(-1, m1, m1).astype(np.int32),
        "parent": rng.randint(-1, m1, m1).astype(np.int32),
        "leaf_value": rng.randn(m1).astype(np.float32),
        "sum_grad": rng.randn(m1).astype(np.float32),
        "sum_hess": rng.rand(m1).astype(np.float32),
        "count": rng.randint(0, 99, m1).astype(np.float32),
        "gain": rng.rand(m1).astype(np.float32),
        "depth": rng.randint(0, 5, m1).astype(np.int32),
        "is_leaf": rng.rand(m1) < 0.5,
        "num_nodes": np.int32(7), "num_leaves": np.int32(4)}
    arrays["cat_bitset"][0, 0] = 0xFFFFFFFF      # the top bit survives
    tree = convert.tree_arrays_from_numpy(arrays)
    assert tree.cat_bitset.dtype == torch.int64
    assert int(tree.cat_bitset[0, 0]) == 0xFFFFFFFF
    back = convert.tree_arrays_to_numpy(tree)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == np.asarray(v).dtype, k

    ds, _, _ = _data(300, 4, seed=1, with_nan=True, with_cat=True)
    state = [m.to_dict() for m in ds.mappers]
    pds = convert.binned_from_numpy(ds.bins, ds.num_bins, ds.missing_types,
                                    ds.is_categorical, state)
    # repr: the NaN bin's upper bound is NaN, which == never matches
    assert repr([m.to_dict() for m in pds.mappers]) == repr(state)
    np.testing.assert_array_equal(pds.bins, ds.bins)
    with pytest.raises(ValueError, match="num_bins"):
        convert.binned_from_numpy(ds.bins, ds.num_bins + 1, ds.missing_types,
                                  ds.is_categorical, state)
    score = convert.score_from_numpy(np.arange(5, dtype=np.float64))
    assert score.dtype == torch.float32 and score.shape == (5,)
