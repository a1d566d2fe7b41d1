"""Binned tree traversal (lightgbm_tpu_torch/learner/predict.py, the plain
versions of kernel V, csrc/predict_binned.cu) against the JAX package's
predict_binned_tree, leaf_index_tree (lightgbm_tpu/learner/predict.py)
and stacked_score_traj (lightgbm_tpu/boosting/fused.py) on the same trees
and bins.

Trees: random trees in the grower's layout (numpy seeds 0-5) with
categorical nodes, NaN bins and bitsets narrower than the bins (a bin from
32 x words up reads the last word, as the JAX gather clamps), and the
trees of a port booster trained on categorical and NaN data (seed 6).
Leaf ids and leaf indices must be equal; scores within 1e-6 absolute
(both add f32 leaf values in tree order: in practice the same bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.fused import stacked_score_traj as jax_traj
from lightgbm_tpu.learner import grower as jgrower
from lightgbm_tpu.learner import predict as jpredict
from lightgbm_tpu_torch.learner import predict
from lightgbm_tpu_torch.learner.grower import TreeArrays
from lightgbm_tpu_torch.learner.histogram_mxu import (pack_bins_4bit,
                                                      unpack_bins_4bit)
from tests.test_torch_one_thread import one_thread  # noqa: F401

ATOL = 1e-6


def _random_stack(rng, k, m1, leaves, f, bmax, words, cat_share):
    """[k, ...] TreeArrays of random trees, split leaf by leaf."""
    sf = np.full((k, m1), -1, np.int32)
    thr = np.zeros((k, m1), np.int32)
    cat = np.zeros((k, m1), bool)
    bits = np.zeros((k, m1, words), np.int64)
    left = np.full((k, m1), -1, np.int32)
    right = np.full((k, m1), -1, np.int32)
    for t in range(k):
        open_leaves, n = [0], 1
        while len(open_leaves) < leaves and n + 2 <= m1:
            j = open_leaves.pop(rng.randint(len(open_leaves)))
            sf[t, j] = rng.randint(f)
            thr[t, j] = rng.randint(bmax - 1)
            if rng.rand() < cat_share:
                cat[t, j] = True
                for b in np.nonzero(rng.rand(32 * words) < 0.5)[0]:
                    bits[t, j, b // 32] |= 1 << int(b % 32)
            left[t, j], right[t, j] = n, n + 1
            open_leaves += [n, n + 1]
            n += 2
    z = np.zeros((k, m1), np.float32)
    zi = np.zeros((k, m1), np.int32)
    arrays = dict(
        split_feature=sf, threshold_bin=thr,
        default_left=rng.rand(k, m1) < 0.5, is_cat=cat, cat_bitset=bits,
        left=left, right=right, parent=zi,
        leaf_value=(0.1 * rng.randn(k, m1)).astype(np.float32),
        sum_grad=z, sum_hess=z, count=z, gain=z, depth=zi, is_leaf=sf < 0,
        num_nodes=np.ones(k, np.int32), num_leaves=np.ones(k, np.int32))
    return TreeArrays(**{key: torch.as_tensor(v)
                         for key, v in arrays.items()})


def _to_jax(tree: TreeArrays):
    """The JAX package's TreeArrays of a port tree (uint32 bitset words)."""
    fields = {}
    for name, t in tree._asdict().items():
        a = t.numpy()
        if name == "cat_bitset":
            a = a.astype(np.uint32)
        fields[name] = jnp.asarray(a)
    return jgrower.TreeArrays(**fields)


def _inputs(rng, n, f, bmax, nan_features=(1, 3)):
    bins = rng.randint(0, bmax, (n, f)).astype(np.uint8)
    num_bins = np.full(f, bmax, np.int32)
    nan = np.zeros(f, bool)
    nan[list(nan_features)] = True
    return bins, num_bins, nan


CASES = {
    # (seed, trees, leaves, features, bins, bitset words, categorical share)
    "numerical": (0, 4, 31, 6, 64, 2, 0.0),
    "categorical": (1, 4, 31, 6, 64, 2, 0.4),
    "narrow_bitset": (2, 3, 15, 5, 200, 2, 0.6),
    "wide": (3, 2, 255, 28, 256, 8, 0.2),
    "stump": (4, 3, 2, 3, 16, 1, 0.5),
    "constant": (5, 2, 1, 3, 16, 1, 0.0),
}


def _case(name):
    seed, k, leaves, f, bmax, words, cat_share = CASES[name]
    rng = np.random.RandomState(seed)
    stack = _random_stack(rng, k, 2 * leaves, leaves, f, bmax, words,
                          cat_share)
    bins, num_bins, nan = _inputs(rng, 700, f, bmax,
                                  nan_features=range(0, f, 2))
    score0 = rng.randn(700).astype(np.float32)
    return stack, bins, num_bins, nan, score0


def _tree(stack, i):
    return TreeArrays(*[t[i] for t in stack])


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_binned_tree_and_leaf_index_equal_jax(case):
    stack, bins, num_bins, nan, _ = _case(case)
    tb, tn, tm = (torch.as_tensor(a) for a in (bins, num_bins, nan))
    jb, jn, jm = (jnp.asarray(a) for a in (bins, num_bins, nan))
    for i in range(stack.split_feature.shape[0]):
        tree = _tree(stack, i)
        jtree = _to_jax(tree)
        got = predict.predict_binned_tree(tree, tb, tn, tm).numpy()
        want = np.asarray(jpredict.predict_binned_tree(jtree, jb, jn, jm))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(
            predict.leaf_index_tree(tree, tb, tn, tm).numpy(),
            np.asarray(jpredict.leaf_index_tree(jtree, jb, jn, jm)))
        np.testing.assert_array_equal(
            predict._traverse_ref(tree, tb, tn, tm).numpy(),
            np.asarray(jpredict.leaf_node_tree(jtree, jb, jn, jm)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_score_traj_equals_jax(case):
    stack, bins, num_bins, nan, score0 = _case(case)
    tb, tn, tm = (torch.as_tensor(a) for a in (bins, num_bins, nan))
    fin, traj = predict.stacked_score_traj(stack, torch.as_tensor(score0),
                                           tb, tn, tm)
    jstack = _to_jax(stack)
    jfin, jtraj = jax_traj(jstack, jnp.asarray(score0.copy()),
                           jnp.asarray(bins), jnp.asarray(num_bins),
                           jnp.asarray(nan))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=0,
                               atol=ATOL)
    # every point is the previous one plus that tree's leaf values
    prev = torch.as_tensor(score0)
    for i in range(traj.shape[0]):
        prev = prev + predict.predict_binned_tree(_tree(stack, i), tb, tn,
                                                  tm)
        assert torch.equal(traj[i], prev)
    # the leaf ids the walk ends on
    traj2, nodes = predict.stacked_leaf_nodes(stack, tb, tn, tm,
                                              torch.as_tensor(score0))
    assert torch.equal(traj2, traj)
    for i in range(traj.shape[0]):
        np.testing.assert_array_equal(
            nodes[i].numpy(), np.asarray(jpredict.leaf_node_tree(
                _to_jax(_tree(stack, i)), jnp.asarray(bins),
                jnp.asarray(num_bins), jnp.asarray(nan))))


def test_booster_trees_categorical_nan_and_packed_bins():
    # a port booster's own trees (categorical and NaN splits) over its own
    # training bins, stored 4-bit packed and unpacked for the walk
    rng = np.random.RandomState(6)
    n = 1500
    X = rng.randn(n, 5).astype(np.float32)
    X[:, 2] = rng.randint(0, 9, n)
    X[rng.rand(n) < 0.1, 1] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) + np.isin(X[:, 2], [1, 4]) +
         0.3 * rng.randn(n) > 0.5).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
              "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu",
              "categorical_feature": "2"}
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), 6)
    gb = bst.gbdt
    assert gb._packed4
    unpacked = gb._train_bins_unpacked()
    ds_bins = torch.as_tensor(bst.train_set.binned.bins)
    assert torch.equal(unpacked, ds_bins)
    assert torch.equal(unpack_bins_4bit(torch.as_tensor(pack_bins_4bit(
        bst.train_set.binned.bins)), ds_bins.shape[1]), ds_bins)
    assert any(bool(t.is_cat.any()) for t in gb.trees)
    jb = jnp.asarray(ds_bins.numpy())
    jn = jnp.asarray(gb.num_bins_d.numpy())
    jm = jnp.asarray(gb.missing_is_nan_d.numpy())
    score = torch.zeros(n)
    for tree in gb.trees:
        got = predict.predict_binned_tree(tree, unpacked, gb.num_bins_d,
                                          gb.missing_is_nan_d)
        want = np.asarray(jpredict.predict_binned_tree(_to_jax(tree), jb,
                                                       jn, jm))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(
            predict.leaf_index_tree(tree, unpacked, gb.num_bins_d,
                                    gb.missing_is_nan_d).numpy(),
            np.asarray(jpredict.leaf_index_tree(_to_jax(tree), jb, jn, jm)))
        score = score + got
    # the walk's sum is the training score the booster kept (its first
    # tree carries the init score)
    np.testing.assert_allclose(score.numpy(), gb.train_score.numpy(),
                               rtol=0, atol=1e-5)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    # a CUDA tensor goes to the kernel (here: the launch path, which finds
    # no card) and never to the plain version
    stack, bins, num_bins, nan, score0 = _case("numerical")
    called = []
    monkeypatch.setattr(predict, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(predict, "stacked_score_traj_ref",
                        lambda *a, **k: called.append(1))

    def launch(stem, device, *args):
        called.append(stem)
    monkeypatch.setattr(predict._cuda, "call", launch)
    predict.stacked_score_traj(stack, torch.as_tensor(score0),
                               torch.as_tensor(bins),
                               torch.as_tensor(num_bins),
                               torch.as_tensor(nan))
    assert called == ["predict_binned"]
