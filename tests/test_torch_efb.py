"""Exclusive feature bundling in the port against the JAX package.

Sparse, mutually exclusive features (numpy seeds below) are bundled by
both packages. Held to the JAX package on the CPU (the JAX kernels in
Pallas interpret mode, the port's plain versions):

- the plan, the bundled matrix and the device tables bit for bit;
- expand_histograms and find_best_splits_bundled at the exact-mode bars of
  tests/test_torch_train.py (sums within rtol = atol = 1e-4, counts and
  chosen splits identical);
- route_rows and fused_route_hist in their loc-table and bundle-range
  modes against route_rows_mxu / fused_route_hist_mxu (routes identical;
  both also equal the plain routing of the unbundled matrix);
- kernel V's bundled-matrix mode against predict_binned_tree(efb=);
- EFB pinning hist_backend to mxu and keeping the bins unpacked.
Whole boosters are in tests/test_torch_efb_boosters.py, the fused
trainer in tests/test_torch_efb_fused.py (separate files, so a parallel
run spreads them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu import efb as jax_efb
from lightgbm_tpu.data import BinnedDataset as JaxBinned
from lightgbm_tpu.data import Metadata as JaxMetadata
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import predict as jax_predict
from lightgbm_tpu.learner import split as jax_split
from lightgbm_tpu.learner import split_bundled as jax_sb
from lightgbm_tpu_torch import efb as torch_efb
from lightgbm_tpu_torch.data import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import predict as torch_predict
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from lightgbm_tpu_torch.learner.split_bundled import find_best_splits_bundled
from tests.test_torch_train import _STRUCT_KEYS, _VALUE_KEYS, _trees
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _sparse_X(seed, n=3000, f=32, with_nan=False, with_cat=False):
    """f features in groups of 8, one nonzero a group and row (mutually
    exclusive), optionally a dense categorical column 3 and NaN in
    column 1."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for g in range(0, f, 8):
        which = rng.randint(g, g + 8, size=n)
        X[np.arange(n), which] = rng.rand(n) + 0.5
    if with_cat:
        X[:, 3] = rng.randint(0, 6, size=n)
    if with_nan:
        X[rng.rand(n) < 0.05, 1] = np.nan
    logit = np.nan_to_num(X[:, 0]) * 2 + X[:, 8] - X[:, 16] + \
        (X[:, 3] == 2) + 0.3 * rng.randn(n)
    return X, logit


def _binned(X, with_cat, max_bin=15):
    cat = [3] if with_cat else None
    n = X.shape[0]
    ds_t = BinnedDataset.from_raw(X, Metadata(n), max_bin=max_bin,
                                  categorical_features=cat)
    ds_j = JaxBinned.from_raw(X, JaxMetadata(n), max_bin=max_bin,
                              categorical_features=cat)
    return ds_t, ds_j


def _plans(ds_t, ds_j, seg=True):
    """(port plan, port EfbDev, JAX plan, JAX EfbDev)."""
    args_t = (ds_t.bins, ds_t.num_bins, ds_t.default_bins,
              np.asarray(ds_t.is_categorical))
    plan_t = torch_efb.build_plan(*args_t, max_bundle_bins=256)
    plan_j = jax_efb.build_plan(np.asarray(ds_j.bins), ds_j.num_bins,
                                ds_j.default_bins,
                                np.asarray(ds_j.is_categorical),
                                max_bundle_bins=256)
    meta_t = dict(num_bins=ds_t.num_bins,
                  missing_is_nan=ds_t.missing_types == 2,
                  is_cat=np.asarray(ds_t.is_categorical)) if seg else {}
    meta_j = dict(num_bins=ds_j.num_bins,
                  missing_is_nan=ds_j.missing_types == 2,
                  is_cat=np.asarray(ds_j.is_categorical)) if seg else {}
    efb_t = torch_efb.make_device_tables(plan_t, ds_t.default_bins, **meta_t)
    efb_j = jax_efb.make_device_tables(plan_j, ds_j.default_bins, **meta_j)
    return plan_t, efb_t, plan_j, efb_j


_CASES = {"plain": (False, False), "nan_cat": (True, True)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plan_and_tables_bit_equal(case):
    with_nan, with_cat = _CASES[case]
    X, _ = _sparse_X(0, with_nan=with_nan, with_cat=with_cat)
    ds_t, ds_j = _binned(X, with_cat)
    np.testing.assert_array_equal(ds_t.bins, np.asarray(ds_j.bins))
    plan_t, efb_t, plan_j, efb_j = _plans(ds_t, ds_j)
    assert plan_t.effective and plan_t.num_cols < X.shape[1]
    assert plan_t.bundles == plan_j.bundles
    for fld in ("col_of_feat", "seg_lo", "seg_hi", "is_multi",
                "pos_of_local", "local_of_pos", "col_bins"):
        np.testing.assert_array_equal(getattr(plan_t, fld),
                                      getattr(plan_j, fld), err_msg=fld)
    assert (plan_t.num_cols, plan_t.bundle_bmax) == \
        (plan_j.num_cols, plan_j.bundle_bmax)
    bund_t = torch_efb.bundle_matrix(ds_t.bins, plan_t)
    bund_j = jax_efb.bundle_matrix(np.asarray(ds_j.bins), plan_j)
    assert bund_t.dtype == bund_j.dtype == np.uint8
    np.testing.assert_array_equal(bund_t, bund_j)
    for fld in ("col_of_feat", "seg_lo", "seg_hi", "flat_pos",
                "is_default_pos", "is_valid_pos", "loc_table"):
        np.testing.assert_array_equal(getattr(efb_t, fld).numpy(),
                                      np.asarray(getattr(efb_j, fld)),
                                      err_msg=fld)
    assert efb_t.num_cols == efb_j.num_cols
    assert efb_t.bundle_bmax == efb_j.bundle_bmax
    for fld in torch_efb.EfbScan._fields:
        np.testing.assert_array_equal(getattr(efb_t.scan, fld).numpy(),
                                      np.asarray(getattr(efb_j.scan, fld)),
                                      err_msg=fld)


def _bundled_hist(seed, with_nan, with_cat, num_slots=6):
    """Histograms of the bundled and the unbundled matrix over the same
    random slots, and everything to scan them."""
    X, logit = _sparse_X(seed, with_nan=with_nan, with_cat=with_cat)
    ds_t, ds_j = _binned(X, with_cat)
    plan_t, efb_t, plan_j, efb_j = _plans(ds_t, ds_j)
    bund = torch.as_tensor(torch_efb.bundle_matrix(ds_t.bins, plan_t))
    rng = np.random.RandomState(seed + 10)
    n = X.shape[0]
    grad = torch.as_tensor(
        (1 / (1 + np.exp(-logit)) - (logit > 0.5)).astype(np.float32))
    hess = torch.as_tensor(rng.uniform(0.1, 0.3, n).astype(np.float32))
    cnt = torch.ones(n)
    slot = torch.as_tensor(rng.randint(0, num_slots, n).astype(np.int32))
    kw = dict(num_slots=num_slots)
    hb = torch_k.build_histograms(bund, grad, hess, cnt, slot,
                                  bmax=efb_t.bundle_bmax, **kw)
    hu = torch_k.build_histograms(torch.as_tensor(ds_t.bins), grad, hess,
                                  cnt, slot, bmax=int(ds_t.num_bins.max()),
                                  **kw)
    return ds_t, ds_j, efb_t, efb_j, hb, hu


@pytest.mark.parametrize("case", sorted(_CASES))
def test_expand_histograms_matches_jax(case):
    ds_t, ds_j, efb_t, efb_j, hb, hu = _bundled_hist(1, *_CASES[case])
    got = torch_efb.expand_histograms(hb, efb_t)
    want = np.asarray(jax_efb.expand_histograms(jnp.asarray(hb.numpy()),
                                                efb_j))
    assert got.shape == want.shape == hu.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # conflict rate 0: the expansion is the unbundled histogram (counts
    # exactly, sums to the default bin's subtraction)
    np.testing.assert_array_equal(got[..., 2].numpy(), hu[..., 2].numpy())
    np.testing.assert_allclose(got.numpy(), hu.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", sorted(_CASES) + ["extra_trees"])
def test_find_best_splits_bundled_matches_jax(case):
    extra = case == "extra_trees"
    with_nan, with_cat = _CASES.get(case, (True, False))
    ds_t, ds_j, efb_t, efb_j, hb, _ = _bundled_hist(2, with_nan, with_cat)
    s = hb.shape[0]
    tot = hb[:, 0].sum(dim=1)                      # any column's total
    f = len(ds_t.num_bins)
    fmask = np.ones((s, f), np.float32)
    fmask[1, 5] = 0.0
    rand = np.random.RandomState(4).randint(0, 16, (s, f)).astype(np.int32) \
        if extra else None
    hp = dict(min_data_in_leaf=20, has_categorical=with_cat,
              extra_trees=extra)
    pout = np.zeros(s, np.float32)
    common = (ds_t.num_bins, ds_t.missing_types == 2,
              np.asarray(ds_t.is_categorical), fmask)
    bs_t = find_best_splits_bundled(
        hb, tot[:, 0], tot[:, 1], tot[:, 2], torch.as_tensor(pout),
        *[torch.as_tensor(a) for a in common], SplitHyperParams(**hp), efb_t,
        rand_bins=None if rand is None else torch.as_tensor(rand))
    bs_j = jax_sb.find_best_splits_bundled(
        jnp.asarray(hb.numpy()), *[jnp.asarray(tot[:, c].numpy())
                                   for c in range(3)],
        jnp.asarray(pout), *[jnp.asarray(a) for a in common],
        jax_split.SplitHyperParams(**hp), efb_j,
        rand_bins=None if rand is None else jnp.asarray(rand))
    for fld in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(bs_t, fld).numpy(),
                                      np.asarray(getattr(bs_j, fld)),
                                      err_msg=fld)
    assert (bs_t.feature.numpy() >= 0).all()
    for fld in ("gain", "left_grad", "left_hess", "left_output",
                "right_output"):
        np.testing.assert_allclose(getattr(bs_t, fld).numpy(),
                                   np.asarray(getattr(bs_j, fld)),
                                   rtol=1e-4, atol=1e-4, err_msg=fld)
    np.testing.assert_array_equal(bs_t.left_count.numpy(),
                                  np.asarray(bs_j.left_count))


M1, M_PAD, NUM_SLOTS = 300, 384, 12


def _route_inputs(seed, efb_t, ds_t):
    """A random pass's split tables over original features: bundled,
    identity, NaN and categorical ones, thresholds over each feature's
    bins."""
    rng = np.random.RandomState(seed)
    f = len(ds_t.num_bins)
    nb = ds_t.num_bins
    bmax = int(nb.max())
    split = rng.rand(M1) < 0.7
    split[M1 - 1] = False
    feat = rng.randint(0, f, M1).astype(np.int32)
    feat[:20] = 1
    is_cat = np.asarray(ds_t.is_categorical)[feat]
    thr = (rng.rand(M1) * np.maximum(nb[feat] - 1, 1)).astype(np.int32)
    default_left = rng.rand(M1) < 0.5
    child_l = rng.randint(0, M1, M1).astype(np.int32)
    child_r = rng.randint(0, M1, M1).astype(np.int32)
    slot_of_node = rng.randint(-1, NUM_SLOTS + 3, M1).astype(np.int32)
    words = (bmax + 31) // 32
    cat_bitset = rng.randint(0, 2 ** 32, (M1, words), dtype=np.uint64) \
        .astype(np.uint32)
    cat_bitset[~is_cat] = 0
    row_node = rng.randint(0, M1, ds_t.num_data).astype(np.int32)
    return dict(split=split, feat=feat, thr=thr, default_left=default_left,
                is_cat=is_cat, child_l=child_l, child_r=child_r,
                slot_of_node=slot_of_node, cat_bitset=cat_bitset,
                row_node=row_node, bmax=bmax)


def _route_tables(d, efb_t, efb_j, ds_t, with_efb=True):
    bcol_np = np.asarray(efb_t.col_of_feat)[d["feat"]]
    t = {k: torch.as_tensor(d[k]) for k in (
        "split", "feat", "thr", "default_left", "is_cat", "child_l",
        "child_r", "slot_of_node")}
    tbl_t, member_t = torch_k.pack_route_tables(
        *t.values(), torch.as_tensor(d["cat_bitset"].astype(np.int64)),
        M_PAD, bcol=torch.as_tensor(bcol_np) if with_efb else None,
        efb=efb_t if with_efb else None)
    tbl_j, member_j = jax_k.pack_route_tables(
        *[jnp.asarray(d[k]) for k in t], jnp.asarray(d["cat_bitset"]),
        M_PAD, d["bmax"], bcol=jnp.asarray(bcol_np), efb=efb_j)
    ftbl_t = torch.stack([torch.as_tensor(ds_t.num_bins),
                          torch.as_tensor(ds_t.missing_types == 2)
                          .to(torch.int32)], dim=1)
    ftbl_j = jnp.asarray(ftbl_t.numpy().astype(np.float32))
    return tbl_t, member_t, ftbl_t, tbl_j, member_j, ftbl_j


@pytest.mark.parametrize("mode", ["loc_table", "efb_range"])
def test_route_rows_efb_matches_jax(mode):
    rng_case = mode == "efb_range"
    X, _ = _sparse_X(3, with_nan=True, with_cat=True)
    ds_t, ds_j = _binned(X, True)
    plan_t, efb_t, plan_j, efb_j = _plans(ds_t, ds_j, seg=rng_case)
    d = _route_inputs(5, efb_t, ds_t)
    bund = torch.as_tensor(torch_efb.bundle_matrix(ds_t.bins, plan_t))
    tbl_t, member_t, ftbl_t, tbl_j, member_j, ftbl_j = \
        _route_tables(d, efb_t, efb_j, ds_t)
    kw_t = dict(efb_range=True) if rng_case else \
        dict(loc_table=efb_t.loc_table)
    kw_j = dict(efb_range=True) if rng_case else \
        dict(loc_table=efb_j.loc_table)
    rn_t, rs_t, cnt_t = torch_k.route_rows(
        bund, torch.as_tensor(d["row_node"]), tbl_t, member_t, ftbl_t,
        emit_counts=True, num_slots=NUM_SLOTS, **kw_t)
    rn_j, rs_j, cnt_j = jax_k.route_rows_mxu(
        jnp.asarray(bund.numpy()), jnp.asarray(d["row_node"]), tbl_j,
        member_j, ftbl_j, emit_counts=True, num_slots=NUM_SLOTS,
        interpret=True, **kw_j)
    np.testing.assert_array_equal(rn_t.numpy(), np.asarray(rn_j))
    np.testing.assert_array_equal(rs_t.numpy(), np.asarray(rs_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    # the same routes as the plain mode on the unbundled matrix
    tbl_u, member_u, ftbl_u = _route_tables(d, efb_t, efb_j, ds_t,
                                            with_efb=False)[:3]
    rn_u, rs_u = torch_k.route_rows(
        torch.as_tensor(ds_t.bins), torch.as_tensor(d["row_node"]), tbl_u,
        member_u, ftbl_u)
    np.testing.assert_array_equal(rn_t.numpy(), rn_u.numpy())
    np.testing.assert_array_equal(rs_t.numpy(), rs_u.numpy())
    # every decision kind was taken: bundled, NaN and categorical nodes
    node = d["row_node"]
    routed = d["split"][node]
    multi = plan_t.is_multi[d["feat"][node]]
    assert (routed & multi).any() and (routed & d["is_cat"][node]).any()
    assert (routed & (d["feat"][node] == 1) &
            (ds_t.bins[:, 1] == ds_t.num_bins[1] - 1)).any()


@pytest.mark.parametrize("mode", ["loc_table", "efb_range"])
def test_fused_route_hist_efb_matches_jax(mode):
    rng_case = mode == "efb_range"
    X, logit = _sparse_X(4, with_nan=True, with_cat=True)
    ds_t, ds_j = _binned(X, True)
    plan_t, efb_t, plan_j, efb_j = _plans(ds_t, ds_j, seg=rng_case)
    d = _route_inputs(6, efb_t, ds_t)
    bund = torch.as_tensor(torch_efb.bundle_matrix(ds_t.bins, plan_t))
    tabs = _route_tables(d, efb_t, efb_j, ds_t)
    rng = np.random.RandomState(7)
    n = X.shape[0]
    grad = rng.randn(n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    cnt = np.ones(n, np.float32)
    bb = efb_t.bundle_bmax
    kw_t = dict(efb_range=True) if rng_case else \
        dict(loc_table=efb_t.loc_table)
    kw_j = dict(efb_range=True) if rng_case else \
        dict(loc_table=efb_j.loc_table)
    h_t, rn_t = torch_k.fused_route_hist(
        bund, *[torch.as_tensor(a) for a in (grad, hess, cnt,
                                             d["row_node"])],
        *tabs[:3], num_slots=NUM_SLOTS, bmax=bb, **kw_t)
    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(bund.numpy()), *[jnp.asarray(a) for a in (
            grad, hess, cnt, d["row_node"])], *tabs[3:],
        num_slots=NUM_SLOTS, bmax=bb, has_cat=True, row_block=1024,
        interpret=True, **kw_j)
    np.testing.assert_array_equal(rn_t.numpy(), np.asarray(rn_j))
    h_j = np.asarray(h_j)
    assert h_t.shape == h_j.shape == (NUM_SLOTS, plan_t.num_cols, bb, 3)
    np.testing.assert_array_equal(h_t[..., 2].numpy(), h_j[..., 2])
    np.testing.assert_allclose(h_t[..., :2].numpy(), h_j[..., :2],
                               rtol=1e-4, atol=1e-4)
    assert h_t[..., 2].sum() > 0


def _assert_same_model(s_a, s_b, tol, skip=()):
    """Every tree's structure identical (but the keys in `skip`); leaf
    values, internal values and split gains within rtol = atol = tol (a
    gain's atol scaled by the tree's largest gain, as in
    tests/test_torch_train.py)."""
    t_a, t_b = _trees(s_a), _trees(s_b)
    assert len(t_a) == len(t_b)
    for i, (a, b) in enumerate(zip(t_a, t_b)):
        assert set(a) == set(b), i
        for key in _STRUCT_KEYS:
            if key in a and key not in skip:
                assert a[key] == b[key], (i, key)
        for key in _VALUE_KEYS:
            if key in a:
                va = np.asarray(a[key].split(" "), np.float64)
                vb = np.asarray(b[key].split(" "), np.float64)
                atol = tol * (np.abs(va).max() if key == "split_gain"
                              else 1.0)
                np.testing.assert_allclose(vb, va, rtol=tol, atol=atol,
                                           err_msg=f"tree {i} {key}")


def _port_booster(X, y, params, rounds):
    """The port's booster on the MXU grower under EFB (efb_use_mxu, unless
    the params say otherwise: the JAX package's accelerator path for
    bundled data at that setting), `rounds` update() calls."""
    p = dict(params, device_type="cpu")
    p.setdefault("efb_use_mxu", True)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for _ in range(rounds):
        bst.update()
    return bst


# min_gain_to_split: on this data a pure node (every row at one gradient
# to hessian ratio) has splits whose true gain is 0 and whose f32 gain is
# a few ulps of the node's own gain (about 1e-5 here), positive or not as
# the order of the sums goes; the JAX package's bundled and unbundled
# models part on them as often as either parts from the port's (ROADMAP
# C3). The gate keeps them out of all four here;
# tests/test_torch_efb_min_gain.py runs the boosters at 0 and pins them.
_BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1}
def test_predict_bundled_matches_jax():
    """Kernel V's bundled-matrix mode (its plain version here) against the
    JAX package's predict_binned_tree(efb=), on the trees of a bundled
    booster, and against the unbundled traversal of the same rows."""
    X, logit = _sparse_X(6, n=2000, with_nan=True, with_cat=True)
    y = (logit > np.median(logit)).astype(np.float32)
    params = dict(_BASE, categorical_feature="3", device_type="cpu")
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), 3)
    g = bst.gbdt
    efb_t = g._efb
    ds_j = JaxBinned.from_raw(X, JaxMetadata(len(y)), max_bin=15,
                              categorical_features=[3])
    plan_j = jax_efb.build_plan(np.asarray(ds_j.bins), ds_j.num_bins,
                                ds_j.default_bins,
                                np.asarray(ds_j.is_categorical))
    efb_j = jax_efb.make_device_tables(plan_j, ds_j.default_bins)
    unbundled = torch.as_tensor(g.train_set.bins)
    from lightgbm_tpu.learner.grower import TreeArrays as JaxTree
    for tree in g.trees:
        got = torch_predict.predict_binned_tree(
            tree, g.bins, g.num_bins_d, g.missing_is_nan_d, efb=efb_t)
        jt = JaxTree(*[jnp.asarray(t.numpy().astype(np.uint32)
                                   if t.dtype == torch.int64 else t.numpy())
                       for t in tree])
        want = jax_predict.predict_binned_tree(
            jt, jnp.asarray(g.bins.numpy()), jnp.asarray(ds_j.num_bins),
            jnp.asarray(ds_j.missing_types == 2), efb_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        plain = torch_predict.predict_binned_tree(
            tree, unbundled, g.num_bins_d, g.missing_is_nan_d)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    stacked = type(g.trees[0])(*[torch.stack(t) for t in
                                 zip(*g.trees[1:])])
    score0 = torch.zeros(len(y))
    fin, traj = torch_predict.stacked_score_traj(
        stacked, score0, g.bins, g.num_bins_d, g.missing_is_nan_d,
        efb=efb_t)
    fin_u, traj_u = torch_predict.stacked_score_traj(
        stacked, score0, unbundled, g.num_bins_d, g.missing_is_nan_d)
    np.testing.assert_array_equal(traj.numpy(), traj_u.numpy())


def test_efb_pins_mxu_and_stores_no_packed_bins():
    X, logit = _sparse_X(8, n=1500)
    y = (logit > np.median(logit)).astype(np.float32)
    params = dict(_BASE, device_type="cpu", hist_backend="pallas")
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    g = bst.gbdt
    assert g._efb is not None and not g._packed4
    assert g._mxu_grow_kwargs()["hist_backend"] == "mxu"
    bst.update()
    plain = lgt.Booster(dict(params, enable_bundle=False),
                        lgt.Dataset(X, label=y, params=params))
    assert plain.gbdt._efb is None and plain.gbdt._packed4
