"""The Dataset surface of the port against the JAX package, on the CPU.

Exact bars throughout (both packages bin the same numpy data with the same
mapper search): the field accessors and setters, num_data/num_feature,
subset on ungrouped data (bins, mappers, metadata), the binary cache read
by the other package in both directions (bins, mappers compared NaN-aware
as ROADMAP's Settled rules say, metadata, raw values of linear trees), a
CSV and a TSV path against the same array, set_categorical_feature before
and after construction. On grouped data the port's subset keeps the
selected queries' boundaries and refuses indices that cut a query
(ROADMAP C23; the JAX package drops the boundaries). Data from the numpy
seeds stated in _data.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.data import BinnedDataset as JBinned
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.data import BinnedDataset
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"max_bin": 31, "verbosity": -1}


def _data(n=240, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[:, 3] = rng.randint(0, 4, n)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    w = rng.rand(n) + 0.5
    init = 0.1 * rng.randn(n)
    return X, y, w, init


def _mappers(binned):
    return [repr(m.to_dict()) for m in binned.mappers]


def _same_binned(a, b):
    np.testing.assert_array_equal(a.bins, b.bins)
    np.testing.assert_array_equal(a.used_features, b.used_features)
    assert a.num_total_features == b.num_total_features
    assert list(a.feature_names) == list(b.feature_names)
    assert _mappers(a) == _mappers(b)
    for fld in ("label", "weight", "init_score", "query_boundaries"):
        va, vb = getattr(a.metadata, fld), getattr(b.metadata, fld)
        assert (va is None) == (vb is None), fld
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=fld)
    assert (a.raw is None) == (b.raw is None)
    if a.raw is not None:
        np.testing.assert_array_equal(a.raw, b.raw)


def _pair(**kw):
    X, y, w, init = _data()
    args = dict(label=y, weight=w, init_score=init, params=PARAMS)
    args.update(kw)
    return lgb.Dataset(X, **args), lgt.Dataset(X, **args)


def test_fields_and_sizes_match_jax():
    j, t = _pair(group=[40] * 6)
    for fld in ("label", "weight", "group", "init_score"):
        np.testing.assert_array_equal(t.get_field(fld), j.get_field(fld))
    assert t.num_data() == j.num_data() == 240
    assert t.num_feature() == j.num_feature() == 5
    _same_binned(j.binned, t.binned)
    rng = np.random.RandomState(4)
    new = {"label": (rng.rand(240) > 0.5).astype(np.float64),
           "weight": rng.rand(240) + 1.0, "group": [60] * 4,
           "init_score": rng.randn(240)}
    for fld, v in new.items():
        assert t.set_field(fld, v) is t
        j.set_field(fld, v)
        np.testing.assert_array_equal(t.get_field(fld), j.get_field(fld))
    _same_binned(j.binned, t.binned)
    np.testing.assert_array_equal(t.binned.metadata.query_boundaries,
                                  [0, 60, 120, 180, 240])


def test_set_init_score_drops_a_continuation_seed():
    X, y, _, _ = _data()
    params = dict(PARAMS, objective="binary", num_leaves=4, device_type="cpu")
    base = lgt.train(params, lgt.Dataset(X, label=y), 2)
    ds = lgt.Dataset(X, label=y, free_raw_data=False)
    lgt.train(params, ds, 2, init_model=base)
    assert ds._seeded_init_score
    ds.set_init_score(np.zeros(240))
    assert not ds._seeded_init_score
    with pytest.raises(ValueError, match="already has init_score"):
        lgt.train(params, ds, 1, init_model=base)


def test_subset_matches_jax_on_ungrouped_data():
    j, t = _pair()
    idx = np.sort(np.random.RandomState(5).choice(240, 150, replace=False))
    sj, st = j.subset(idx), t.subset(idx)
    _same_binned(sj.binned, st.binned)
    assert st.num_data() == 150 and st.reference is t
    # a subset trains like the same rows binned by reference
    params = dict(PARAMS, objective="binary", num_leaves=5,
                  device_type="cpu")
    X, y, w, init = _data()
    a = lgt.train(params, st, 3)
    b = lgt.train(params, lgt.Dataset(X[idx], label=y[idx], weight=w[idx],
                                      init_score=init[idx], reference=t), 3)
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("linear", [False, True])
def test_binary_cache_across_packages(tmp_path, direction, linear):
    params = dict(PARAMS, linear_tree=True) if linear else PARAMS
    j, t = _pair(group=[40] * 6, params=params)
    path = str(tmp_path / "cache.bin")
    if direction == "port_to_jax":
        t.save_binary(path)
        assert JBinned.is_binary_file(path)
        _same_binned(JBinned.load_binary(path), t.binned)
        _same_binned(lgb.Dataset(path).binned, t.binned)
    else:
        j.save_binary(path)
        assert BinnedDataset.is_binary_file(path)
        _same_binned(j.binned, BinnedDataset.load_binary(path))
        _same_binned(j.binned, lgt.Dataset(path).binned)
    assert not BinnedDataset.is_binary_file(str(tmp_path / "missing"))


def test_binary_cache_metadata_override_and_valid_alignment(tmp_path):
    _, t = _pair()
    path = str(tmp_path / "train.bin")
    t.save_binary(path)
    y2 = np.ones(240)
    over = lgt.Dataset(path, label=y2, group=[120, 120])
    np.testing.assert_array_equal(over.binned.metadata.label, y2)
    np.testing.assert_array_equal(over.binned.metadata.query_boundaries,
                                  [0, 120, 240])
    np.testing.assert_array_equal(over.binned.metadata.weight,
                                  t.binned.metadata.weight)
    # a cached valid set must hold its reference's mappers
    assert lgt.Dataset(path, reference=t).construct().num_data() == 240
    X2 = np.random.RandomState(9).randn(240, 5) * 10
    other = lgt.Dataset(X2, label=y2, params=PARAMS)
    with pytest.raises(ValueError, match="different bin mappers"):
        lgt.Dataset(path, reference=other).construct()


def test_save_binary_drops_a_continuation_seed(tmp_path):
    X, y, _, _ = _data()
    params = dict(PARAMS, objective="binary", num_leaves=4, device_type="cpu")
    base = lgt.train(params, lgt.Dataset(X, label=y), 2)
    ds = lgt.Dataset(X, label=y, free_raw_data=False)
    lgt.train(params, ds, 2, init_model=base)
    path = str(tmp_path / "seeded.bin")
    ds.save_binary(path)
    assert BinnedDataset.load_binary(path).metadata.init_score is None
    assert ds.binned.metadata.init_score is not None


@pytest.mark.parametrize("delim", [",", "\t"])
def test_text_file_path_matches_the_array(tmp_path, delim):
    X, y, _, _ = _data()
    path = str(tmp_path / "train.txt")
    np.savetxt(path, np.column_stack([y, X]), delimiter=delim,
               fmt="%.17g")
    t = lgt.Dataset(path, params=PARAMS)
    ref = lgt.Dataset(X, label=y, params=PARAMS)
    _same_binned(ref.binned, t.binned)
    _same_binned(lgb.Dataset(path, params=PARAMS).binned, t.binned)
    assert t.data is None           # free_raw_data


def test_set_categorical_feature_matches_jax():
    X, y, _, _ = _data()
    # before construction: the next construct bins feature 3 as categorical
    j = lgb.Dataset(X, label=y, params=PARAMS)
    t = lgt.Dataset(X, label=y, params=PARAMS)
    assert t.set_categorical_feature([3]) is t
    j.set_categorical_feature([3])
    _same_binned(j.binned, t.binned)
    assert t.binned.is_categorical.tolist() == [False] * 3 + [True, False]
    # after construction with the raw data kept: rebuilt with the new set
    t2 = lgt.Dataset(X, label=y, params=PARAMS, free_raw_data=False)
    t2.construct()
    assert not t2.binned.is_categorical.any()
    t2.set_categorical_feature([3])
    _same_binned(t.binned, t2.binned)
    # after construction with the raw data freed: refused
    t3 = lgt.Dataset(X, label=y, params=PARAMS).construct()
    with pytest.raises(lgt.LightGBMError, match="free_raw_data=False"):
        t3.set_categorical_feature([3])
    # the same set again changes nothing
    assert t3.set_categorical_feature("auto") is t3


def test_subset_keeps_whole_queries():
    X, y, _, _ = _data()
    sizes = np.array([30, 50, 20, 40, 60, 40])
    t = lgt.Dataset(X, label=y, group=sizes, params=PARAMS)
    b = np.concatenate([[0], np.cumsum(sizes)])
    pick = [4, 1, 1, 5]          # out of order and repeated
    rows = np.concatenate([np.arange(b[q], b[q + 1]) for q in pick])
    sub = t.subset(rows)
    np.testing.assert_array_equal(sub.binned.metadata.query_boundaries,
                                  np.concatenate([[0],
                                                  np.cumsum(sizes[pick])]))
    np.testing.assert_array_equal(sub.binned.bins, t.binned.bins[rows])
    # the JAX package drops the boundaries (ROADMAP C23)
    j = lgb.Dataset(X, label=y, group=sizes, params=PARAMS)
    assert j.subset(rows).binned.metadata.query_boundaries is None
    assert t.subset(np.zeros(0, np.int64)).num_data() == 0


@pytest.mark.parametrize("rows", [
    np.arange(0, 29),                            # a query's first rows
    np.arange(1, 30),                            # its last rows
    np.concatenate([np.arange(30, 80)[::-1]]),   # out of order
    np.concatenate([np.arange(0, 30), np.arange(31, 80)]),   # a gap
])
def test_subset_refuses_a_cut_query(rows):
    X, y, _, _ = _data()
    t = lgt.Dataset(X, label=y, group=[30, 50, 20, 40, 60, 40],
                    params=PARAMS)
    with pytest.raises(lgt.LightGBMError, match="cut query"):
        t.subset(rows)
