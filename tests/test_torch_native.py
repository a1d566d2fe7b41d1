"""The port's native host runtime (lightgbm_tpu_torch/cext: C++ built with
g++ at first use) against the port's numpy plain versions and against the
JAX package's own native runtime (lightgbm_tpu/cext).

Binning: bin mappers compared with repr (a NaN bound equals itself there)
and bin matrices byte for byte, in the cases of tests/test_native.py
(dense gaussian, sparse with NaN, few distinct values and constants,
zero_as_missing, negative-heavy), plus the sampled path (more rows than
bin_construct_sample_cnt: the native sample transpose) and a categorical
column. Prediction: raw scores bit for bit (tolerance 0: both add each
row's leaf values in tree order in float64), leaf indices equal, with
start_iteration / num_iteration. Data from numpy seeds 0-9, stated in
each case.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu.binning as jbinning
import lightgbm_tpu.cext as jcext
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import binning, cext
from lightgbm_tpu_torch.data import BinnedDataset, Metadata
from tests.test_torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_gaussian():
    r = np.random.RandomState(0)
    return r.randn(5000, 8).astype(np.float32), {"max_bin": 63}


def _sparse_with_nan():
    r = np.random.RandomState(1)
    X = np.zeros((4000, 6))
    mask = r.rand(4000, 6) < 0.1
    X[mask] = r.randn(int(mask.sum())) + 1.0
    X[r.rand(4000, 6) < 0.03] = np.nan
    return X, {"max_bin": 63}


def _few_distinct():
    r = np.random.RandomState(2)
    X = np.stack([r.randint(0, 4, 3000).astype(np.float64),
                  np.full(3000, 2.5), np.zeros(3000),
                  np.where(r.rand(3000) < 0.5, -1.25, 3.75)], axis=1)
    return X, {"max_bin": 255}


def _zero_as_missing():
    r = np.random.RandomState(3)
    X = np.zeros((3000, 4))
    m = r.rand(3000, 4) < 0.4
    X[m] = r.randn(int(m.sum()))
    return X, {"max_bin": 63, "zero_as_missing": True}


def _negative_heavy():
    r = np.random.RandomState(4)
    return -np.abs(r.randn(4000, 5)) - 0.5, {"max_bin": 31}


def _large_sampled():
    # more rows than the sample: the native gather + transpose; and more
    # than 10,000 rows: the native whole-matrix quantization
    r = np.random.RandomState(5)
    X = r.randn(24000, 6).astype(np.float32)
    X[r.rand(24000) < 0.05, 2] = np.nan
    return X, {"max_bin": 255, "sample_cnt": 9000}


def _categorical():
    r = np.random.RandomState(6)
    X = r.randn(15000, 5)
    X[:, 2] = r.randint(0, 7, 15000)
    X[r.rand(15000) < 0.05, 0] = np.nan
    return X, {"max_bin": 63, "categorical_features": [2]}


CASES = {"dense_gaussian": _dense_gaussian,
         "sparse_with_nan": _sparse_with_nan,
         "few_distinct": _few_distinct,
         "zero_as_missing": _zero_as_missing,
         "negative_heavy": _negative_heavy,
         "large_sampled": _large_sampled,
         "categorical": _categorical}


def _reprs(mappers):
    return [repr(m.to_dict()) for m in mappers]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_mappers_native_equal_numpy_and_jax(case):
    X, kw = CASES[case]()
    native = binning.find_bin_mappers(X, native=True, **kw)
    plain = binning.find_bin_mappers(X, native=False, **kw)
    assert _reprs(native) == _reprs(plain)
    # the JAX package dispatches to its own native runtime the same way
    assert jcext.available()
    assert _reprs(native) == _reprs(jbinning.find_bin_mappers(X, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_matrix_native_equal_numpy_and_jax(case):
    X, kw = CASES[case]()
    # above 10,000 rows bin_columns takes the native quantization
    X = np.concatenate([X] * (1 + 10000 // len(X)))
    mappers = binning.find_bin_mappers(X, **kw)
    idx = np.arange(X.shape[1])
    native = binning.bin_columns(X, idx, mappers, np.uint8, native=True)
    plain = binning.bin_columns(X, idx, mappers, np.uint8, native=False)
    assert native.dtype == plain.dtype == np.uint8
    assert np.array_equal(native, plain)
    jmappers = jbinning.find_bin_mappers(X, **kw)
    assert np.array_equal(native, jbinning.bin_columns(X, idx, jmappers,
                                                       np.uint8))


def test_binned_dataset_native_equal_numpy():
    X, kw = _large_sampled()
    md = Metadata(len(X), label=np.zeros(len(X), np.float32))
    a = BinnedDataset.from_raw(X, md, max_bin=kw["max_bin"],
                               sample_cnt=kw["sample_cnt"], native=True)
    b = BinnedDataset.from_raw(X, md, max_bin=kw["max_bin"],
                               sample_cnt=kw["sample_cnt"], native=False)
    assert _reprs(a.mappers) == _reprs(b.mappers)
    assert np.array_equal(a.used_features, b.used_features)
    assert a.bins.dtype == b.bins.dtype and np.array_equal(a.bins, b.bins)


@pytest.mark.parametrize("seed", [7, 8])
def test_greedy_find_bin_native_equal_numpy(seed):
    r = np.random.RandomState(seed)
    distinct = np.unique(np.round(r.randn(3000) * 50, 1))
    counts = r.randint(1, 40, len(distinct))
    for max_bin in (15, 63, 255):
        args = (distinct, counts, max_bin, int(counts.sum()), 3)
        assert binning._greedy_find_bin(*args, native=True) == \
            binning._greedy_find_bin(*args, native=False)


def test_import_compiles_nothing():
    # a fresh interpreter in which any compiler call fails imports the
    # package and every module that holds native code
    code = ("import subprocess\n"
            "def no(*a, **k): raise AssertionError('compiled at import')\n"
            "subprocess.run = subprocess.Popen = no\n"
            "import lightgbm_tpu_torch, lightgbm_tpu_torch.cext, "
            "lightgbm_tpu_torch.binning, lightgbm_tpu_torch.tree, "
            "lightgbm_tpu_torch.learner.predict\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_build_flags_recorded():
    cext.build_all()
    for stem in cext.SOURCES:
        flags = cext.FLAGS_USED[stem]
        assert flags[:4] == ("-O3", "-shared", "-fPIC", "-std=c++17")


def test_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                          tmp_path):
    # a source g++ refuses: no quiet fallback to numpy
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cext, "_DIR", tmp_path)
    monkeypatch.setattr(cext, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "_build").mkdir()
    with pytest.raises(RuntimeError, match="failed to build"):
        cext._build("broken")


def _model(seed=9):
    r = np.random.RandomState(seed)
    X = r.randn(6000, 8).astype(np.float32)
    X[r.rand(6000) < 0.05, 2] = np.nan
    X[:, 3] = r.randint(0, 10, 6000)
    y = (np.nan_to_num(X[:, 0]) + 0.5 * X[:, 1] + (X[:, 3] > 5) +
         0.3 * r.randn(6000) > 0.5).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "device_type": "cpu"}
    bst = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=[3],
                                        params=params), 12)
    assert "cat_boundaries" in bst.model_to_string()
    # rows the model never saw: unseen categories, NaN, negatives
    Xt = r.randn(3000, 8).astype(np.float32)
    Xt[r.rand(3000) < 0.1, 2] = np.nan
    Xt[:, 3] = r.randint(-2, 14, 3000)
    return bst, Xt


@pytest.mark.parametrize("window", [(0, None), (3, 5), (10, 0)])
@pytest.mark.parametrize("raw", [True, False])
def test_predict_native_equals_numpy_walk(window, raw):
    bst, X = _model()
    model = bst._host_model()
    start, num = window
    kw = dict(start_iteration=start, num_iteration=num, raw_score=raw)
    native = model.predict(X, native=True, **kw)
    plain = model.predict(X, native=False, **kw)
    # bit for bit: the same float64 adds in the same order
    assert native.dtype == plain.dtype == np.float64
    assert np.array_equal(native, plain)
    assert np.array_equal(bst.predict(X, **kw), native)


@pytest.mark.parametrize("window", [(0, None), (4, 6)])
def test_pred_leaf_native_equals_numpy_walk(window):
    bst, X = _model()
    model = bst._host_model()
    start, num = window
    native = model.predict(X, start_iteration=start, num_iteration=num,
                           pred_leaf=True)
    plain = model.predict(X, start_iteration=start, num_iteration=num,
                          pred_leaf=True, native=False)
    assert native.dtype == np.int32 and native.shape == plain.shape
    assert np.array_equal(native, plain)
    assert np.array_equal(bst.predict(X, start_iteration=start,
                                      num_iteration=num, pred_leaf=True),
                          native)


def test_predict_equals_jax_native_predictor():
    # one model text loaded by both packages (text values are rounded, so
    # both load it), through each package's own native predictor
    trained, X = _model()
    text = trained.model_to_string()
    bst = lgt.Booster(model_str=text)
    jax_bst = lgb.Booster(model_str=text)
    assert jcext.predict_available()
    assert np.array_equal(bst.predict(X, raw_score=True),
                          jax_bst.predict(X, raw_score=True))
    assert np.array_equal(bst.predict(X, pred_leaf=True),
                          jax_bst.predict(X, pred_leaf=True))
