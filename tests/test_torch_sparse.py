"""Sparse input (scipy CSR/CSC) in the port against the JAX package.

The port bins a sparse matrix without densifying its values
(BinnedDataset.from_sparse) and predicts it densified in row chunks. Held
on numpy seeds: the mappers and bin matrix equal the JAX package's
from_sparse and the port's own dense binning, duplicates (summed), stored
zeros, NaN, a categorical column and a sampled mapper search included; a
sparse validation set bins as the dense one; a model trained on CSR input
equals the dense-input model byte for byte, predicts CSR rows as it
predicts the dense ones, and equals the JAX package's model on the same
CSR input at the exact-mode bars.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.data import BinnedDataset as JaxBinned
from lightgbm_tpu.data import Metadata as JaxMetadata
from lightgbm_tpu_torch.data import BinnedDataset, Metadata
from tests.test_torch_efb import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _sparse(seed, n=3000, f=40):
    """Mutually exclusive groups of 10 features (one nonzero a row), NaN
    stored in column 1, a categorical column 5 of small codes, explicit
    zeros stored in column 7."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for g in range(0, f, 10):
        which = rng.randint(g, g + 10, n)
        X[np.arange(n), which] = np.round(rng.rand(n) * 3 + 0.1, 2)
    X[rng.rand(n) < 0.03, 1] = np.nan
    X[:, 5] = rng.randint(0, 4, n)
    y = (np.nan_to_num(X[:, 0]) + X[:, 11] - X[:, 25] + (X[:, 5] == 2) +
         0.2 * rng.randn(n) > 0.5).astype(np.float32)
    csr = sp.csr_matrix(X)
    # explicit zeros stored in column 7
    rows7 = np.nonzero(X[:, 7] == 0)[0][:50]
    coo = csr.tocoo()
    csr = sp.csr_matrix((np.concatenate([coo.data, np.zeros(len(rows7))]),
                         (np.concatenate([coo.row, rows7]),
                          np.concatenate([coo.col,
                                          np.full(len(rows7), 7)]))),
                        shape=X.shape)
    return X, y, csr


def _with_duplicates(csr, X, rng):
    """The same matrix with some entries split into two stored halves
    (scipy sums duplicates)."""
    coo = csr.tocoo()
    pick = rng.rand(coo.nnz) < 0.1
    pick &= np.isfinite(coo.data)
    half = coo.data[pick] / 2
    data = np.concatenate([np.where(pick, coo.data / 2, coo.data), half])
    row = np.concatenate([coo.row, coo.row[pick]])
    col = np.concatenate([coo.col, coo.col[pick]])
    dup = sp.coo_matrix((data, (row, col)), shape=X.shape)
    assert dup.nnz > coo.nnz
    return dup


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo_duplicates"])
def test_sparse_binning_matches_jax_and_dense(fmt):
    X, y, csr = _sparse(0)
    rng = np.random.RandomState(1)
    data = {"csr": csr, "csc": csr.tocsc(),
            "coo_duplicates": _with_duplicates(csr, X, rng)}[fmt]
    n = X.shape[0]
    kw = dict(max_bin=63, categorical_features=[5])
    ds_t = BinnedDataset.from_sparse(data, Metadata(n), **kw)
    ds_j = JaxBinned.from_sparse(data, JaxMetadata(n), **kw)
    dense = BinnedDataset.from_raw(X, Metadata(n), **kw)
    np.testing.assert_array_equal(ds_t.used_features, ds_j.used_features)
    np.testing.assert_array_equal(ds_t.bins, np.asarray(ds_j.bins))
    np.testing.assert_array_equal(ds_t.bins, dense.bins)
    assert [repr(m.to_dict()) for m in ds_t.mappers] == \
        [repr(m.to_dict()) for m in ds_j.mappers] == \
        [repr(m.to_dict()) for m in dense.mappers]


def test_sparse_sampled_mappers_match_dense():
    """More rows than bin_construct_sample_cnt: the sparse mapper search
    samples the rows the dense one samples."""
    X, y, csr = _sparse(2, n=4000)
    n = X.shape[0]
    kw = dict(max_bin=31, sample_cnt=1500, seed=7)
    ds_t = BinnedDataset.from_sparse(csr, Metadata(n), **kw)
    ds_j = JaxBinned.from_sparse(csr, JaxMetadata(n), **kw)
    dense = BinnedDataset.from_raw(X, Metadata(n), **kw)
    np.testing.assert_array_equal(ds_t.bins, np.asarray(ds_j.bins))
    np.testing.assert_array_equal(ds_t.bins, dense.bins)


def test_sparse_valid_set_bins_as_dense():
    X, y, csr = _sparse(3)
    params = {"max_bin": 63, "verbosity": -1}
    train = lgt.Dataset(csr[:2000], label=y[:2000], params=params)
    valid = train.create_valid(csr[2000:].tocsc(), label=y[2000:])
    valid_dense = lgt.Dataset(X[2000:], label=y[2000:],
                              reference=lgt.Dataset(X[:2000], label=y[:2000],
                                                    params=params))
    np.testing.assert_array_equal(valid.binned.bins,
                                  valid_dense.binned.bins)


def test_csr_training_equals_dense_and_jax():
    X, y, csr = _sparse(4, n=2500)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
              "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
              "categorical_feature": "5", "verbosity": -1,
              "efb_use_mxu": True, "device_type": "cpu"}
    ds_sparse = lgt.Dataset(csr, label=y, params=params)
    bst = lgt.train(params, ds_sparse, 3)
    assert bst.gbdt._efb is not None        # the sparse columns bundle
    dense = lgt.train(params, lgt.Dataset(X, label=y, params=params), 3)
    assert bst.model_to_string() == dense.model_to_string()
    np.testing.assert_array_equal(bst.predict(csr), bst.predict(X))
    np.testing.assert_array_equal(bst.predict(csr.tocsc(), raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(bst.predict(csr[:0]),
                                  np.zeros(0, np.float64))
    jp = dict(params, pipeline=False)
    del jp["device_type"]
    jbst = lgb.Booster(jp, lgb.Dataset(csr, label=y, params=jp))
    jbst.gbdt._hist_impl = "mxu"
    jbst.gbdt._mxu_interpret = True
    for _ in range(3):
        jbst.update()
    _assert_same_model(jbst.model_to_string(), bst.model_to_string(), 1e-4)
    np.testing.assert_allclose(bst.predict(csr, raw_score=True),
                               jbst.predict(csr, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def test_sparse_valid_set_trains_with_early_stopping():
    X, y, csr = _sparse(5, n=2500)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
              "metric": "auc", "verbosity": -1, "device_type": "cpu",
              "early_stopping_round": 3}
    ev_s, ev_d = {}, {}
    for data, ev in ((csr, ev_s), (X, ev_d)):
        ds = lgt.Dataset(data[:2000], label=y[:2000], params=params)
        lgt.train(params, ds, 8, valid_sets=[ds.create_valid(
            data[2000:], label=y[2000:])],
            callbacks=[lgt.record_evaluation(ev)])
    assert ev_s == ev_d and len(ev_s["valid_0"]["auc"]) >= 3
