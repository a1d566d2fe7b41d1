"""SHAP contributions (predict(pred_contrib=True)): the same model text in
both packages gives the same contributions, bit for bit (shap.py is the
JAX package's host numpy, copied, and both parse the text alike): binary,
multiclass ([n, (F + 1) x k], each class's expected value last in its
block) and categorical and NaN splits. Sparse input gives a CSR matrix of
the dense input's values. The contributions of a row sum to its raw score
within 1e-9 (float64 sums of the same leaf values in another order)."""

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.conftest import make_multiclass
from tests.test_torch_one_thread import one_thread  # noqa: F401

ROWS = 40


def _cat_nan_rows(n=1500, seed=0):
    """Feature 0 categorical (codes 0..5), NaN in feature 2."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    X[:, 0] = r.randint(0, 6, n)
    X[r.uniform(size=n) < 0.1, 2] = np.nan
    logit = np.where(np.isin(X[:, 0], [1, 4]), 1.5, -1.0) + X[:, 1] + \
        np.nan_to_num(X[:, 2], nan=2.0)
    return X, (logit + 0.3 * r.randn(n) > 0).astype(np.float32)


def _text(params, X, y, rounds=4):
    params = dict(params, device_type="cpu", verbosity=-1, num_leaves=8)
    return lgt.train(params, lgt.Dataset(X, label=y, params=params),
                     rounds).model_to_string()


@pytest.fixture(scope="module")
def models():
    Xb, yb = _cat_nan_rows()
    Xm, ym = make_multiclass(n=900, f=4, k=3, seed=1)
    return {
        "binary": (Xb, _text({"objective": "binary",
                              "categorical_feature": "0"}, Xb, yb)),
        "multiclass": (Xm, _text({"objective": "multiclass",
                                  "num_class": 3}, Xm, ym)),
    }


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_contributions_match_jax(models, kind):
    X, text = models[kind]
    Xr = X[:ROWS]
    got = lgt.Booster(model_str=text).predict(Xr, pred_contrib=True)
    want = lgb.Booster(model_str=text).predict(Xr, pred_contrib=True)
    k = 3 if kind == "multiclass" else 1
    assert got.shape == (ROWS, (X.shape[1] + 1) * k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_contributions_sum_to_the_raw_score(models, kind):
    X, text = models[kind]
    bst = lgt.Booster(model_str=text)
    Xr = X[:ROWS]
    contrib = bst.predict(Xr, pred_contrib=True)
    raw = bst.predict(Xr, raw_score=True)
    k = 3 if kind == "multiclass" else 1
    sums = contrib.reshape(ROWS, k, -1).sum(-1)
    np.testing.assert_allclose(sums, raw.reshape(ROWS, k), rtol=1e-9,
                               atol=1e-9)
    if kind == "binary":
        # the categorical and the NaN feature take part
        assert np.abs(contrib[:, 0]).max() > 0
        assert np.abs(contrib[np.isnan(Xr[:, 2]), 2]).max() > 0


def test_sparse_input_gives_csr(models):
    X, text = models["multiclass"]
    Xr = X[:ROWS].copy()
    Xr[np.abs(Xr) < 0.5] = 0.0
    bst = lgt.Booster(model_str=text)
    got = bst.predict(sp.csr_matrix(Xr), pred_contrib=True)
    assert sp.issparse(got) and got.format == "csr"
    np.testing.assert_array_equal(got.toarray(),
                                  bst.predict(Xr, pred_contrib=True))


def test_iteration_range(models):
    """start_iteration/num_iteration pick the trees, as in the JAX
    package."""
    X, text = models["binary"]
    Xr = X[:10]
    got = lgt.Booster(model_str=text).predict(
        Xr, pred_contrib=True, start_iteration=1, num_iteration=2)
    want = lgb.Booster(model_str=text).predict(
        Xr, pred_contrib=True, start_iteration=1, num_iteration=2)
    np.testing.assert_array_equal(got, want)
