"""The Booster's model surface of the port against the JAX package, on
model texts the JAX package trains (a binary, a 3-class and a linear-tree
regression model, one training each, module-scoped) and both packages
load.

Exact bars, since both packages read the same text into the same float64
host model: dump_model's JSON, feature_importance (split and gain),
lower_bound/upper_bound, predict with the margin early stop at several
margins and check periods (the numpy tree walk, tree by tree in float64 in
both), the model text written back, and a deepcopy's text. refit (decay
0 and 0.7, constant and linear leaves, and the 3-class model) within rtol
1e-5 / atol 1e-7 of the JAX refit: both take the objective's f32
gradients at the same scores, torch's and XLA's exp parting in the last
bit, and sum them per leaf in float64 from the same host leaf indices.
Data from numpy seeds stated in _data.
"""

import copy

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_one_thread import one_thread  # noqa: F401

BASE = {"num_leaves": 7, "learning_rate": 0.3, "max_bin": 31,
        "min_data_in_leaf": 5, "verbosity": -1}
MODELS = {
    "binary": dict(BASE, objective="binary"),
    "multiclass": dict(BASE, objective="multiclass", num_class=3),
    "linear": dict(BASE, objective="regression", linear_tree=True,
                   linear_lambda=0.1),
}
ROUNDS = 6


def _data(kind, n=400, f=5, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 2] = np.nan
    s = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n)
    if kind == "binary":
        y = (s > 0).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(s, [-0.5, 0.5]).astype(np.float64)
    else:
        y = 2.0 * X[:, 0] - np.abs(X[:, 1]) + 0.1 * rng.randn(n)
    return X, y


@pytest.fixture(scope="module")
def texts():
    out = {}
    for kind, params in MODELS.items():
        X, y = _data(kind)
        b = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
        out[kind] = b.model_to_string()
    return out


def _pair(texts, kind, **params):
    s = texts[kind]
    return (lgb.Booster(params=dict(params), model_str=s),
            lgt.Booster(params=dict(params, device_type="cpu"), model_str=s))


@pytest.mark.parametrize("kind", list(MODELS))
def test_dump_model_and_importances(texts, kind):
    j, t = _pair(texts, kind)
    assert t.dump_model() == j.dump_model()
    assert t.dump_model(num_iteration=2, start_iteration=1) == \
        j.dump_model(num_iteration=2, start_iteration=1)
    for imp in ("split", "gain"):
        np.testing.assert_array_equal(t.feature_importance(imp),
                                      j.feature_importance(imp))
        np.testing.assert_array_equal(
            t.feature_importance(imp, iteration=1),
            j.feature_importance(imp, iteration=1))
    assert t.lower_bound() == j.lower_bound()
    assert t.upper_bound() == j.upper_bound()
    assert t.feature_name() == j.feature_name()
    assert t.num_feature() == j.num_feature()
    assert t.num_model_per_iteration() == j.num_model_per_iteration()
    assert t.model_to_string() == j.model_to_string()


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
@pytest.mark.parametrize("margin,freq", [(0.5, 1), (1.5, 2), (1.0, 3),
                                         (100.0, 2)])
def test_predict_early_stop_matches_jax(texts, kind, margin, freq):
    j, t = _pair(texts, kind)
    X, _ = _data(kind, n=300, seed=8)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=freq,
              pred_early_stop_margin=margin)
    for raw in (True, False):
        np.testing.assert_array_equal(t.predict(X, raw_score=raw, **kw),
                                      j.predict(X, raw_score=raw, **kw))
    full = t.predict(X, raw_score=True)
    stopped = t.predict(X, raw_score=True, **kw)
    if margin >= 100.0:
        # no row reaches the margin: every tree counts
        np.testing.assert_allclose(stopped, full, rtol=0, atol=1e-12)
    else:
        assert not np.allclose(stopped, full)


def test_predict_early_stop_ignored_on_regression(texts):
    j, t = _pair(texts, "linear")
    X, _ = _data("linear", n=200, seed=9)
    kw = dict(pred_early_stop=True, pred_early_stop_margin=0.1,
              validate_features=True)
    np.testing.assert_array_equal(t.predict(X, **kw), t.predict(X))
    np.testing.assert_array_equal(t.predict(X, **kw), j.predict(X, **kw))


@pytest.mark.parametrize("kind", list(MODELS))
@pytest.mark.parametrize("decay", [0.0, 0.7])
def test_refit_matches_jax(texts, kind, decay):
    extra = {"num_class": 3} if kind == "multiclass" else {}
    j, t = _pair(texts, kind, **extra)
    X, y = _data(kind, n=350, seed=10)
    rj = j.refit(X, y, decay_rate=decay)
    rt = t.refit(X, y, decay_rate=decay)
    mj, mt = rj._host_model(), rt._host_model()
    assert len(mj.trees) == len(mt.trees) == len(t._host_model().trees)
    for a, b in zip(mj.trees, mt.trees):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)
        if a.is_linear:
            np.testing.assert_allclose(b.leaf_const, a.leaf_const,
                                       rtol=1e-5, atol=1e-7)
            for ca, cb in zip(a.leaf_coeff, b.leaf_coeff):
                np.testing.assert_allclose(cb, ca, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rt.predict(X), rj.predict(X), rtol=1e-5,
                               atol=1e-6)
    if decay == 0.0 and kind != "linear":
        # decay 0: each leaf is the new data's own output
        assert not np.allclose(rt.predict(X, raw_score=True),
                               t.predict(X, raw_score=True))


def test_refit_default_decay_is_refit_decay_rate(texts):
    _, t = _pair(texts, "binary", refit_decay_rate=0.25)
    X, y = _data("binary", n=300, seed=11)
    a = t.refit(X, y)
    b = t.refit(X, y, decay_rate=0.25)
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("kind", list(MODELS))
def test_copies_are_byte_equal(texts, kind):
    _, t = _pair(texts, kind)
    for c in (copy.deepcopy(t), copy.copy(t)):
        assert c is not t
        assert c.model_to_string() == t.model_to_string()


def test_free_dataset_and_network_on_a_trained_booster():
    X, y = _data("binary")
    params = dict(MODELS["binary"], device_type="cpu")
    b = lgt.train(params, lgt.Dataset(X, label=y), 3)
    text = b.model_to_string()
    assert b.free_network() is b
    assert b.free_dataset() is b and b.train_set is None
    # the trained trees stay
    assert b.num_trees() == 3
    np.testing.assert_array_equal(
        lgt.Booster(model_str=text).predict(X), b.predict(X))
