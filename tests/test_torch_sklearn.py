"""The scikit-learn estimators of the port against the JAX package's, and
engine.train's continuation rules, on the CPU.

Both packages fit the same data with the same estimator arguments at
growth_overshoot 0 and min_split_gain 1e-3, where the port's MXU grower
grows the JAX booster's portable-grower trees (ROADMAP C3: a pure node's
split gain is a few f32 ulps of either sign, which the floor keeps out;
tests/test_torch_sklearn_multiclass.py holds the 3-class estimator):
classes_, predicted labels, best_iteration_ and split importances are
equal; probabilities, raw scores and recorded metrics within rtol 1e-5 /
atol 1e-6 (the ranker's scores within rtol 1e-4 / atol 1e-5), gain
importances within rtol 1e-4 (the packages' histogram sums and f32 exp
part in the last bits). The estimators' parameters follow
the scikit-learn contract (get_params/set_params, sklearn.base.clone).
Within the port the bars are exact: train(keep_training_booster=True)
then update() is byte-equal to one longer train; update(train_set=<another
Dataset>) warns and trains the booster's own set, as the JAX package
ignores the argument (ROADMAP C24). A multiclass init_score is [N, k]
row-major, flat or 2-D, as the JAX package reads it (ROADMAP C26). Data
from the numpy seeds stated in each helper.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu.sklearn as jsk
import lightgbm_tpu_torch as lgt
import lightgbm_tpu_torch.sklearn as tsk
from lightgbm_tpu_torch.utils.log import Log
from tests.test_torch_one_thread import one_thread  # noqa: F401

ARGS = {"num_leaves": 7, "learning_rate": 0.3, "n_estimators": 6,
        "min_child_samples": 5, "min_split_gain": 1e-3, "max_bin": 31,
        "growth_overshoot": 0.0}


def _data(n=300, f=5, seed=21):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    s = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    return X, s


def _fit(cls_name, X, y, **fit_kw):
    j = getattr(jsk, cls_name)(**ARGS)
    t = getattr(tsk, cls_name)(device_type="cpu", **ARGS)
    j.fit(X, y, **fit_kw)
    t.fit(X, y, **fit_kw)
    return j, t


def _close(a, b, **kw):
    np.testing.assert_allclose(a, b, **(kw or dict(rtol=1e-5, atol=1e-6)))


def _same_importances(j, t):
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
    _close(t.booster_.feature_importance("gain"),
           j.booster_.feature_importance("gain"), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("labels", ["numeric", "strings"])
def test_classifier_matches_jax(labels):
    X, s = _data()
    y = (s > 0).astype(int)
    if labels == "strings":
        y = np.where(y > 0, "yes", "no")
    Xv, sv = _data(n=150, seed=22)
    yv = (sv > 0).astype(int) if labels == "numeric" else \
        np.where(sv > 0, "yes", "no")
    j, t = _fit("LGBMClassifier", X, y, eval_set=[(Xv, yv)],
                eval_metric=["binary_logloss", "auc"])
    np.testing.assert_array_equal(t.classes_, j.classes_)
    assert t.n_classes_ == j.n_classes_ == 2
    np.testing.assert_array_equal(t.predict(Xv), j.predict(Xv))
    _close(t.predict_proba(Xv), j.predict_proba(Xv))
    _close(t.predict(Xv, raw_score=True), j.predict(Xv, raw_score=True))
    assert t.best_iteration_ == j.best_iteration_
    assert set(t.evals_result_) == {"valid_0"}
    for m in ("binary_logloss", "auc"):
        _close(t.evals_result_["valid_0"][m], j.evals_result_["valid_0"][m])
    _same_importances(j, t)
    assert t.n_features_ == 5 and t.feature_name_ == j.feature_name_


def test_regressor_and_ranker_match_jax():
    X, s = _data(seed=25)
    j, t = _fit("LGBMRegressor", X, s)
    _close(t.predict(X), j.predict(X))
    _same_importances(j, t)
    rel = np.digitize(s, [-0.5, 0.5, 1.2]).astype(float)
    group = [20] * 15
    j, t = _fit("LGBMRanker", X, rel, group=group)
    # lambdarank's f32 pair weights part in more bits than a pointwise
    # objective's gradients
    _close(t.predict(X), j.predict(X), rtol=1e-4, atol=1e-5)
    _same_importances(j, t)
    with pytest.raises(ValueError, match="group"):
        tsk.LGBMRanker(device_type="cpu").fit(X, rel)


def test_params_and_clone():
    from sklearn.base import clone
    est = tsk.LGBMClassifier(num_leaves=5, n_estimators=8,
                             device_type="cpu", max_bin=15)
    p = est.get_params()
    assert p["num_leaves"] == 5 and p["device_type"] == "cpu" and \
        p["max_bin"] == 15
    assert p == jsk.LGBMClassifier(num_leaves=5, n_estimators=8,
                                   device_type="cpu",
                                   max_bin=15).get_params()
    assert est.set_params(learning_rate=0.05, extra_trees=True) is est
    assert est.learning_rate == 0.05
    assert est.get_params()["extra_trees"] is True
    twin = clone(est)
    assert twin is not est and twin.get_params() == est.get_params()
    X, s = _data(n=200, seed=26)
    y = (s > 0).astype(int)
    twin.fit(X, y)
    est.fit(X, y)
    assert twin.booster_.model_to_string() == est.booster_.model_to_string()
    with pytest.raises(ValueError, match="not fitted"):
        tsk.LGBMRegressor().predict(X)


def test_estimators_need_the_card_unless_asked_for_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trains there")
    X, s = _data(n=100, seed=27)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tsk.LGBMRegressor(n_estimators=1).fit(X, s)


PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.3,
          "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1,
          "device_type": "cpu", "fused_block_size": 4}


def test_keep_training_booster_then_update_is_one_longer_train():
    X, s = _data(seed=28)
    ds = lgt.Dataset(X, label=(s > 0).astype(float))
    a = lgt.train(PARAMS, ds, 6, keep_training_booster=True)
    for _ in range(4):
        a.update()
    b = lgt.train(PARAMS, ds, 10)
    assert a.model_to_string() == b.model_to_string()
    # keep_training_booster=False returns a booster that trains on too
    c = lgt.train(PARAMS, ds, 6)
    for _ in range(4):
        c.update()
    assert c.model_to_string() == b.model_to_string()


def test_update_with_another_train_set_warns_and_trains_its_own(
        monkeypatch):
    """ROADMAP C24."""
    X, s = _data(seed=29)
    y = (s > 0).astype(float)
    ds = lgt.Dataset(X, label=y)
    other = lgt.Dataset(X[:100], label=1.0 - y[:100])
    warned = []
    monkeypatch.setattr(Log, "warning", staticmethod(
        lambda msg, *args: warned.append(msg % args if args else msg)))
    a = lgt.Booster(PARAMS, ds)
    b = lgt.Booster(PARAMS, ds)
    for _ in range(3):
        a.update(train_set=other)
        b.update()
    a.update(train_set=ds)          # its own set: no warning
    b.update()
    assert len(warned) == 3 and all("train_set" in w for w in warned)
    assert a.model_to_string() == b.model_to_string()
    # the JAX package ignores the argument too
    j = lgb.Booster({k: v for k, v in PARAMS.items() if k != "device_type"},
                    lgb.Dataset(X, label=y))
    j.update(train_set=lgb.Dataset(X[:100], label=1.0 - y[:100]))
    assert j.num_trees() == 1


def test_multiclass_init_score_layout_matches_jax():
    """ROADMAP C26: [N, k] row-major, as the JAX package reads it."""
    X, s = _data(seed=30)
    y = np.digitize(s, [-0.6, 0.6]).astype(float)
    init = np.random.RandomState(31).randn(300, 3) * 0.5
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 5,
              "learning_rate": 0.3, "max_bin": 31, "min_data_in_leaf": 5,
              "verbosity": -1, "growth_overshoot": 0.0,
              "min_gain_to_split": 1e-3}
    jb = lgb.train(params, lgb.Dataset(X, label=y, init_score=init), 3)
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, init_score=init), 3)
    flat = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y, init_score=init.reshape(-1)), 3)
    assert flat.model_to_string() == tb.model_to_string()
    # the training scores start from the init score, class by class
    np.testing.assert_allclose(
        tb.gbdt.train_score_host() - tb.predict(X, raw_score=True),
        init, rtol=0, atol=1e-5)
    _close(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True))
    _close(tb.gbdt.train_score_host(), np.asarray(jb.gbdt.train_score))
    # the reference's class-major layout is not what either reads
    other = lgt.train(dict(params, device_type="cpu"),
                      lgt.Dataset(X, label=y,
                                  init_score=init.T.reshape(-1)), 3)
    assert other.model_to_string() != tb.model_to_string()
