"""The 3-class LGBMClassifier of the port against the JAX package's, on
the CPU, with early stopping on a held-out set.

On multiclass data the JAX booster's portable grower (its CPU default)
parts from its MXU grower even at growth_overshoot 0, so the JAX
estimator trains on the MXU path the port follows: engine.Booster pinned
to the MXU grower in Pallas interpret mode (one interpret compile, ~25 s,
hence a file of its own). Predicted labels, classes, best_iteration_ and
split importances equal; probabilities and the recorded multi_logloss
within rtol 1e-4 / atol 1e-5 (the JAX kernel's bf16 hi/lo histogram
channels, ROADMAP C3). Data from the numpy seeds of
tests/test_torch_sklearn._data.
"""

import lightgbm_tpu as lgb
import numpy as np

from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_sklearn import _close, _data, _fit


class _MxuBooster(lgb.Booster):
    """The JAX Booster on its MXU growth path in Pallas interpret mode."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.gbdt is not None:
            self.gbdt._hist_impl = "mxu"
            self.gbdt._mxu_interpret = True


def test_multiclass_classifier_and_early_stop_match_jax(monkeypatch):
    from lightgbm_tpu import engine as jengine
    monkeypatch.setattr(jengine, "Booster", _MxuBooster)
    X, s = _data(seed=23)
    y = np.digitize(s, [-0.6, 0.6])
    Xv, sv = _data(n=150, seed=24)
    yv = np.digitize(sv, [-0.6, 0.6])
    j, t = _fit("LGBMClassifier", X, y, eval_set=[(Xv, yv)],
                early_stopping_rounds=2)
    assert t.n_classes_ == 3 and t.get_params()["num_class"] == 3
    np.testing.assert_array_equal(t.predict(Xv), j.predict(Xv))
    _close(t.predict_proba(Xv), j.predict_proba(Xv), rtol=1e-4, atol=1e-5)
    assert t.best_iteration_ == j.best_iteration_
    _close(t.evals_result_["valid_0"]["multi_logloss"],
           j.evals_result_["valid_0"]["multi_logloss"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
