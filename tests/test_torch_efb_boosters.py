"""Whole EFB boosters in the port against the JAX package's (its booster
pinned to its MXU grower, in Pallas interpret mode), on the sparse,
mutually exclusive data of tests/test_torch_efb.py: binary and
regression, with NaN and a categorical feature, the segmented scan and
the expansion, quantized, DART and multiclass. Structure identical,
values within 1e-4 (the issue's bar; the two packages' unbundled boosters
part by as much here, ROADMAP C3), and within 1e-5 of the port's own
unbundled booster, whose thresholds may differ where a bundled scan's
exact tie between empty bins goes to the later bin (ROADMAP C8) while
the training rows route alike. min_gain_to_split is set: see _BASE
(tests/test_torch_efb_min_gain.py runs these cases at 0).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from tests.test_torch_efb import (_BASE, _assert_same_model, _port_booster,
                                  _sparse_X)
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _jax_booster(X, y, params, rounds, expect_efb=True):
    jbst = lgb.Booster(dict(params, pipeline=False),
                       lgb.Dataset(X, label=y, params=params))
    g = jbst.gbdt
    assert (g._efb is not None) == expect_efb
    g._hist_impl = "mxu"              # the JAX package's MXU EFB path ...
    g._mxu_interpret = True           # ... in Pallas interpret mode
    for _ in range(rounds):
        jbst.update()
    return jbst


_BOOSTERS = {
    "binary": ({}, (False, False), 3),
    "regression": ({"objective": "regression"}, (False, False), 3),
    "nan_cat": ({"categorical_feature": "3"}, (True, True), 3),
    "expansion": ({"efb_segmented_scan": False, "categorical_feature": "3"},
                  (True, True), 3),
    # quantized: the first tree's key is the same bits in both packages
    # (after it, ROADMAP C2)
    "quantized": ({"use_quantized_grad": True}, (True, False), 1),
    "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
             (False, False), 3),
    "multiclass": ({"objective": "multiclass", "num_class": 3},
                   (False, False), 2),
}


def _case(name, **override):
    """(X, y, params, rounds) of the _BOOSTERS case `name`."""
    extra, (with_nan, with_cat), rounds = _BOOSTERS[name]
    X, logit = _sparse_X(5, n=2500, with_nan=with_nan, with_cat=with_cat)
    params = dict(_BASE, **extra, **override)
    if params["objective"] == "regression":
        y = logit.astype(np.float32)
    elif params["objective"] == "multiclass":
        y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])) \
            .astype(np.float32)
    else:
        y = (logit > np.median(logit)).astype(np.float32)
    return X, y, params, rounds


# the cases that run in tests/test_torch_efb_boosters_more.py, so that
# --dist loadfile spreads their JAX interpret compiles
_MORE = ("expansion", "nan_cat", "quantized")


def _booster_case(name):
    """test_booster_matches_jax's body: the port's bundled booster against
    the JAX package's at 1e-4 (the port's and the JAX package's unbundled
    boosters part by as much here: ROADMAP C3), and against the port's own
    unbundled booster at 1e-5."""
    X, y, params, rounds = _case(name)
    bst = _port_booster(X, y, params, rounds)
    assert bst.gbdt._efb is not None
    assert bst.gbdt.bins.shape[1] < X.shape[1]
    jbst = _jax_booster(X, y, params, rounds)
    _assert_same_model(jbst.model_to_string(), bst.model_to_string(), 1e-4)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jbst.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-4)
    plain = _port_booster(X, y, dict(params, enable_bundle=False), rounds)
    assert plain.gbdt._efb is None
    _assert_same_model(plain.model_to_string(), bst.model_to_string(), 1e-5,
                       skip=("threshold",))
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  plain.predict(X, pred_leaf=True))


@pytest.mark.parametrize("name", [n for n in sorted(_BOOSTERS)
                                  if n not in _MORE])
def test_booster_matches_jax(name):
    _booster_case(name)
