"""enable_bundle (default true) on sparse, mutually exclusive features:
the JAX package and the port both bundle them (exclusive feature bundling,
lightgbm_tpu/efb.py and lightgbm_tpu_torch/efb.py) and must give the same
model at the exact-mode bars of tests/test_torch_train.py (structure
identical, values within 1e-4); with enable_bundle=false both train
unbundled and must agree so too. Data: numpy seeds 0 and 1; the JAX
booster on its MXU growth path in Pallas interpret mode.
"""

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_train import _STRUCT_KEYS, _assert_same_model, _trees
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _exclusive(seed, n=3000, groups=3, width=6):
    """groups x width sparse features, exactly one nonzero a group and
    row (mutually exclusive inside a group; each nonzero in a sixth of the
    rows, sparse enough for the JAX plan), plus two dense features."""
    rng = np.random.RandomState(seed)
    blocks = []
    for _ in range(groups):
        block = np.zeros((n, width))
        hot = rng.randint(0, width, n)
        block[np.arange(n), hot] = rng.rand(n) + 0.5
        blocks.append(block)
    dense = rng.randn(n, 2)
    X = np.concatenate(blocks + [dense], axis=1)
    logit = (X[:, 0] - X[:, 7] + 0.7 * X[:, 13] + dense[:, 0] +
             0.3 * rng.randn(n))
    y = (logit > np.median(logit)).astype(np.float32)
    return X, y


def _jax_booster(X, y, params, enable_bundle):
    p = dict(params, enable_bundle=enable_bundle)
    jbst = lgb.Booster(dict(p, pipeline=False),
                       lgb.Dataset(X, label=y, params=p))
    g = jbst.gbdt
    # the JAX plan bundles these features (it keeps no plan otherwise)
    assert (g._efb is not None) == enable_bundle
    if enable_bundle:
        assert g.bins.shape[1] < X.shape[1]
    g._hist_impl = "mxu"
    g._mxu_interpret = True
    for _ in range(5):
        jbst.update()
    return jbst


def _port_booster(X, y, params, enable_bundle=True):
    # efb_use_mxu: the MXU grower the JAX booster is pinned to
    p = dict(params, device_type="cpu", enable_bundle=enable_bundle,
             efb_use_mxu=True)
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 5)
    assert (bst.gbdt._efb is not None) == enable_bundle
    return bst


_PARAMS = {"num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 20,
           "verbosity": -1}


def test_port_unbundled_matches_jax_bundled():
    X, y = _exclusive(0)
    params = dict(_PARAMS, objective="binary")
    jbst = _jax_booster(X, y, params, True)
    bst = _port_booster(X, y, params)
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jbst.predict(X, raw_score=True), rtol=1e-5,
                               atol=5e-5)


def test_bundled_threshold_tie_fault():
    """ROADMAP C8, closed: on this regression target the bundled split scan
    and the unbundled one part at equal-gain ties between empty bins:
    feature 0 splits at 0.531521797965782 (bundled: the segmented scan
    ranks ties by bundle position, and the default bin's threshold sits
    at the segment's last position) or 0.0 (unbundled: the top of its
    zero bin) in tree 0 internal node 13 (gain 50.011962890625 both) and
    trees 2 and 3 node 3; no training row of those nodes lies between, so
    the leaves hold the same rows. The port keeps the JAX package's tie
    order: its bundled model equals the JAX bundled model, those
    thresholds included, and with enable_bundle=false it equals the JAX
    unbundled model, both at the exact-mode bars."""
    X, y = _exclusive(1)
    y = (X[:, 0] - X[:, 7] + X[:, -2]).astype(np.float32)
    params = dict(_PARAMS, objective="regression")
    bundled = _jax_booster(X, y, params, True)
    bst = _port_booster(X, y, params)
    _assert_same_model(bundled.model_to_string(), bst.model_to_string())
    thresholds = [t["threshold"].split(" ")
                  for t in _trees(bst.model_to_string())]
    assert [thresholds[i][j] for i, j in ((0, 13), (2, 3), (3, 3))] == \
        ["0.531521797965782"] * 3
    unbundled = _jax_booster(X, y, params, False)
    bst_u = _port_booster(X, y, params, enable_bundle=False)
    _assert_same_model(unbundled.model_to_string(),
                       bst_u.model_to_string())
    thresholds = [t["threshold"].split(" ")
                  for t in _trees(bst_u.model_to_string())]
    assert [thresholds[i][j] for i, j in ((0, 13), (2, 3), (3, 3))] == \
        ["0.0"] * 3
