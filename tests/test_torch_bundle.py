"""enable_bundle (default true) on sparse, mutually exclusive features: the
JAX package bundles them (exclusive feature bundling, lightgbm_tpu/efb.py)
while the port, which has no EFB yet (ROADMAP A7), trains them unbundled.
The two must still give the same model at the exact-mode bars of
tests/test_torch_train.py (structure identical, values within 1e-4): the
bundle's histogram expands to the unbundled one at conflict rate 0, with
the default bin's mass from a subtraction, so only the sums' rounding
differs. Data: numpy seeds 0 and 1; the JAX booster on its MXU growth
path in Pallas interpret mode.
"""

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_train import _STRUCT_KEYS, _assert_same_model, _trees


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


def _port_booster(X, y, params):
    p = dict(params, device_type="cpu")
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), 5)


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
    """ROADMAP C8: on this regression target the JAX package's bundled
    split scan and its unbundled one part at equal-gain ties between
    empty bins: feature 0 split at 0.531521797965782 (bundled) or 0.0
    (unbundled: the top of its zero bin) in tree 0 internal node 13
    (gain 50.011962890625 both) and trees 2 and 3 node 3; no training
    row of those nodes lies between, so the leaves hold the same rows.
    The port equals the unbundled JAX model at the exact-mode bars, and
    the bundled one in every line but those thresholds."""
    X, y = _exclusive(1)
    y = (X[:, 0] - X[:, 7] + X[:, -2]).astype(np.float32)
    params = dict(_PARAMS, objective="regression")
    bst = _port_booster(X, y, params)
    unbundled = _jax_booster(X, y, params, False)
    _assert_same_model(unbundled.model_to_string(), bst.model_to_string())
    bundled = _jax_booster(X, y, params, True)
    differ = []
    for i, (a, b) in enumerate(zip(_trees(bundled.model_to_string()),
                                   _trees(bst.model_to_string()))):
        for key in _STRUCT_KEYS:
            if key in a and a[key] != b[key]:
                assert key == "threshold", (i, key)
                ta, tb = a[key].split(" "), b[key].split(" ")
                differ += [(i, j, ta[j], tb[j]) for j in range(len(ta))
                           if ta[j] != tb[j]]
    # every parting is that tie: feature 0 between its zero bin and the
    # bin above, at equal gain
    assert differ == [(0, 13, "0.531521797965782", "0.0"),
                      (2, 3, "0.531521797965782", "0.0"),
                      (3, 3, "0.531521797965782", "0.0")]
    text = bst.model_to_string()
    for tree_jax, tree_port in zip(_trees(bundled.model_to_string()),
                                   _trees(text)):
        text = text.replace("threshold=" + tree_port["threshold"] + "\n",
                            "threshold=" + tree_jax["threshold"] + "\n", 1)
    _assert_same_model(bundled.model_to_string(), text)
