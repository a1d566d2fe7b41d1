"""Linear trees end to end: the port's booster (device_type='cpu') against
the JAX booster pinned to its MXU grower in Pallas interpret mode (the
growth path both packages take on an accelerator).

The piecewise-linear regression of tests/test_linear.py with NaN on a
model feature, 8 leaves, 4 trees, a valid set, at linear_lambda 0 and 0.5
(one JAX interpret compile: lambda is not a static argument). Held: every
tree's structure and leaf features identical; leaf_value, leaf_const and
leaf_coeff within 1e-4 relative + 5e-5 (the JAX package sums f32 outer
products in row order and solves in f32, the port sums fixed-point
integers and solves in float64; at lambda 0 the solve amplifies the f32
rounding by the system's condition number, hence the loose bound); the
valid scores and the host predictions within 1e-4 of the JAX package's
(the same models' values summed in another order). The binary and the
quantized cases are in test_torch_linear_binary.py and
test_torch_linear_quantized.py (compiles of their own).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_one_thread import one_thread  # noqa: F401

TREES = 4
BASE = {"objective": "regression", "num_leaves": 8, "verbosity": -1,
        "learning_rate": 0.3, "linear_tree": True}
_STRUCT = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "is_linear",
           "num_features", "leaf_features")
_VALUES = ("leaf_value", "leaf_const", "leaf_coeff")


def piecewise(n=2000, seed=0, nan_share=0.03):
    """tests/test_linear.py's piecewise-linear rows, NaN on feature 1 (a
    model feature of every leaf under a split on it) in nan_share of
    them."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4).astype(np.float32)
    y = (np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1]) +
         0.05 * r.randn(n)).astype(np.float32)
    X[r.uniform(size=n) < nan_share, 1] = np.nan
    return X, y


def binary_rows(n=2000, seed=2):
    """tests/test_linear.py's linear binary task, NaN as piecewise."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 5).astype(np.float32)
    y = (X[:, 0] * 1.5 + X[:, 1] + 0.3 * r.randn(n) > 0).astype(np.float32)
    X[r.uniform(size=n) < 0.03, 1] = np.nan
    return X, y


def jax_booster(X, y, Xv, yv, params, trees=TREES):
    bst = lgb.Booster(dict(params, pipeline=False),
                      lgb.Dataset(X, label=y, params=params))
    bst.add_valid(lgb.Dataset(Xv, label=yv, params=params), "v")
    g = bst.gbdt
    g._hist_impl = "mxu"           # the accelerator's growth path ...
    g._mxu_interpret = True        # ... in Pallas interpret mode
    for _ in range(trees):
        bst.update()
    return bst


def port_booster(X, y, Xv, yv, params, trees=TREES):
    p = dict(params, device_type="cpu")
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    bst.add_valid(lgt.Dataset(Xv, label=yv), "v")
    for _ in range(trees):
        bst.update()
    return bst


def tree_blocks(model_str):
    body = model_str.split("end of trees")[0]
    return [dict(line.split("=", 1) for line in block.splitlines()[1:]
                 if "=" in line) for block in body.split("Tree=")[1:]]


def assert_same_models(jb, tb, structure_trees=None, rtol=1e-4, atol=5e-5):
    """Every tree (or the first structure_trees) structurally identical,
    the values of those within rtol/atol."""
    jt, tt = tree_blocks(jb.model_to_string()), tree_blocks(
        tb.model_to_string())
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        if structure_trees is not None and i >= structure_trees:
            break
        for key in _STRUCT:
            assert a.get(key) == b.get(key), (i, key)
        for key in _VALUES:
            if key not in a:
                continue
            va = np.asarray(a[key].split(), np.float64)
            vb = np.asarray(b[key].split(), np.float64)
            np.testing.assert_allclose(vb, va, rtol=rtol, atol=atol,
                                       err_msg=f"tree {i} {key}")


@pytest.fixture(scope="module")
def boosters():
    X, y = piecewise()
    Xv, yv = piecewise(800, seed=1)
    out = {}
    for lam in (0.0, 0.5):
        params = dict(BASE, linear_lambda=lam)
        out[lam] = (jax_booster(X, y, Xv, yv, params),
                    port_booster(X, y, Xv, yv, params))
    return X, Xv, out


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_linear_booster_matches_pinned_jax(boosters, lam):
    X, Xv, runs = boosters
    jb, tb = runs[lam]
    assert tb.gbdt._hist_impl == "mxu" and not tb.gbdt._fused_eligible()
    assert all(lm is not None for lm in tb.gbdt.linear_models)
    assert "is_linear=1" in tb.model_to_string()
    assert_same_models(jb, tb)
    np.testing.assert_allclose(
        tb.gbdt.valid_scores[0].numpy(),
        np.asarray(jb.gbdt.valid_scores[0]), rtol=1e-4, atol=1e-4)
    for data in (X, Xv):
        np.testing.assert_allclose(tb.predict(data), jb.predict(data),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_linear_scores_are_the_host_models(boosters, lam):
    """The device scores (kernel L2's plain version on the training rows,
    on V's leaf ids for the valid rows) against the host model's float64
    walk within 1e-5 (f32 against float64 sums of the same models); the
    native and numpy host walks give the same bits."""
    X, Xv, runs = boosters
    tb = runs[lam][1]
    model = tb._host_model()
    for data, dev in ((X, tb.gbdt.train_score_host()),
                      (Xv, tb.gbdt.valid_scores[0].numpy())):
        host = tb.predict(data)
        np.testing.assert_allclose(host, dev, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(model.predict(data, native=False),
                                      host)
