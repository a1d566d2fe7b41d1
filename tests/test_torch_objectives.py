"""The pointwise objectives and leaf renewal on the CPU, against the JAX
package and against the port's own per-iteration path.

Each objective's gradients and hessians (unweighted and weighted) agree
with lightgbm_tpu.objectives within 1e-6 relative (1e-5 relative and
1e-6 absolute after an exp), and its boost_from_score and
convert_output too; a 3-iteration booster of each
(JAX: its MXU growth path in Pallas interpret mode, as
tests/test_torch_train.py runs it) writes the same model at that file's
exact-mode bars (structure identical, values within 1e-4; Fair's split
gains within 1e-4 of the tree's largest, see the test).
renew_tree_output (learner/renew.py) gives the JAX package's leaf values
on the same tree, rows and residuals. Within the port: the objectives
that renew their leaves run one iteration a dispatch, the others
through the fused trainer, whose model text equals update()'s byte for
byte. Data: numpy seeds stated in each helper; 1,500 rows x 5 features,
7 leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Metadata as JMetadata
from lightgbm_tpu.learner import renew as jrenew
from lightgbm_tpu.objectives import create_objective as jcreate
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Metadata
from lightgbm_tpu_torch.learner.renew import renew_tree_output
from lightgbm_tpu_torch.objectives import OBJECTIVE_ALIASES, create_objective
from tests.test_torch_predict_binned import _random_stack, _to_jax
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_train import _assert_same_model, _trees

_RENEW = ("regression_l1", "huber", "fair", "quantile", "mape")
_FUSED = ("poisson", "gamma", "tweedie", "cross_entropy",
          "cross_entropy_lambda")
_PARAMS = {"alpha": 0.7, "fair_c": 0.8, "poisson_max_delta_step": 0.6,
           "tweedie_variance_power": 1.3}
_BASE = dict(_PARAMS, num_leaves=7, learning_rate=0.2, max_bin=31,
             min_data_in_leaf=5, verbosity=-1)


def _label(name, x, rng):
    """A label for objective `name` from a linear signal x: positive for
    the log-link objectives, in [0, 1] for the cross-entropies."""
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(0.5 * x).astype(np.float32)
    if name in ("cross_entropy", "cross_entropy_lambda"):
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    return (2.0 * x).astype(np.float32)


def _text(trees):
    """Model text of per-tree {key: value} blocks (_trees' inverse, as far
    as _assert_same_model reads it)."""
    return "".join("Tree=%d\n" % i + "".join(
        f"{k}={v}\n" for k, v in t.items()) for i, t in enumerate(trees)) \
        + "end of trees"


def _data(name, n=1500, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    X[rng.rand(n) < 0.05, 2] = np.nan
    x = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n)
    return X, _label(name, x, rng)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", _RENEW + _FUSED +
                         ("regression", "binary"))
def test_gradients_equal_jax(name, weighted):
    rng = np.random.RandomState(2)
    n = 500
    label = _label(name, rng.randn(n), rng)
    if name == "binary":
        label = (label > 0).astype(np.float32)
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    score = rng.randn(n).astype(np.float32)
    params = dict(_PARAMS, objective=name)
    obj = create_objective(name, Config(params))
    obj.init(Metadata(n, label=label, weight=weight), n, torch.device("cpu"))
    jobj = jcreate(name, JConfig(params))
    jobj.init(JMetadata(n, label=label, weight=weight), n)
    for attr in ("is_constant_hessian", "need_renew_tree_output",
                 "num_model_per_iteration"):
        assert getattr(obj, attr) == getattr(jobj, attr), attr
    if obj.need_renew_tree_output:
        assert obj.renew_percentile == jobj.renew_percentile
    g, h = obj.get_gradients(torch.as_tensor(score))
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    # XLA's exp and torch's part in the last bit; a gradient that cancels
    # after an exp (gamma's 1 - y e^-s, the lambda cross-entropy's
    # quotients) magnifies that
    tol = dict(rtol=1e-5, atol=1e-6) if name in _FUSED else \
        dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol)
    assert obj.boost_from_score() == pytest.approx(jobj.boost_from_score(),
                                                   rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(obj.convert_output(score),
                               np.asarray(jobj.convert_output(
                                   jnp.asarray(score))), rtol=1e-6)


@pytest.mark.parametrize("name", _RENEW + _FUSED)
def test_three_tree_model_matches_jax(name):
    X, y = _data(name)
    params = dict(_BASE, objective=name)
    jb = lgb.Booster(dict(params, pipeline=False),
                     lgb.Dataset(X, label=y, params=params))
    jb.gbdt._hist_impl = "mxu"           # the TPU growth path ...
    jb.gbdt._mxu_interpret = True        # ... in Pallas interpret mode
    p = dict(params, device_type="cpu")
    tb = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for _ in range(3):
        jb.update()
        tb.update()
    if name == "fair":
        # Fair's hessians c^2 / (|d| + c)^2 are neither constant nor
        # short in bits, and the JAX package sums them in double-bf16
        # channels: its split gains part from the port's float64 sums by
        # up to ~4e-5 of the tree's largest gain here (tree 0), so the
        # gains are held at 1e-4 of it; structure and leaves at the bars
        jt, tt = _trees(jb.model_to_string()), _trees(tb.model_to_string())
        for a, b in zip(jt, tt):
            ga = np.asarray(a.pop("split_gain").split(), np.float64)
            gb = np.asarray(b.pop("split_gain").split(), np.float64)
            np.testing.assert_allclose(gb, ga, rtol=0,
                                       atol=1e-4 * np.abs(ga).max())
        _assert_same_model(_text(jt), _text(tt))
    else:
        _assert_same_model(jb.model_to_string(), tb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.gbdt.train_score.numpy(),
                               tb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    assert tb.gbdt._fused_eligible() == (name in _FUSED)


@pytest.mark.parametrize("name", ["quantile", "huber", "poisson",
                                  "cross_entropy_lambda"])
def test_train_equals_update_loop(name):
    """The fused objectives through train's block dispatch, the renewing
    ones one iteration a dispatch: update()'s model text either way."""
    X, y = _data(name)
    p = dict(_BASE, objective=name, device_type="cpu", fused_block_size=3,
             metric=name)
    a = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for _ in range(5):
        a.update()
    ev = {}
    b = lgt.train(p, lgt.Dataset(X, label=y, params=p), 5,
                  valid_sets=[lgt.Dataset(X[:300], label=y[:300])],
                  callbacks=[lgt.record_evaluation(ev)])
    strip = [ln for ln in b.model_to_string().splitlines()
             if not ln.startswith("[fused_block_size:")]
    assert strip == [ln for ln in a.model_to_string().splitlines()
                     if not ln.startswith("[fused_block_size:")]
    assert (b.gbdt.fused_stats != []) == (name not in _RENEW)
    losses = ev["valid_0"][name if name != "cross_entropy_lambda"
                           else "cross_entropy_lambda"]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pct", [0.5, 0.7])
def test_renew_tree_output_equals_jax(pct, weighted):
    rng = np.random.RandomState(5 + weighted)
    n, leaves = 800, 15
    stack = _random_stack(rng, 1, 2 * leaves, leaves, 4, 16, 1, 0.0)
    tree = type(stack)(*[t[0] for t in stack])
    leaf_ids = np.nonzero(tree.split_feature.numpy() < 0)[0]
    leaf_ids = leaf_ids[leaf_ids < 2 * leaves - 1]
    row_node = rng.choice(leaf_ids, n).astype(np.int32)
    score = rng.randn(n).astype(np.float32)
    label = (rng.randn(n) + 0.5).astype(np.float32)
    # integer weights (bagged counts x 1 or 2) keep every cumulative sum
    # exact, so both sides pick the same row; some rows out of the bag
    weight = (rng.rand(n) < 0.8).astype(np.float32)
    if weighted:
        weight *= rng.randint(1, 3, n).astype(np.float32)
    got = renew_tree_output(tree, torch.as_tensor(row_node),
                            torch.as_tensor(score), torch.as_tensor(label),
                            torch.as_tensor(weight), pct)
    want = jrenew.renew_tree_output(
        _to_jax(tree), jnp.asarray(row_node), jnp.asarray(score),
        jnp.asarray(label), jnp.asarray(weight), pct, leaves)
    np.testing.assert_array_equal(got.leaf_value.numpy(),
                                  np.asarray(want.leaf_value))
    # the renewed leaves hold the weighted percentile of their residuals
    resid = label - score
    for leaf in leaf_ids[:4]:
        rows = (row_node == leaf) & (weight > 0)
        if not rows.any():
            continue
        r, w = resid[rows], weight[rows]
        order = np.argsort(r, kind="stable")
        cw = np.cumsum(w[order])
        pick = r[order][np.searchsorted(cw, pct * cw[-1])]
        assert got.leaf_value[leaf].item() == pick


def test_aliases_and_unknown_objective():
    for alias, canonical in OBJECTIVE_ALIASES.items():
        params = {"objective": alias, "num_class": 3}
        obj = create_objective(alias, Config(params))
        if canonical == "none":
            assert obj is None
        else:
            assert obj.name == canonical
    with pytest.raises(lgt.LightGBMError, match="Unknown objective"):
        create_objective("hinge", Config({}))
    with pytest.raises(lgt.LightGBMError, match="negative"):
        obj = create_objective("poisson", Config({}))
        obj.init(Metadata(2, label=np.array([1, -1], np.float32)), 2,
                 torch.device("cpu"))
