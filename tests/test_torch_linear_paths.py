"""Linear trees on the port's other paths (CPU, port only): DART, multiclass
valid scores, rollback and early stopping, the guard rails, the parameter
conflicts, sparse input, the model text (its round trip and the JAX
package reading it), and SHAP's refusal. The device scores are held to the
host model's float64 walk within 1e-5 (f32 against float64 sums of the
same models) wherever the scores are the model's."""

import os
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.conftest import make_multiclass
from tests.test_torch_linear_booster import piecewise
from tests.test_torch_one_thread import one_thread  # noqa: F401

P = {"objective": "regression", "num_leaves": 6, "verbosity": -1,
     "learning_rate": 0.3, "linear_tree": True, "linear_lambda": 0.1,
     "device_type": "cpu"}
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=1000, seed=0):
    return piecewise(n, seed=seed)


def _booster(params=P, rounds=4, valid=True, X=None, y=None):
    if X is None:
        X, y = _data()
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    Xv, yv = _data(400, seed=1) if params.get("num_class", 1) == 1 else \
        (X[:300], y[:300])
    if valid:
        bst.add_valid(lgt.Dataset(Xv, label=yv), "v")
    for _ in range(rounds):
        bst.update()
    return bst, X, Xv


def _check_scores(bst, X, Xv):
    g = bst.gbdt
    assert len(g.linear_models) == len(g.trees)
    np.testing.assert_allclose(g.train_score_host(),
                               bst.predict(X, raw_score=True), **TOL)
    if g.valid_sets:
        np.testing.assert_allclose(g.valid_scores[0].numpy(),
                                   bst.predict(Xv, raw_score=True), **TOL)


def test_dart_scales_the_leaf_models():
    """DART drops, rescales and restores linear trees: the scores stay the
    host model's (whose trees carry the scaled leaf models)."""
    params = dict(P, boosting="dart", drop_rate=0.5, skip_drop=0.0)
    bst, X, Xv = _booster(params, rounds=6)
    assert bst.gbdt.num_dropped > 0
    assert sum(lm is not None for lm in bst.gbdt.linear_models) >= 5
    _check_scores(bst, X, Xv)


def test_multiclass_linear_valid_scores():
    X, y = make_multiclass(n=900, f=4, k=3, seed=2)
    params = dict(P, objective="multiclass", num_class=3)
    bst, X, Xv = _booster(params, rounds=3, X=X.astype(np.float32), y=y)
    assert len(bst.gbdt.trees) == 9
    assert all(lm is not None for lm in bst.gbdt.linear_models[3:])
    _check_scores(bst, X, Xv)


def test_rollback_drops_the_leaf_models():
    bst, X, Xv = _booster(rounds=4)
    g = bst.gbdt
    keep = (g.train_score.clone(), g.valid_scores[0].clone())
    bst.update()
    bst.rollback_one_iter()
    assert len(g.trees) == len(g.linear_models) == 4
    # the subtraction leaves at most a last-bit residue
    np.testing.assert_allclose(g.train_score.numpy(), keep[0].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.valid_scores[0].numpy(), keep[1].numpy(),
                               rtol=0, atol=1e-5)
    _check_scores(bst, X, Xv)


def test_train_runs_per_iteration_and_early_stops():
    """train with a valid set runs one iteration a dispatch (not fused):
    the model is update()'s byte for byte; an early stop inside a block
    rolls the trees after the best iteration and their leaf models
    back."""
    X, y = _data()
    Xv, _ = _data(400, seed=1)
    yv = np.random.RandomState(9).permutation(y[:400])
    ds = lgt.Dataset(X, label=y, params=P)
    ev = {}
    bst = lgt.train(dict(P, early_stopping_round=2, metric="l2"), ds, 20,
                    valid_sets=[ds.create_valid(Xv, label=yv)],
                    callbacks=[lgt.record_evaluation(ev)])
    g = bst.gbdt
    assert not g._fused_eligible() and g._fused_run is None
    # the stop came inside the first block of 10: its later iterations
    # were rolled back
    assert 0 < bst.best_iteration <= bst.current_iteration() < 10
    assert len(g.trees) == len(g.linear_models) == bst.current_iteration()
    _check_scores(bst, X, Xv)
    plain, _, _ = _booster(dict(P, metric="l2"), rounds=5, valid=False)
    again = lgt.train(dict(P, metric="l2"), lgt.Dataset(X, label=y,
                                                        params=P), 5)
    assert again.model_to_string() == plain.model_to_string()


def test_skip_iteration_keeps_the_models_aligned():
    """guard_nonfinite=skip_iteration on a NaN gradient: the iteration's
    slot is a constant zero tree with no leaf model."""
    X, y = _data()
    params = dict(P, guard_nonfinite="skip_iteration")
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    calls = [0]

    def fobj(score, data):
        calls[0] += 1
        g = (score - y).astype(np.float32)
        if calls[0] == 2:
            g[3] = np.nan
        return g, np.ones_like(g)

    for _ in range(4):
        bst.update(fobj=fobj)
    g = bst.gbdt
    assert len(g.trees) == len(g.linear_models) == 4
    assert g.linear_models[1] is None and int(g.trees[1].num_leaves) == 1
    assert all(g.linear_models[i] is not None for i in (0, 2, 3))
    np.testing.assert_allclose(g.train_score_host(),
                               bst.predict(X, raw_score=True), **TOL)


@pytest.mark.parametrize("extra, match", [
    ({"boosting": "goss"}, "goss"),
    ({"objective": "regression_l1"}, "regression_l1"),
    ({"zero_as_missing": True}, "zero_as_missing"),
])
def test_linear_conflicts_raise(extra, match):
    X, y = _data(200)
    with pytest.raises(ValueError, match=match):
        lgt.train(dict(P, **extra), lgt.Dataset(X, label=y), 1)


def test_non_serial_learner_is_set_serial():
    cfg = lgt.Config(dict(P, tree_learner="data"))
    assert cfg.tree_learner == "serial"


def test_sparse_input_raises():
    X, y = _data(200)
    with pytest.raises(ValueError, match="dense input"):
        lgt.train(P, lgt.Dataset(sp.csr_matrix(X), label=y), 1)


def test_dataset_without_raw_values_raises():
    X, y = _data(200)
    ds = lgt.Dataset(X, label=y).construct()
    assert ds.binned.raw is None
    with pytest.raises(ValueError, match="raw feature values"):
        lgt.Booster(P, ds)


def test_model_text_round_trip_and_jax_reads_it():
    """The text keeps the linear sections; read back by the port and by
    the JAX package, its predictions equal the port's within 1e-12
    relative (the text's positional %.17f loses digits of coefficients
    below 1; the JAX package's walk takes a matrix product)."""
    bst, X, _ = _booster(valid=False)
    text = bst.model_to_string()
    assert text.count("is_linear=1") == 4
    assert "leaf_const=" in text and "leaf_coeff=" in text
    want = bst.predict(X)
    back = lgt.Booster(model_str=text)
    assert back.model_to_string() == text
    np.testing.assert_allclose(back.predict(X), want, rtol=1e-12,
                               atol=1e-12)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        jb = lgb.Booster(model_file=path)
    np.testing.assert_allclose(jb.predict(X), want, rtol=1e-12, atol=1e-12)


def test_pred_contrib_refuses_linear_trees():
    bst, X, _ = _booster(rounds=2, valid=False)
    with pytest.raises(NotImplementedError, match="linear trees"):
        bst.predict(X[:5], pred_contrib=True)
