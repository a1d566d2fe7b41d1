"""Validation sets, metrics, callbacks and early stopping (engine.train,
Booster.add_valid / eval_valid / rollback_one_iter, GBDT.train_many's
valid-score trajectory) on the CPU, against the port's own per-iteration
path and against the JAX package.

Within the port the bars are exact: the block's trajectory equals the
per-iteration valid scores bit for bit; fused_block_size 5 and 1 give
byte-equal model text (once the `[fused_block_size: ...]` echo line is
dropped), equal best_iteration and equal best_score. Against the JAX
package (its MXU growth path in Pallas interpret mode, as
tests/test_torch_train.py runs it): metric values on the same scores
within rtol 1e-6 (the f32 sigmoid of the two libraries' exp); models at
the exact-mode bars of tests/test_torch_train.py (structure identical,
values within 1e-4); best_iteration equal on a valid set whose metric
has no near-tie at the best iteration (checked: the best beats every
other iteration by more than the two packages' metric difference);
recorded metric values within rtol 1e-4. Data from numpy seeds stated
in each helper.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu.metrics as jmetrics
from lightgbm_tpu import engine as jengine
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Metadata as JMetadata
from lightgbm_tpu.objectives import create_objective as jcreate_objective
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "verbosity": -1, "min_data_in_leaf": 5,
          "metric": "binary_logloss,auc", "device_type": "cpu"}


def _data(n=600, f=5, seed=0, noise=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + noise * rng.randn(n) > 0) \
        .astype(np.float32)
    return X, y


def _strip(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[fused_block_size:"))


def _jax_params(params):
    return {k: v for k, v in params.items() if k != "device_type"}


class _MxuBooster(lgb.Booster):
    """The JAX Booster on its MXU growth path in Pallas interpret mode."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.gbdt is not None:
            self.gbdt._hist_impl = "mxu"
            self.gbdt._mxu_interpret = True


@pytest.fixture
def jax_train(monkeypatch):
    monkeypatch.setattr(jengine, "Booster", _MxuBooster)
    return jengine.train


# ---------------------------------------------------------------------------
# metrics.py against lightgbm_tpu.metrics
_BINARY = ("binary_logloss", "binary_error", "auc", "average_precision",
           "cross_entropy", "kullback_leibler")
_REGRESSION = ("l2", "rmse", "l1", "quantile", "huber", "fair", "poisson",
               "mape", "gamma", "gamma_deviance", "tweedie",
               "cross_entropy_lambda")


_MULTICLASS = ("multi_logloss", "multi_error", "auc_mu")
_RANKING = ("ndcg", "map")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", _BINARY + _REGRESSION + _MULTICLASS +
                         _RANKING)
def test_metric_equals_jax(name, weighted):
    rng = np.random.RandomState(1)
    n = 500
    score = rng.randn(n).astype(np.float32)
    group = None
    params = {"alpha": 0.7}
    if name in _BINARY:
        label = (rng.rand(n) < 0.4).astype(np.float32)
        objective = "binary"
    elif name in _MULTICLASS:
        label = rng.randint(0, 3, n).astype(np.float32)
        score = rng.randn(n, 3).astype(np.float32)
        objective = "multiclass"
        params.update(num_class=3, multi_error_top_k=2)
    elif name in _RANKING:
        label = rng.randint(0, 4, n).astype(np.float32)
        objective = "lambdarank"
        group = [20] * (n // 20)
        params.update(eval_at=[1, 3, 10])
    else:
        label = np.abs(rng.randn(n)).astype(np.float32) + 0.1
        score = np.abs(score) + 0.05
        objective = "regression"
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    params["objective"] = objective
    cfg, jcfg = Config(params), JConfig(params)
    m = metrics.create_metric(name, cfg)
    jm = jmetrics.create_metric(name, jcfg)
    m.init(Metadata(n, label=label, weight=weight, group=group), n)
    jm.init(JMetadata(n, label=label, weight=weight, group=group), n)
    obj, jobj = create_objective(objective, cfg), jcreate_objective(
        objective, jcfg)
    got = m.evaluate(score, obj.convert_output)
    want = jm.evaluate(score, lambda s: np.asarray(
        jobj.convert_output(jnp.asarray(s))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert m.name == jm.name
    if name in _RANKING:
        got, want = m.evaluate_multi(score), jm.evaluate_multi(score)
        assert list(got) == list(want) == [f"{name}@{k}" for k in (1, 3, 10)]
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# valid sets against the port's per-iteration path
def _booster(X, y, Xv, yv, params=PARAMS):
    ds = lgt.Dataset(X, label=y, params=params)
    bst = lgt.Booster(params=dict(params), train_set=ds)
    bst.add_valid(ds.create_valid(Xv, label=yv), "v")
    return bst


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("lead", [0, 1])
def test_valid_scores_and_trajectory_match_per_iteration(lead):
    # lead 1: iteration 0 ran first (update), the block is all fused;
    # lead 0: the block starts at iteration 0, its first point from
    # train_one_iter, the rest from the fused trees' trajectory
    X, y = _data(seed=11)
    Xv, yv = _data(n=200, seed=12)
    a = _booster(X, y, Xv, yv)
    b = _booster(X, y, Xv, yv)
    per_iter = []
    for _ in range(lead):
        a.update()
        b.update()
    a.update_batch(4)
    traj = a.gbdt._fused_valid_traj
    assert traj is not None and len(traj) == 1 and traj[0].shape[0] == 4
    for _ in range(4):
        b.update()
        per_iter.append(b.gbdt.valid_scores[0].clone())
    assert a.current_iteration() == b.current_iteration() == 4 + lead
    assert a.model_to_string() == b.model_to_string()
    assert torch.equal(_bits(a.gbdt.valid_scores[0]), _bits(per_iter[-1]))
    for j in range(4):
        assert torch.equal(_bits(traj[0][j]), _bits(per_iter[j])), j
    # and the host model agrees with the device valid scores
    np.testing.assert_allclose(a.predict(Xv, raw_score=True),
                               a.gbdt.valid_scores[0].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_add_valid_after_training_replays_the_trees():
    X, y = _data(seed=13)
    Xv, yv = _data(n=200, seed=14)
    a = _booster(X, y, Xv, yv)
    for _ in range(3):
        a.update()
    late = lgt.Booster(params=dict(PARAMS),
                       train_set=lgt.Dataset(X, label=y, params=PARAMS))
    for _ in range(3):
        late.update()
    late.add_valid(late.train_set.create_valid(Xv, label=yv), "v")
    np.testing.assert_allclose(late.gbdt.valid_scores[0].numpy(),
                               a.gbdt.valid_scores[0].numpy(), rtol=0,
                               atol=1e-6)
    assert late.eval_valid()[0][:2] == ("v", "binary_logloss")


def test_rollback_restores_scores_on_packed_bins():
    # max_bin 15: the training bins are stored 4-bit and unpacked for the
    # rollback's walk
    X, y = _data(seed=15)
    Xv, yv = _data(n=200, seed=16)
    params = dict(PARAMS, max_bin=15)
    bst = _booster(X, y, Xv, yv, params)
    for _ in range(2):
        bst.update()
    assert bst.gbdt._packed4
    train2, valid2 = (bst.gbdt.train_score.clone(),
                      bst.gbdt.valid_scores[0].clone())
    text2 = bst.model_to_string()
    bst.update_batch(3)
    bst.rollback_one_iter().rollback_one_iter().rollback_one_iter()
    assert bst.current_iteration() == 2
    assert bst.model_to_string() == text2
    # add-then-subtract: within a rounding a tree
    np.testing.assert_allclose(bst.gbdt.train_score.numpy(), train2.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bst.gbdt.valid_scores[0].numpy(),
                               valid2.numpy(), rtol=0, atol=1e-6)


def _train_es(block, X, y, Xv, yv, rounds=25, extra=None, valid2=None):
    params = dict(PARAMS, early_stopping_round=2, fused_block_size=block,
                  **(extra or {}))
    ds = lgt.Dataset(X, label=y, params=params)
    valid_sets = [ds.create_valid(Xv, label=yv)]
    if valid2 is not None:
        valid_sets.append(ds.create_valid(*valid2))
    ev = {}
    bst = lgt.train(params, ds, rounds, valid_sets=valid_sets,
                    callbacks=[lgt.record_evaluation(ev)])
    return bst, ev


@pytest.mark.parametrize("extra", [{}, {"first_metric_only": True,
                                        "metric": "auc,binary_logloss"}])
def test_engine_block_early_stopping_matches_per_iteration(extra):
    X, y = _data(seed=13)
    rng = np.random.RandomState(14)
    Xv = rng.randn(200, 5).astype(np.float32)
    yv = (Xv[:, 0] + 1.5 * rng.randn(200) > 0).astype(np.float32)
    valid2 = _data(n=150, seed=17, noise=1.0)
    a, ev_a = _train_es(5, X, y, Xv, yv, extra=extra, valid2=valid2)
    b, ev_b = _train_es(1, X, y, Xv, yv, extra=extra, valid2=valid2)
    assert a.best_iteration == b.best_iteration
    assert a.current_iteration() == b.current_iteration()
    assert dict(a.best_score) == dict(b.best_score)
    assert ev_a == ev_b
    assert _strip(a.model_to_string()) == _strip(b.model_to_string())
    # the stop engaged inside a block (else the rollback went untested)
    assert a.current_iteration() < 25 and a.current_iteration() % 5 != 0
    assert a.gbdt._fused_run is None
    # the valid scores are the best-so-far trajectory point's, not the
    # subtraction's: equal to the per-iteration run's
    for i in range(2):
        assert torch.equal(_bits(a.gbdt.valid_scores[i]),
                           _bits(b.gbdt.valid_scores[i]))


def test_record_evaluation_and_log_evaluation(caplog):
    X, y = _data(seed=18)
    Xv, yv = _data(n=200, seed=19, noise=0.5)
    ev = {}
    params = dict(PARAMS, fused_block_size=3)
    ds = lgt.Dataset(X, label=y, params=params)
    bst = lgt.train(params, ds, 7,
                    valid_sets=[ds.create_valid(Xv, label=yv)],
                    valid_names=["held_out"],
                    callbacks=[lgt.record_evaluation(ev),
                               lgt.log_evaluation(1)])
    assert list(ev) == ["held_out"]
    assert list(ev["held_out"]) == ["binary_logloss", "auc"]
    assert all(len(v) == 7 for v in ev["held_out"].values())
    # the last recorded values are the booster's evaluation now
    now = {name: val for _, name, val, _ in bst.eval_valid()}
    assert now == {k: v[-1] for k, v in ev["held_out"].items()}
    assert dict(bst.best_score)["held_out"]["auc"] == ev["held_out"]["auc"][-1]
    assert bst.best_iteration == 7


# ---------------------------------------------------------------------------
# against the JAX package's engine.train
def test_valid_dataset_bins_equal_jax():
    X, y = _data(n=800, seed=20)
    Xv, yv = _data(n=300, seed=21)
    Xv[:5, 0] = 1e6     # beyond the training range
    ds = lgt.Dataset(X, label=y, params=PARAMS)
    jds = lgb.Dataset(X, label=y, params=_jax_params(PARAMS))
    v = ds.create_valid(Xv, label=yv).binned
    jv = jds.create_valid(Xv, label=yv).binned
    assert np.array_equal(v.used_features, jv.used_features)
    assert v.bins.dtype == jv.bins.dtype
    assert np.array_equal(v.bins, jv.bins)


def test_best_iteration_equals_jax(jax_train):
    X, y = _data(n=800, seed=22, noise=0.7)
    Xv, yv = _data(n=400, seed=23, noise=0.7)
    params = dict(PARAMS, early_stopping_round=3, metric="binary_logloss")
    ev, jev = {}, {}
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), 30,
                    valid_sets=[lgt.Dataset(Xv, label=yv)],
                    callbacks=[lgt.record_evaluation(ev)])
    jp = dict(_jax_params(params), fused_block_size=1, pipeline=False)
    jbst = jax_train(jp, lgb.Dataset(X, label=y, params=jp), 30,
                     valid_sets=[lgb.Dataset(Xv, label=yv)],
                     callbacks=[lgb.record_evaluation(jev)])
    curve = np.asarray(ev["valid_0"]["binary_logloss"])
    jcurve = np.asarray(jev["valid_0"]["binary_logloss"])
    np.testing.assert_allclose(curve, jcurve, rtol=1e-4)
    best = bst.best_iteration - 1
    # no near-tie at the best: it beats every other iteration by more
    # than the two packages' largest metric difference
    gap = np.delete(curve, best) - curve[best]
    assert gap.min() > np.abs(curve - jcurve).max()
    assert bst.best_iteration == jbst.best_iteration
    assert bst.current_iteration() == jbst.current_iteration() < 30
    np.testing.assert_allclose(
        bst.best_score["valid_0"]["binary_logloss"],
        jbst.best_score["valid_0"]["binary_logloss"], rtol=1e-4)


def _binary_fobj(score, data):
    y = data.label if data.label is not None else data.binned.metadata.label
    p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def _error_feval(score, data):
    y = data.label if data.label is not None else data.binned.metadata.label
    return "error", float(np.mean((np.asarray(score) > 0) != (y > 0))), False


def test_fobj_and_feval_equal_jax(jax_train):
    X, y = _data(n=800, seed=24, noise=0.5)
    Xv, yv = _data(n=300, seed=25, noise=0.5)
    params = dict(PARAMS, metric="auc", free_raw_data=False)
    ev, jev = {}, {}
    bst = lgt.train(params, lgt.Dataset(X, label=y), 5,
                    valid_sets=[lgt.Dataset(Xv, label=yv)],
                    fobj=_binary_fobj, feval=_error_feval,
                    callbacks=[lgt.record_evaluation(ev)])
    jp = dict(_jax_params(params), pipeline=False)
    jbst = jax_train(jp, lgb.Dataset(X, label=y), 5,
                     valid_sets=[lgb.Dataset(Xv, label=yv)],
                     fobj=_binary_fobj, feval=_error_feval,
                     callbacks=[lgb.record_evaluation(jev)])
    assert "objective=none" in bst.model_to_string()
    assert bst.gbdt.objective is None and bst.gbdt._const_hessian() == 0.0
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    assert list(ev["valid_0"]) == list(jev["valid_0"]) == ["auc", "error"]
    for name in ("auc", "error"):
        np.testing.assert_allclose(ev["valid_0"][name],
                                   jev["valid_0"][name], rtol=1e-4)


def test_update_fobj_drops_the_const_hessian_gate():
    X, y = _data(seed=26)
    params = dict(PARAMS, objective="regression", metric="l2")
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    bst.update()
    assert bst.gbdt._const_hessian() == 1.0

    def fobj(score, data):
        return (score - y).astype(np.float32), np.full_like(score, 2.0)
    bst.update(fobj=fobj)
    assert bst.gbdt._const_hessian() == 0.0
    assert not bst.gbdt._fused_eligible()
    # two per-row hessians of 2: each leaf is -G / (2 n)
    bst.update(fobj=fobj)
    assert bst.current_iteration() == 3


def test_init_model_continuation_equals_jax(jax_train):
    X, y = _data(n=800, seed=27, noise=0.5)
    Xv, yv = _data(n=300, seed=28, noise=0.5)
    params = dict(PARAMS, free_raw_data=False)
    jp = dict(_jax_params(params), pipeline=False)
    base = lgt.train(params, lgt.Dataset(X, label=y, free_raw_data=False), 3)
    jbase = jax_train(jp, lgb.Dataset(X, label=y, free_raw_data=False), 3)
    ev = {}
    valid = lgt.Dataset(Xv, label=yv, free_raw_data=False)
    bst = lgt.train(params, lgt.Dataset(X, label=y, free_raw_data=False), 4,
                    valid_sets=[valid], init_model=base,
                    callbacks=[lgt.record_evaluation(ev)])
    jbst = jax_train(jp, lgb.Dataset(X, label=y, free_raw_data=False), 4,
                     valid_sets=[lgb.Dataset(Xv, label=yv,
                                             free_raw_data=False)],
                     init_model=jbase)
    assert bst.current_iteration() == bst.num_trees() == 7
    assert bst.best_iteration == jbst.best_iteration == 7
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    # the merged model's prediction is the base's plus the new trees'; the
    # valid scores started from the base model's predictions
    new = bst.predict(Xv, raw_score=True, start_iteration=3)
    np.testing.assert_allclose(base.predict(Xv, raw_score=True) + new,
                               bst.predict(Xv, raw_score=True), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bst.gbdt.valid_scores[0].numpy(),
                               bst.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    assert len(ev["valid_0"]["auc"]) == 4
    # a plain train() on the same datasets drops the seeded init scores
    again = lgt.train(params, lgt.Dataset(X, label=y), 3)
    assert again.model_to_string() == base.model_to_string()


def test_init_model_early_stop_counts_the_base_iterations():
    X, y = _data(n=600, seed=29)
    rng = np.random.RandomState(30)
    Xv = rng.randn(200, 5).astype(np.float32)
    yv = (rng.rand(200) < 0.5).astype(np.float32)
    params = dict(PARAMS, free_raw_data=False)
    base = lgt.train(params, lgt.Dataset(X, label=y, free_raw_data=False), 4)
    bst = lgt.train(dict(params, early_stopping_round=2),
                    lgt.Dataset(X, label=y, free_raw_data=False), 20,
                    valid_sets=[lgt.Dataset(Xv, label=yv,
                                            free_raw_data=False)],
                    init_model=base)
    assert bst.current_iteration() < 24
    assert 4 < bst.best_iteration <= bst.current_iteration()


def test_reset_parameter_equals_jax(jax_train):
    X, y = _data(n=800, seed=31, noise=0.3)
    Xv, yv = _data(n=200, seed=32, noise=0.3)
    schedule = [0.3, 0.2, 0.15, 0.1, 0.05]
    bst = lgt.train(PARAMS, lgt.Dataset(X, label=y), 5,
                    valid_sets=[lgt.Dataset(Xv, label=yv)],
                    callbacks=[lgt.reset_parameter(learning_rate=schedule)])
    jp = dict(_jax_params(PARAMS), pipeline=False)
    jbst = jax_train(jp, lgb.Dataset(X, label=y), 5,
                     valid_sets=[lgb.Dataset(Xv, label=yv)],
                     callbacks=[lgb.reset_parameter(learning_rate=schedule)])
    assert bst.config.learning_rate == 0.05
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())


def test_reset_parameter_releases_the_fused_trainer():
    X, y = _data(seed=33)
    bst = lgt.Booster(dict(PARAMS), lgt.Dataset(X, label=y, params=PARAMS))
    bst.update_batch(3)
    assert bst.gbdt._fused_run is not None
    bst.reset_parameter({"learning_rate": 0.05})
    assert bst.gbdt._fused_run is None
    assert bst.gbdt.shrinkage_rate == 0.05


def test_feval_and_training_set_take_the_per_iteration_cadence():
    # feval and the training set among the valid sets: one iteration a
    # dispatch, the model of the block path
    X, y = _data(seed=34)
    Xv, yv = _data(n=200, seed=35)
    params = dict(PARAMS, fused_block_size=4)
    ds = lgt.Dataset(X, label=y, params=params)
    a = lgt.train(params, ds, 6, valid_sets=[ds.create_valid(Xv, label=yv)])
    ev = {}
    ds2 = lgt.Dataset(X, label=y, params=params)
    b = lgt.train(params, ds2, 6,
                  valid_sets=[ds2, ds2.create_valid(Xv, label=yv)],
                  valid_names=["train", "held_out"], feval=_error_feval,
                  callbacks=[lgt.record_evaluation(ev)])
    assert b.gbdt.fused_stats == [] and a.gbdt.fused_stats != []
    assert a.model_to_string() == b.model_to_string()
    assert list(ev) == ["train", "held_out"]
    assert list(ev["train"]) == ["binary_logloss", "auc", "error"]


def test_callbacks_params_are_not_mutated():
    X, y = _data(seed=36)
    params = dict(PARAMS, num_iterations=3)
    keep = copy.deepcopy(params)
    lgt.train(params, lgt.Dataset(X, label=y), 10)
    assert params == keep


@pytest.mark.parametrize("metric", [["binary_logloss", "auc"],
                                    "binary_logloss,auc"])
def test_metric_list_or_string(metric):
    # a list as the reference takes it (the JAX copy of the config turns a
    # list into its repr, ROADMAP C9); both spellings give one booster
    X, y = _data(seed=37)
    Xv, yv = _data(n=200, seed=38)
    params = dict(PARAMS, metric=metric)
    ds = lgt.Dataset(X, label=y, params=params)
    bst = lgt.train(params, ds, 3, valid_sets=[ds.create_valid(Xv,
                                                               label=yv)])
    assert [name for _, name, _, _ in bst.eval_valid()] == \
        ["binary_logloss", "auc"]
