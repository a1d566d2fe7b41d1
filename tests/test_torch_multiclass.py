"""Multiclass training (k trees an iteration) on the CPU, against the JAX
package and against the port's own per-iteration path.

The softmax and one-vs-all objectives' gradients (the port class-major
[k, N], the JAX package [N, k]) agree within 1e-6 relative; boosters of
both (JAX: its MXU growth path in Pallas interpret mode, as
tests/test_torch_train.py runs it) write the same model at the exact-mode
bars of that file (structure identical, values within 1e-4) per
iteration, with bagging, GOSS, random forest and DART, and so through
the fused trainer, whose models equal update()'s byte for byte below; a
quantized run's training loss comes within 1% of the exact run's (its
trees cannot be held to the JAX package's, whose rounding differs,
ROADMAP C2). Within
the port the bars are exact: train's block dispatch and update_batch
write update()'s model text byte for byte and its scores bit for bit, the
valid-score trajectory of a block equals the per-iteration valid scores,
an early stop inside a block equals fused_block_size 1's, and kernel V's
class mode (its plain version here) equals the JAX package's
stacked_score_traj(num_class=3). Data: numpy seeds stated in each helper;
k = 3, at most 2,000 rows x 6 features, 7 leaves, 5 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.boosting.fused import stacked_score_traj as jax_traj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Metadata as JMetadata
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu import engine as jengine
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting import fused
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Metadata
from lightgbm_tpu_torch.learner import predict
from lightgbm_tpu_torch.learner.grower import TreeArrays
from lightgbm_tpu_torch.objectives import create_objective
from tests.test_torch_predict_binned import _inputs, _random_stack, _to_jax
from tests.test_torch_sync_free import _watch, _within
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

K = 3


_BASE = {"objective": "multiclass", "num_class": K, "num_leaves": 7,
         "learning_rate": 0.2, "max_bin": 31, "min_data_in_leaf": 5,
         "verbosity": -1}
_ROUNDS = 5


def _data(n=1500, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.05, 3] = np.nan
    logit = X[:, 0] + 0.6 * X[:, 1] + 0.4 * rng.randn(n)
    y = np.digitize(logit, [-0.4, 0.5]).astype(np.float32)
    return X, y


def _jax_booster(X, y, params):
    bst = lgb.Booster(dict(params, pipeline=False),
                      lgb.Dataset(X, label=y, params=params))
    bst.gbdt._hist_impl = "mxu"          # the TPU growth path ...
    bst.gbdt._mxu_interpret = True       # ... in Pallas interpret mode
    return bst


def _port_booster(X, y, params, **kw):
    p = dict(params, device_type="cpu")
    return lgt.Booster(p, lgt.Dataset(X, label=y, params=p, **kw))


def _strip(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[fused_block_size:"))


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# the objectives
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["multiclass", "multiclassova"])
def test_gradients_equal_jax(name, weighted):
    rng = np.random.RandomState(1)
    n = 400
    label = rng.randint(0, K, n).astype(np.float32)
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    score = (2 * rng.randn(n, K)).astype(np.float32)
    params = {"objective": name, "num_class": K}
    obj = create_objective(name, Config(params))
    obj.init(Metadata(n, label=label, weight=weight), n, torch.device("cpu"))
    jobj = jcreate(name, JConfig(params))
    jobj.init(JMetadata(n, label=label, weight=weight), n)
    assert obj.num_model_per_iteration == jobj.num_model_per_iteration == K
    assert not obj.is_constant_hessian and not obj.need_renew_tree_output
    g, h = obj.get_gradients(torch.as_tensor(np.ascontiguousarray(score.T)))
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    np.testing.assert_allclose(g.numpy().T, np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(h.numpy().T, np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    for c in range(K):
        assert obj.boost_from_score(c) == pytest.approx(
            jobj.boost_from_score(c), rel=1e-12)
    np.testing.assert_allclose(obj.convert_output(score),
                               np.asarray(jobj.convert_output(
                                   jnp.asarray(score))), rtol=1e-6)


def test_multiclass_needs_labels_in_range():
    params = {"objective": "multiclass", "num_class": K}
    obj = create_objective("multiclass", Config(params))
    with pytest.raises(lgt.LightGBMError, match="Label must be in"):
        obj.init(Metadata(3, label=np.array([0, 1, 3], np.float32)), 3,
                 torch.device("cpu"))
    with pytest.raises(ValueError, match="num_class >= 2"):
        create_objective("multiclass", Config({"num_class": 1}))


# ---------------------------------------------------------------------------
# boosters against lightgbm_tpu
_MODES = {
    "softmax": {},
    "ova": {"objective": "multiclassova"},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.2},
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_booster_matches_jax_package(mode):
    X, y = _data()
    params = dict(_BASE, **_MODES[mode])
    jb = _jax_booster(X, y, params)
    tb = _port_booster(X, y, params)
    for _ in range(_ROUNDS):
        jb.update()
        tb.update()
    assert tb.num_trees() == jb.num_trees() == K * _ROUNDS
    assert tb.num_trees_per_iteration == K
    assert tb.gbdt.tree_class == jb.gbdt.tree_class
    _assert_same_model(jb.model_to_string(), tb.model_to_string())
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.gbdt.train_score_host(),
                               np.asarray(jb.gbdt.train_score), rtol=1e-4,
                               atol=1e-4)
    if mode == "dart":
        assert tb.gbdt.tree_weights == jb.gbdt.tree_weights
    if mode == "rf":
        np.testing.assert_allclose(tb.gbdt._init_scores,
                                   jb.gbdt._init_scores, rtol=1e-6)


def test_quantized_within_one_percent_of_exact():
    X, y = _data()
    params = dict(_BASE, metric="multi_logloss")
    losses = {}
    for q in (False, True):
        tb = _port_booster(X, y, dict(params, use_quantized_grad=q))
        for _ in range(_ROUNDS):
            tb.update()
        losses[q] = tb.eval_train()[0][2]
    assert losses[True] == pytest.approx(losses[False], rel=0.01)


# ---------------------------------------------------------------------------
# within the port: the fused trainer against update()
_FUSED = {
    "exact": {},
    "quantized": {"use_quantized_grad": True},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "bagging_ova": {"objective": "multiclassova", "bagging_fraction": 0.7,
                    "bagging_freq": 2},
}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_fused_equals_update_loop(name):
    X, y = _data()
    params = dict(_BASE, fused_block_size=3, **_FUSED[name])
    a = _port_booster(X, y, params)
    for _ in range(7):
        a.update()
    b = _port_booster(X, y, params)
    b.update_batch(4)                     # iteration 0, then 3 fused
    b.update_batch(3)
    assert b.gbdt._fused_run.stats["trees"] == 6 * K
    assert _strip(a.model_to_string()) == _strip(b.model_to_string())
    assert torch.equal(_bits(a.gbdt.train_score), _bits(b.gbdt.train_score))
    c = lgt.train(dict(params, device_type="cpu"),
                  lgt.Dataset(X, label=y, params=params), 7)
    assert _strip(a.model_to_string()) == _strip(c.model_to_string())


def test_fused_programs_do_not_sync(monkeypatch):
    X, y = _data()
    bst = _port_booster(X, y, _BASE)
    bst.update()
    mode = _watch(monkeypatch)
    monkeypatch.setattr(fused.FusedTrainer, "_run", _within(
        mode, "program", fused.FusedTrainer._run))
    with mode:
        bst.update_batch(2)
    stats = bst.gbdt._fused_run.stats
    assert stats["trees"] == 2 * K and "gradients" in bst.gbdt._fused_run \
        .programs
    inside = {k: v for k, v in mode.counts.items() if k[0] != "outside"}
    assert inside == {}, inside


# ---------------------------------------------------------------------------
# valid sets, early stopping, predict, rollback
def test_valid_trajectory_and_early_stop():
    X, y = _data()
    Xv, yv = _data(500, seed=4)
    ev = {}
    results = {}
    for block in (1, 4):
        p = dict(_BASE, metric="multi_logloss,multi_error,auc_mu",
                 fused_block_size=block, device_type="cpu")
        ds = lgt.Dataset(X, label=y, params=p)
        ev[block] = {}
        results[block] = lgt.train(
            p, ds, 8, valid_sets=[ds.create_valid(Xv, label=yv)],
            callbacks=[lgt.record_evaluation(ev[block])])
    assert ev[1] == ev[4]
    assert _strip(results[1].model_to_string()) == \
        _strip(results[4].model_to_string())
    assert torch.equal(_bits(results[1].gbdt.valid_scores[0]),
                       _bits(results[4].gbdt.valid_scores[0]))
    # the valid scores are the host model's raw predictions
    np.testing.assert_allclose(results[4].gbdt.valid_scores[0].numpy(),
                               results[4].predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    assert ev[4]["valid_0"]["multi_logloss"][-1] < \
        ev[4]["valid_0"]["multi_logloss"][0]
    # an early stop inside a block: labels the features do not predict
    # (the block loop's float64 metrics: the pipelined executor's device
    # metrics are tests/test_torch_pipeline.py's)
    yp = np.random.RandomState(8).permutation(yv)
    stopped = {}
    for block in (1, 5):
        p = dict(_BASE, metric="multi_logloss", fused_block_size=block,
                 early_stopping_round=2, device_type="cpu", pipeline=False)
        ds = lgt.Dataset(X, label=y, params=p)
        stopped[block] = lgt.train(
            p, ds, 10, valid_sets=[ds.create_valid(Xv, label=yp)])
    assert stopped[1].best_iteration == stopped[5].best_iteration < 8
    assert stopped[1].num_trees() == stopped[5].num_trees()
    assert stopped[1].best_score == stopped[5].best_score


def test_valid_metrics_match_jax_engine(monkeypatch):
    X, y = _data()
    Xv, yv = _data(500, seed=4)
    params = dict(_BASE, metric="multi_logloss,multi_error")

    class MxuBooster(lgb.Booster):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if self.gbdt is not None:
                self.gbdt._hist_impl = "mxu"
                self.gbdt._mxu_interpret = True
    monkeypatch.setattr(jengine, "Booster", MxuBooster)
    ev_j, ev_t = {}, {}
    jds = lgb.Dataset(X, label=y, params=params)
    # one iteration a dispatch on the JAX side: its block dispatch gives
    # the same models (tests/test_fused.py) and would compile its scan
    jb = jengine.train(dict(params, pipeline=False, fused_block_size=1),
                       jds, 4,
                       valid_sets=[jds.create_valid(Xv, label=yv)],
                       callbacks=[lgb.record_evaluation(ev_j)])
    p = dict(params, device_type="cpu")
    tds = lgt.Dataset(X, label=y, params=p)
    tb = lgt.train(p, tds, 4, valid_sets=[tds.create_valid(Xv, label=yv)],
                   callbacks=[lgt.record_evaluation(ev_t)])
    np.testing.assert_allclose(ev_t["valid_0"]["multi_logloss"],
                               ev_j["valid_0"]["multi_logloss"], rtol=1e-4)
    np.testing.assert_allclose(ev_t["valid_0"]["multi_error"],
                               ev_j["valid_0"]["multi_error"], atol=0.005)
    _assert_same_model(jb.model_to_string(), tb.model_to_string())


def test_predict_model_text_and_rollback(tmp_path):
    X, y = _data()
    tb = _port_booster(X, y, _BASE)
    for _ in range(3):
        tb.update()
    prob = tb.predict(X)
    assert prob.shape == (len(X), K)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=1e-6)
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, tb.gbdt.train_score_host(), rtol=1e-5,
                               atol=1e-5)
    leaves = tb.predict(X, pred_leaf=True)
    assert leaves.shape == (len(X), 3 * K)
    text = tb.model_to_string()
    assert f"num_class={K}" in text and \
        f"num_tree_per_iteration={K}" in text
    path = tmp_path / "m.txt"
    tb.save_model(str(path))
    loaded = lgt.Booster(model_file=str(path))
    assert loaded.num_trees_per_iteration == K
    np.testing.assert_array_equal(loaded.predict(X), prob)
    assert loaded.model_to_string() == text
    # rollback takes the last iteration's K trees off their classes
    before = tb.gbdt.train_score.clone()
    tb.update()
    tb.rollback_one_iter()
    assert tb.num_trees() == 3 * K
    np.testing.assert_allclose(tb.gbdt.train_score.numpy(), before.numpy(),
                               rtol=0, atol=1e-6)
    assert _strip(tb.model_to_string()) == _strip(text)


def test_custom_objective_and_init_score():
    """fobj sees [N, k] scores and returns [N, k] gradients; an init score
    [N, k] starts every class's score."""
    X, y = _data()
    onehot = np.eye(K, dtype=np.float32)[y.astype(int)]

    def fobj(score, data):
        assert score.shape == (len(y), K)
        e = np.exp(score - score.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
        return p - onehot, 1.5 * p * (1 - p)
    params = dict(_BASE, boost_from_average=False)
    a = _port_booster(X, y, params)
    b = _port_booster(X, y, dict(params, objective="none"))
    for _ in range(2):
        a.update()
        b.update(fobj=fobj)
    np.testing.assert_allclose(b.gbdt.train_score_host(),
                               a.gbdt.train_score_host(), atol=1e-5)
    init = np.random.RandomState(2).randn(len(y), K).astype(np.float32)
    c = _port_booster(X, y, _BASE, init_score=init)
    np.testing.assert_array_equal(c.gbdt.train_score_host(), init)


# ---------------------------------------------------------------------------
# kernel V's class mode (its plain version on the CPU)
def test_class_mode_traj_equals_jax():
    rng = np.random.RandomState(11)
    k_iter, leaves, f, bmax = 4, 15, 6, 64
    flat = _random_stack(rng, k_iter * K, 2 * leaves, leaves, f, bmax, 2,
                         0.3)
    stack = TreeArrays(*[t.reshape((k_iter, K) + tuple(t.shape[1:]))
                         for t in flat])
    bins, num_bins, nan = _inputs(rng, 500, f, bmax)
    score0 = rng.randn(500, K).astype(np.float32)
    tb, tn, tm = (torch.as_tensor(a) for a in (bins, num_bins, nan))
    fin, traj = predict.stacked_score_traj(stack, torch.as_tensor(score0),
                                           tb, tn, tm, num_class=K)
    assert traj.shape == (k_iter, 500, K)
    jfin, jtraj = jax_traj(_to_jax(stack), jnp.asarray(score0.copy()),
                           jnp.asarray(bins), jnp.asarray(num_bins),
                           jnp.asarray(nan), num_class=K)
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    # class_score_add: one tree into one column, the rest untouched
    prev = torch.as_tensor(score0)
    for i in range(k_iter):
        for c in range(K):
            tree = TreeArrays(*[t[i, c] for t in stack])
            nxt = predict.class_score_add(tree, prev, c, tb, tn, tm)
            want = prev[:, c] + predict.predict_binned_tree(tree, tb, tn, tm)
            assert torch.equal(nxt[:, c], want)
            others = [j for j in range(K) if j != c]
            assert torch.equal(nxt[:, others], prev[:, others])
            prev = nxt
        assert torch.equal(prev, traj[i])
