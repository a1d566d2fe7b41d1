"""The pipelined executor (lightgbm_tpu_torch/pipeline/) on the CPU.

Against the JAX package: the adaptive block scheduler's next_block
sequence over scripted observe sequences (exact), PipelineStats.as_dict
(exact), the device-eval support matrix (exact) and every supported
metric's device value on the same numpy trajectory, weighted and not
(rtol 1e-6: both reduce in f32, in their own summation order), and the
best_iteration of an early-stopped train.

Within the port: `pipeline=true` writes the byte-identical model text of
`pipeline=false` (the non-pipelined block loop, the parity oracle) once
the `[pipeline*` and `[fused_block_size` echo lines are dropped, for
binary, regression, multiclass, bagging, GOSS, quantized gradients and
an early stop inside a block; histories are exact under
pipeline_device_eval=false and within rtol 1e-5 of the float64 host
metrics under device eval. Data from the numpy seeds in each helper.
"""

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
from lightgbm_tpu.pipeline import AdaptiveBlockScheduler as JScheduler
from lightgbm_tpu.pipeline import PipelineStats as JPipelineStats
from lightgbm_tpu.pipeline import device_eval as jdevice_eval
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.pipeline import (AdaptiveBlockScheduler,
                                         PipelineStats, run_pipelined)
from lightgbm_tpu_torch.pipeline import device_eval
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "verbosity": -1, "min_data_in_leaf": 5,
          "device_type": "cpu", "fused_block_size": 4}


def _data(n=600, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _noisy_valid(n=200, f=5, seed=14):
    rng = np.random.RandomState(seed)
    Xv = rng.randn(n, f).astype(np.float32)
    yv = (Xv[:, 0] + 1.5 * rng.randn(n) > 0).astype(np.float32)
    return Xv, yv


def _multiclass(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(600, 5).astype(np.float32)
    y = ((X[:, 0] > 0).astype(np.float32) + (X[:, 1] > 0.5))
    Xv = rng.randn(200, 5).astype(np.float32)
    yv = ((Xv[:, 0] + rng.randn(200) > 0).astype(np.float32) +
          (Xv[:, 1] > 0.5))
    return (X, y), (Xv, yv)


def _strip(text):
    """Model text without the dispatch-granularity echo lines."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("[pipeline")
            and not ln.startswith("[fused_block_size")]


def _train(params, data, rounds, valid=None, history=None, callbacks=None):
    X, y = data
    ds = lgt.Dataset(X, label=y, params={"max_bin": 31})
    cbs = list(callbacks or [])
    if history is not None:
        cbs.append(lgt.record_evaluation(history))
    return lgt.train(
        params, ds, rounds,
        valid_sets=[ds.create_valid(*valid)] if valid is not None else None,
        callbacks=cbs or None)


def _booster(params, data, valid=None):
    X, y = data
    ds = lgt.Dataset(X, label=y, params={"max_bin": 31})
    bst = lgt.Booster(params, ds)
    if valid is not None:
        bst.add_valid(ds.create_valid(*valid), "v")
    return bst


# ---------------------------------------------------------------------------
# the scheduler and the stats against the JAX package
SCRIPTS = {
    # (base, adaptive, target_ms, max_block, stopping_rounds, remaining,
    #  observations (k, wall_s, compiled))
    "fixed": (10, False, 250.0, 200, 0, 95,
              [(10, 0.2, True), (10, 0.1, False)]),
    "grows": (4, True, 250.0, 200, 0, 300,
              [(4, 1.5, True), (4, 0.08, False), (12, 0.2, False),
               (15, 0.19, False)]),
    "max_block": (4, True, 1000.0, 20, 0, 500,
                  [(4, 0.01, False), (20, 0.05, False)]),
    "stopping": (10, True, 250.0, 200, 5, 60,
                 [(5, 0.01, False), (5, 0.01, False)]),
    "remaining": (8, True, 250.0, 200, 0, 11,
                  [(8, 0.05, False), (3, 0.0, False)]),
    "zero_wall": (3, True, 100.0, 200, 0, 40,
                  [(3, 0.0, False), (3, -1.0, False), (3, 0.03, False)]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scheduler_matches_jax(script):
    base, adaptive, target, max_block, stop, remaining, obs = \
        SCRIPTS[script]
    kw = dict(adaptive=adaptive, target_ms=target, max_block=max_block,
              stopping_rounds=stop)
    ours, theirs = AdaptiveBlockScheduler(base, **kw), JScheduler(base, **kw)
    seq, jseq = [], []
    left = remaining
    for k, wall, compiled in obs + [(None, None, None)] * 3:
        seq.append(ours.next_block(left))
        jseq.append(theirs.next_block(left))
        if k is not None:
            ours.observe(k, wall, compiled)
            theirs.observe(k, wall, compiled)
        left = max(1, left - seq[-1])
        assert ours.rate == theirs.rate
    assert seq == jseq


def test_pipeline_stats_match_jax():
    ours, theirs = PipelineStats(), JPipelineStats()
    assert ours.as_dict() == theirs.as_dict()
    assert ours.overlap_frac == theirs.overlap_frac == 0.0
    for k, host, dev in ((4, 1.23456, 10.0), (8, 30.0, 20.0),
                         (2, 0.0004, 5.5)):
        ours.add(k, host, dev)
        theirs.add(k, host, dev)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.overlap_frac == theirs.overlap_frac


# ---------------------------------------------------------------------------
# device eval against the JAX package's
_BINARY = ("binary_logloss", "binary_error", "cross_entropy",
           "kullback_leibler")
_REGRESSION = ("l2", "rmse", "l1", "quantile", "huber", "fair", "mape")
_LOG_LINK = ("poisson", "gamma", "gamma_deviance", "tweedie")
_MULTICLASS = ("multi_logloss", "multi_error")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", _BINARY + _REGRESSION + _LOG_LINK +
                         _MULTICLASS)
def test_device_metric_equals_jax(name, weighted):
    rng = np.random.RandomState(2)
    n, b = 400, 3
    traj = rng.randn(b, n).astype(np.float32)
    params = {"alpha": 0.7, "fair_c": 1.3, "tweedie_variance_power": 1.4}
    k = 1
    if name in _BINARY:
        label = (rng.rand(n) < 0.4).astype(np.float32)
        if name == "kullback_leibler":
            label = rng.rand(n).astype(np.float32)
        objective = "binary" if name != "cross_entropy" else "cross_entropy"
    elif name in _MULTICLASS:
        k = 3
        label = rng.randint(0, k, n).astype(np.float32)
        traj = rng.randn(b, n, k).astype(np.float32)
        objective = "multiclass"
        params.update(num_class=k, multi_error_top_k=2)
    else:
        label = np.abs(rng.randn(n)).astype(np.float32) + 0.1
        objective = "poisson" if name in _LOG_LINK else "regression"
        if objective == "regression":
            traj = np.abs(traj) + 0.05
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    params["objective"] = objective
    cfg, jcfg = Config(params), JConfig(params)
    m = metrics.create_metric(name, cfg)
    jm = jmetrics.create_metric(name, jcfg)
    m.init(Metadata(n, label=label, weight=weight), n)
    jm.init(JMetadata(n, label=label, weight=weight), n)
    obj, jobj = create_objective(objective, cfg), jcreate_objective(
        objective, jcfg)
    assert device_eval._supported(m, k) and jdevice_eval._supported(jm, k)
    got = device_eval._SetEval([m], obj, k, torch.device("cpu"))(
        torch.as_tensor(traj)).numpy()
    want = np.asarray(jdevice_eval._make_set_fn([jm], jobj, k)(
        jnp.asarray(traj)))
    assert got.shape == want.shape == (b, 1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_support_matrix_matches_jax():
    names = sorted(set(metrics.METRIC_ALIASES.values()))
    assert names == sorted(set(jmetrics.METRIC_ALIASES.values()))
    for name in names:
        for k in (1, 3):
            params = {"num_class": k, "objective":
                      "multiclass" if k > 1 else "binary"}
            m = metrics.create_metric(name, Config(params))
            jm = jmetrics.create_metric(name, JConfig(params))
            assert device_eval._supported(m, k) == \
                jdevice_eval._supported(jm, k), (name, k)


def test_build_device_eval_is_all_or_nothing():
    data, valid = _data(seed=3), _noisy_valid(seed=4)
    ok = _booster(dict(PARAMS, metric="binary_logloss,binary_error"), data,
                  valid)
    dev = device_eval.build_device_eval(ok)
    assert dev is not None and dev.names == [["binary_logloss",
                                              "binary_error"]]
    assert dev.valid_names == ["v"]
    for metric in ("auc", "binary_logloss,auc"):
        bst = _booster(dict(PARAMS, metric=metric), data, valid)
        assert device_eval.build_device_eval(bst) is None
    # the evlist of the device values equals eval_valid's on the same
    # scores (rtol 1e-6: f32 against float64)
    ok.update()
    vs = ok.gbdt.valid_scores[0]
    mx = dev.dispatch([torch.stack([vs, vs])])
    got = dev.evlist_at([a.numpy() for a in mx], 1)
    want = ok.eval_valid()
    assert [g[:2] + g[3:] for g in got] == [w[:2] + w[3:] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the executor
def test_executor_cadence_and_stats():
    bst = _booster(dict(PARAMS), _data(seed=8))
    seen = []
    run_pipelined(bst, start_iter=0, num_boost_round=6, base_block=3,
                  run_callbacks=lambda i, ev: seen.append(i),
                  has_valid=False)
    assert seen == [0, 1, 2, 3, 4, 5]
    st = bst.gbdt._pipeline_stats
    assert st.iterations == 6 and sum(st.block_sizes) == 6
    assert st.blocks == len(st.block_sizes) >= 1
    assert 0.0 <= st.overlap_frac <= 1.0
    ref = _booster(dict(PARAMS), _data(seed=8))
    ref.update_batch(6)
    assert bst.model_to_string() == ref.model_to_string()


def test_executor_other_exit_leaves_a_whole_block():
    # a callback that raises mid-block (not an early stop): the booster
    # holds the whole block's trees and its valid scores are the block's
    # last point, as engine.train's loop leaves them
    data, valid = _data(seed=9), _noisy_valid(seed=19)
    params = dict(PARAMS, metric="binary_logloss",
                  pipeline_adaptive_blocks=False)
    bst = _booster(params, data, valid)

    def cb(i, ev):
        if i == 5:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_pipelined(bst, start_iter=0, num_boost_round=12, base_block=4,
                      run_callbacks=cb, has_valid=True)
    ref = _booster(params, data, valid)
    ref.update_batch(4)
    ref.update_batch(4)
    assert bst.current_iteration() == len(bst.gbdt.trees) == 8
    assert bst.model_to_string() == ref.model_to_string()
    assert torch.equal(bst.gbdt.valid_scores[0], ref.gbdt.valid_scores[0])


def _multiclass_case():
    (X, y), valid = _multiclass(11)
    return ({**PARAMS, "objective": "multiclass", "num_class": 3,
             "metric": "multi_logloss,multi_error"}, (X, y), valid)


CASES = {
    "binary": lambda: (dict(PARAMS, metric="binary_logloss"), _data(),
                       _noisy_valid()),
    "regression": lambda: (dict(PARAMS, objective="regression",
                                metric="l2,l1"), _data(seed=1),
                           _noisy_valid(seed=2)),
    "multiclass": _multiclass_case,
    "bagging": lambda: (dict(PARAMS, bagging_fraction=0.7, bagging_freq=2,
                             metric="binary_logloss"), _data(seed=6),
                        _noisy_valid(seed=16)),
    "goss": lambda: (dict(PARAMS, boosting="goss", top_rate=0.3,
                          other_rate=0.3, metric="binary_logloss"),
                     _data(seed=6), _noisy_valid(seed=16)),
    "quantized": lambda: (dict(PARAMS, use_quantized_grad=True,
                               metric="binary_logloss"), _data(seed=7),
                          _noisy_valid(seed=17)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_parity(case):
    params, data, valid = CASES[case]()
    models = []
    for pipeline in (True, False):
        bst = _train(dict(params, pipeline=pipeline), data, 10, valid=valid)
        st = bst.gbdt._pipeline_stats
        if pipeline:
            assert st is not None and st.iterations == 10, \
                "pipeline did not engage: the test is vacuous"
            assert bst.gbdt.valid_host_copies == 0   # device eval
        else:
            assert st is None
        assert bst.current_iteration() == 10
        models.append(bst.model_to_string())
    assert _strip(models[0]) == _strip(models[1])


def test_host_eval_mode_exactly_matches_serial():
    # pipeline_device_eval=false runs the float64 host metrics of the
    # serial loop: byte parity and the exact history
    data, valid = _data(seed=5), _noisy_valid(seed=17)
    out = []
    for pipeline in (True, False):
        hist = {}
        bst = _train(dict(PARAMS, metric="binary_logloss,auc",
                          pipeline=pipeline, pipeline_device_eval=False),
                     data, 10, valid=valid, history=hist)
        out.append((bst.model_to_string(), hist))
    assert _strip(out[0][0]) == _strip(out[1][0])
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("case", ["binary", "regression", "multiclass"])
def test_device_eval_history_close_to_host(case):
    params, data, valid = CASES[case]()
    hists = []
    for device in (True, False):
        hist = {}
        _train(dict(params, pipeline_device_eval=device), data, 10,
               valid=valid, history=hist)
        hists.append({(vn, mn): vals for vn, d in hist.items()
                      for mn, vals in d.items()})
    dev, host = hists
    assert set(dev) == set(host) and dev
    for key in host:
        assert len(dev[key]) == 10
        np.testing.assert_allclose(dev[key], host[key], rtol=1e-5,
                                   err_msg=str(key))


@pytest.mark.parametrize("device_eval", [True, False],
                         ids=["device-eval", "host-eval"])
def test_early_stop_mid_block_parity(device_eval):
    data, valid = _data(seed=13), _noisy_valid(seed=14)
    results = []
    for pipeline in (True, False):
        results.append(_train(
            dict(PARAMS, metric="binary_logloss", early_stopping_round=2,
                 fused_block_size=5, pipeline=pipeline,
                 pipeline_device_eval=device_eval), data, 25, valid=valid))
    a, b = results
    assert a.best_iteration == b.best_iteration
    assert a.current_iteration() == b.current_iteration()
    assert _strip(a.model_to_string()) == _strip(b.model_to_string())
    assert torch.equal(a.gbdt.valid_scores[0], b.gbdt.valid_scores[0])
    if device_eval:
        for key, scores in b.best_score.items():
            for name, v in scores.items():
                assert a.best_score[key][name] == pytest.approx(v, rel=1e-5)
    else:
        assert dict(a.best_score) == dict(b.best_score)
    # the stop must fall before the budget, or the rollback is untested
    assert a.current_iteration() < 25


class _MxuBooster(lgb.Booster):
    """The JAX package's booster on its MXU growth path in Pallas
    interpret mode (tests/test_torch_valid.py's pin)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.gbdt is not None:
            self.gbdt._hist_impl = "mxu"
            self.gbdt._mxu_interpret = True


def test_best_iteration_equals_jax(monkeypatch):
    # the JAX package's train on the same data, pinned to its MXU grower
    # (one iteration a dispatch: fused_block_size 1, float64 host
    # metrics), stops at the port's pipelined, device-evaluated iteration
    monkeypatch.setattr(jengine, "Booster", _MxuBooster)
    X, y = _data(seed=13)
    Xv, yv = _noisy_valid(seed=14)
    params = {k: v for k, v in PARAMS.items() if k != "device_type"}
    params.update(metric="binary_logloss", early_stopping_round=3)
    jds = lgb.Dataset(X, label=y, params={"max_bin": 31})
    jbst = jengine.train(dict(params, fused_block_size=1), jds, 25,
                         valid_sets=[lgb.Dataset(Xv, label=yv,
                                                 reference=jds)])
    bst = _train(dict(params, device_type="cpu"), (X, y), 25,
                 valid=(Xv, yv))
    assert bst.gbdt._pipeline_stats is not None
    assert bst.best_iteration == jbst.best_iteration < 25
    assert bst.best_score["valid_0"]["binary_logloss"] == pytest.approx(
        jbst.best_score["valid_0"]["binary_logloss"], rel=1e-4)
