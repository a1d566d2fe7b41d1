"""Row sampling (bagging, GOSS), random forest and DART on the CPU,
against the JAX package and against the port's own per-iteration path.

The draws are bit for bit: the bagging mask (bagging_fraction, and
pos_/neg_bagging_fraction by label) at each iteration, including the
iterations between resample boundaries that reuse it, and GOSS's
(grad, hess, cnt) under the booster's key stream, on scores with ties at
the threshold and on NaN, inf and signed-zero scores, equal the JAX
package's _bagging and _goss on the same gradients. Boosters of the four
modes (JAX: its MXU growth path in Pallas interpret mode, as
tests/test_torch_train.py runs it) write the same model at the exact-mode
bars of tests/test_torch_train.py (structure identical, values within
1e-4); RF's averaged predictions and metrics and DART's tree weights and
dropped trees match too. Within the port the bars are exact: bagging and
GOSS through update_batch and train's block dispatch write the model text
of update() byte for byte and its scores bit for bit (exact and quantized
gradients), RF and DART take one iteration a dispatch and give update()'s
model, and no sampling program syncs the host. Data from numpy seeds
stated in each helper; 2,000 rows x 6 features, max_bin 31, 7 leaves.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu import engine as jengine
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.config import Config
from tests.test_torch_sync_free import _within, _watch
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

_BASE = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
         "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1}
_MODES = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
    "posneg": {"bagging_freq": 3, "pos_bagging_fraction": 0.5,
               "neg_bagging_fraction": 0.8},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.2},
}
_ROUNDS = 5


def _data(n=2000, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n) > 0.3) \
        .astype(np.float32)
    return X, y


def _jax_booster(X, y, params):
    bst = lgb.Booster(dict(params, pipeline=False),
                      lgb.Dataset(X, label=y, params=params))
    bst.gbdt._hist_impl = "mxu"          # the TPU growth path ...
    bst.gbdt._mxu_interpret = True       # ... in Pallas interpret mode
    return bst


def _port_booster(X, y, params):
    p = dict(params, device_type="cpu")
    return lgt.Booster(p, lgt.Dataset(X, label=y, params=p))


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


def _strip(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[fused_block_size:"))


# ---------------------------------------------------------------------------
# the draws against lightgbm_tpu's _bagging and _goss
@pytest.mark.parametrize("mode", ["bagging", "posneg"])
def test_bagging_mask_equals_jax(mode):
    """Iterations 0-6: freq 2 resamples at 0, 2, 4, 6 and reuses between;
    freq 3 at 0, 3, 6."""
    X, y = _data()
    params = dict(_BASE, **_MODES[mode])
    jb, tb = _jax_booster(X, y, params).gbdt, \
        _port_booster(X, y, params).gbdt
    rng = np.random.RandomState(8)
    masks = []
    for it in range(7):
        g = rng.randn(len(y)).astype(np.float32)
        h = rng.uniform(0.1, 1.0, len(y)).astype(np.float32)
        jb.iter_ = tb.iter_ = it
        want = jb._bagging(jnp.asarray(g), jnp.asarray(h))
        got = tb._sample(torch.as_tensor(g), torch.as_tensor(h))
        for w, t in zip(want, got):
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
        masks.append(got[2].numpy())
    freq = params["bagging_freq"]
    for it in range(7):
        assert np.array_equal(masks[it], masks[it - it % freq])
    assert not np.array_equal(masks[0], masks[freq])
    if mode == "posneg":
        pos = y > 0
        assert 0.4 < masks[0][pos].mean() < 0.6
        assert 0.7 < masks[0][~pos].mean() < 0.9


def _goss_inputs(kind, n, rng):
    if kind == "ties":
        # five score values: many rows tie at the top_k-th
        g = rng.choice([-2.0, -1.0, 0.5, 1.0, 3.0], n).astype(np.float32)
        return g, np.ones(n, np.float32)
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    if kind == "nonfinite":
        # +NaN and inf rank above every number, -NaN below every number,
        # 0.0 above -0.0 (lax.top_k's total order)
        g[:40] = np.nan
        g[40:60] = np.inf
        g[60:500] = 0.0
        h[100:400] = -1.0             # -0.0 scores and negative ones
        h[400:430] = -np.inf          # -inf scores
        h[430:470] = np.nan           # NaN scores
    elif kind == "nan_threshold":
        g[:700] = np.nan              # more NaN scores than top_k: no row
    elif kind == "signed_zero":       # reaches the NaN threshold
        # 300 positive scores, then 0.0 and -0.0: the top_k-th is -0.0
        g[300:] = 0.0
        h[500:] = -1.0
    return g, h


@pytest.mark.parametrize("kind", ["plain", "ties", "nonfinite",
                                  "nan_threshold", "signed_zero"])
def test_goss_sample_equals_jax(kind):
    """Three iterations of the booster's key stream each: the key, the
    threshold's rows, the amplified rows and the count bit for bit."""
    X, y = _data()
    params = dict(_BASE, **_MODES["goss"])
    jb, tb = _jax_booster(X, y, params).gbdt, \
        _port_booster(X, y, params).gbdt
    rng = np.random.RandomState(12)
    n = len(y)
    for it in range(3):
        g, h = _goss_inputs(kind, n, rng)
        jb.iter_ = tb.iter_ = it
        want = jb._bagging(jnp.asarray(g), jnp.asarray(h))
        got = tb._sample(torch.as_tensor(g), torch.as_tensor(h))
        for w, t in zip(want, got):
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
        np.testing.assert_array_equal(np.asarray(jb._rng_key, np.uint32),
                                      tb._rng_key.numpy().astype(np.uint32))
        cnt = got[2].numpy()
        if kind == "signed_zero":
            assert cnt.all()          # every score is >= -0.0
        elif kind == "nan_threshold":
            # no row is on top: the sampled rest alone (2/7 of the rows)
            assert 0.2 * n < cnt.sum() < 0.4 * n
        else:
            assert 0 < cnt.sum() < n
        if kind == "ties":
            # every row at the threshold's score is kept, however many
            top = np.abs(g) >= np.sort(np.abs(g))[::-1][int(n * 0.3) - 1]
            assert cnt[top].all() and top.sum() > int(n * 0.3)


# ---------------------------------------------------------------------------
# boosters against lightgbm_tpu
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_booster_matches_jax_package(mode):
    X, y = _data()
    params = dict(_BASE, **_MODES[mode])
    jb = _jax_booster(X, y, params)
    tb = _port_booster(X, y, params)
    assert type(tb.gbdt).__name__ == type(jb.gbdt).__name__
    for _ in range(_ROUNDS):
        jb.update()
        tb.update()
    _assert_same_model(jb.model_to_string(), tb.model_to_string())
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.gbdt.train_score.numpy(),
                               np.asarray(jb.gbdt.train_score), rtol=1e-4,
                               atol=1e-4)
    if mode == "rf":
        assert "average_output" in tb.model_to_string()
        assert tb.gbdt._init_score == pytest.approx(
            jb.gbdt._init_scores[0], rel=1e-6)
    if mode == "dart":
        assert tb.gbdt.tree_weights == jb.gbdt.tree_weights
        assert tb.gbdt.num_dropped > 0


@pytest.mark.parametrize("mode", ["rf", "dart"])
def test_train_with_valid_sets_matches_jax(mode, monkeypatch):
    """engine.train with a valid set, metrics and early_stopping_round: the
    recorded metrics (RF: of the averaged scores) within rtol 1e-4 and the
    same trees; DART turns early stopping off, as in the JAX package."""
    X, y = _data()
    Xv, yv = _data(600, seed=6)
    params = dict(_BASE, metric="binary_logloss,auc",
                  early_stopping_round=2, **_MODES[mode])

    class MxuBooster(lgb.Booster):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if self.gbdt is not None:
                self.gbdt._hist_impl = "mxu"
                self.gbdt._mxu_interpret = True
    monkeypatch.setattr(jengine, "Booster", MxuBooster)
    ev_j, ev_t = {}, {}
    jds = lgb.Dataset(X, label=y, params=params)
    jb = jengine.train(dict(params, pipeline=False), jds, _ROUNDS,
                       valid_sets=[jds.create_valid(Xv, label=yv)],
                       callbacks=[lgb.record_evaluation(ev_j)])
    p = dict(params, device_type="cpu")
    tds = lgt.Dataset(X, label=y, params=p)
    tb = lgt.train(p, tds, _ROUNDS,
                   valid_sets=[tds.create_valid(Xv, label=yv)],
                   callbacks=[lgt.record_evaluation(ev_t)])
    assert tb.best_iteration == jb.best_iteration
    assert tb.current_iteration() == jb.current_iteration()
    for metric in ("binary_logloss", "auc"):
        np.testing.assert_allclose(ev_t["valid_0"][metric],
                                   ev_j["valid_0"][metric], rtol=1e-4)
    _assert_same_model(jb.model_to_string(), tb.model_to_string())
    if mode == "dart":
        assert tb.current_iteration() == _ROUNDS
    if mode == "rf":
        # the recorded logloss is that of the averaged score
        avg = tb.gbdt.valid_scores[0].numpy() / tb.current_iteration() + \
            np.float32(tb.gbdt._init_score)
        p1 = 1.0 / (1.0 + np.exp(-avg.astype(np.float64)))
        want = -np.mean(yv * np.log(p1) + (1 - yv) * np.log(1 - p1))
        assert ev_t["valid_0"]["binary_logloss"][-1] == pytest.approx(
            want, rel=1e-5)


def test_rf_predict_drops_the_init_score():
    """ROADMAP C11, asserted as it stands: on labels whose boost-from-
    average score is not 0 (about 40% positive here), RF's metrics see
    score / iterations + the init score, while the model (average_output)
    predicts score / iterations: the reference folds the init score into
    each tree (rf.hpp, AddBias), the JAX package keeps it apart and the
    port ports that. Both part by the same init score."""
    X, y = _data()
    params = dict(_BASE, metric="binary_logloss", **_MODES["rf"])
    jb = _jax_booster(X, y, params)
    tb = _port_booster(X, y, params)
    for _ in range(_ROUNDS):
        jb.update()
        tb.update()
    init = tb.gbdt._init_score
    assert abs(init) > 0.1
    assert init == pytest.approx(jb.gbdt._init_scores[0], rel=1e-6)

    def logloss(raw):
        p1 = 1.0 / (1.0 + np.exp(-raw.astype(np.float64)))
        return -np.mean(y * np.log(p1) + (1 - y) * np.log(1 - p1))
    for bst in (jb, tb):
        pred = bst.predict(X, raw_score=True)
        avg = np.asarray(bst.gbdt.train_score) / _ROUNDS + np.float32(init)
        np.testing.assert_allclose(avg - pred, init, rtol=1e-4, atol=1e-4)
        (_, name, val, _), = bst.eval_train()
        assert name == "binary_logloss"
        assert val == pytest.approx(logloss(avg), rel=1e-5)
        assert abs(val - logloss(pred)) > 1e-3


# ---------------------------------------------------------------------------
# within the port
_FUSED = {"bagging": _MODES["bagging"], "posneg": _MODES["posneg"],
          "goss": _MODES["goss"],
          "bagging_quantized": dict(_MODES["bagging"],
                                    use_quantized_grad=True),
          "goss_quantized": dict(_MODES["goss"], use_quantized_grad=True),
          "bagging_regression": dict(_MODES["bagging"],
                                     objective="regression"),
          "goss_regression": dict(_MODES["goss"], objective="regression")}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_fused_equals_update_loop(name):
    """7 iterations: update_batch(7) (0, then 1-6 through the fused
    trainer) and train's block loop at fused_block_size 3 (pipeline=false:
    0, 1-2 and 3-5 fused, 6 through update(); the pipelined executor's
    blocks are tests/test_torch_pipeline.py's) against 7 update() calls,
    byte for byte."""
    X, y = _data()
    params = dict(_BASE, fused_block_size=3, pipeline=False)
    params.update(_FUSED[name])
    a = _port_booster(X, y, params)
    for _ in range(7):
        a.update()
    b = _port_booster(X, y, params)
    b.update_batch(7)
    p = dict(params, device_type="cpu")
    c = lgt.train(p, lgt.Dataset(X, label=y, params=p), 7)
    for other in (b, c):
        assert other.model_to_string() == a.model_to_string()
        assert torch.equal(other.gbdt.train_score.view(torch.int32),
                           a.gbdt.train_score.view(torch.int32))
    assert b.gbdt.fused_stats[0]["trees"] == 6
    assert [st["trees"] for st in c.gbdt.fused_stats] == [5]
    if "goss" in name:
        # both drew seven keys from the stream
        assert torch.equal(b.gbdt._rng_key, a.gbdt._rng_key)
    # GOSS turns the const-hessian gate off, bagging keeps it
    assert a.gbdt._const_hessian() == (
        0.0 if "goss" in name or params["objective"] == "binary" else 1.0)


def test_update_after_a_fused_block_draws_its_boundary_mask():
    """bagging_freq 3 does not divide the block: update() at iteration 10,
    after update_batch(10), bags by the mask of boundary 9, as an update()
    loop does (the JAX package's update() would reuse the mask it stored
    at iteration 0, ROADMAP C10)."""
    X, y = _data()
    params = dict(_BASE, bagging_fraction=0.7, bagging_freq=3)
    a = _port_booster(X, y, params)
    for _ in range(11):
        a.update()
    b = _port_booster(X, y, params)
    b.update_batch(10)
    b.update()
    assert b.model_to_string() == a.model_to_string()


@pytest.mark.parametrize("mode", ["rf", "dart"])
def test_rf_dart_run_one_iteration_a_dispatch(mode):
    X, y = _data()
    params = dict(_BASE, fused_block_size=3, **_MODES[mode])
    a = _port_booster(X, y, params)
    for _ in range(_ROUNDS):
        a.update()
    b = _port_booster(X, y, params)
    assert not b.gbdt._fused_eligible()
    b.update_batch(_ROUNDS)
    p = dict(params, device_type="cpu")
    c = lgt.train(p, lgt.Dataset(X, label=y, params=p), _ROUNDS)
    for other in (b, c):
        assert other.model_to_string() == a.model_to_string()
        assert other.gbdt.fused_stats == []


@pytest.mark.parametrize("mode", ["bagging", "goss"])
def test_sampling_programs_do_not_sync(mode, monkeypatch):
    """The fused trainer's programs with a sampler (bagging's mask from
    the device iteration, GOSS's top-k threshold and key row): no op that
    syncs the host or copies host data; outside them the fix-up loop's
    reads of `done` alone."""
    from lightgbm_tpu_torch.boosting import fused
    X, y = _data()
    params = dict(_BASE, **_MODES[mode])
    bst = _port_booster(X, y, params)
    bst.update()
    mode_ = _watch(monkeypatch)
    monkeypatch.setattr(fused.FusedTrainer, "_run", _within(
        mode_, "program", fused.FusedTrainer._run))
    with mode_:
        bst.update_batch(4)
    stats = bst.gbdt._fused_run.stats
    assert stats["trees"] == 4
    inside = {k: v for k, v in mode_.counts.items() if k[0] != "outside"}
    assert inside == {}, inside
    assert mode_.counts[("outside", "_local_scalar_dense")] == \
        sum(stats["fixup_reads"])


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_check_supported_admits_the_modes(mode):
    cfg = Config(dict(_BASE, **_MODES[mode]))
    tgbdt.check_supported(cfg)
    assert tgbdt._unsupported(cfg) == []
