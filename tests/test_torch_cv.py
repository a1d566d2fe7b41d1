"""engine.cv of the port against the JAX package's, on the CPU.

Both packages cross-validate the same data with the same parameters at
growth_overshoot 0, where the port's MXU grower grows the JAX booster's
portable-grower trees: the result keys and lengths are equal and every
aggregated value is within rtol 1e-4 / atol 1e-6 (the two packages'
histogram sums and f32 exp part in the last bits; the metrics are float64
over those scores), auc within atol 5e-3 (two leaves' equal values, as
a pure leaf's -G/H does not depend on its count, can tie in one package
and not the other: each such pair moves a fold's auc by 1/2,500). The data have no split
whose gain ties another's to f32 rounding (ROADMAP C3: such ties fall
either way in the two packages). Covered: stratified and unstratified
folds, folds as an iterator and as a scikit-learn splitter,
eval_train_metric, early
stopping (the same best iteration), init_model, return_cvbooster and
fpreproc. N = 300 with nfold 3, so every fold trains on 200 rows and one
JAX compile serves them all.

ROADMAP C23: on grouped data the JAX package's cv splits rows and its
subsets drop the query boundaries, so a ranking metric raises; the port
splits query indices (a RandomState(seed) permutation, nfold contiguous
blocks) and each fold's model is byte-equal to a Booster trained on that
fold's subset with update(). ROADMAP C25: the stratified split ignores
shuffle and seed, in both packages.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.utils.log import LightGBMError as JLightGBMError
import lightgbm_tpu_torch as lgt
from tests.test_torch_one_thread import one_thread  # noqa: F401

# min_gain_to_split 1e-3: a pure node's f32 split gain is a few ulps of
# either sign (ROADMAP C3), and at growth_overshoot 0 a positive one can
# take the MXU grower's last leaf where the JAX package's is not positive
PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1,
          "growth_overshoot": 0.0, "min_gain_to_split": 1e-3,
          "metric": "binary_logloss,auc"}
ROUNDS = 5
N = 300


def _data(n=N, f=5, seed=12, noise=0.5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] + noise * rng.randn(n) > 0) \
        .astype(np.float64)
    return X, y


def _both(params=PARAMS, rounds=ROUNDS, data=None, **kw):
    X, y = data if data is not None else _data()
    rj = lgb.cv(dict(params), lgb.Dataset(X, label=y, free_raw_data=False),
                rounds, **kw)
    rt = lgt.cv(dict(params, device_type="cpu"),
                lgt.Dataset(X, label=y, free_raw_data=False), rounds, **kw)
    return rj, rt


def _close(rj, rt):
    assert sorted(k for k in rj if k != "cvbooster") == \
        sorted(k for k in rt if k != "cvbooster")
    for k in rj:
        if k == "cvbooster":
            continue
        assert len(rt[k]) == len(rj[k]), k
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4,
                                   atol=5e-3 if " auc-" in k else 1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (False, False)])
def test_cv_matches_jax(stratified, shuffle):
    rj, rt = _both(nfold=3, stratified=stratified, shuffle=shuffle, seed=3)
    _close(rj, rt)
    assert list(rt) == ["valid binary_logloss-mean",
                        "valid binary_logloss-stdv", "valid auc-mean",
                        "valid auc-stdv"]
    assert len(rt["valid auc-mean"]) == ROUNDS


def test_stratified_folds_ignore_shuffle_and_seed():
    """ROADMAP C25: a round-robin over the stable label order."""
    a = lgt.cv(dict(PARAMS, device_type="cpu"), lgt.Dataset(*_data()[:1],
               label=_data()[1]), 2, nfold=3, seed=1, shuffle=True)
    b = lgt.cv(dict(PARAMS, device_type="cpu"), lgt.Dataset(*_data()[:1],
               label=_data()[1]), 2, nfold=3, seed=7, shuffle=False)
    assert a == b


def test_folds_iterator_and_splitter_match_jax():
    from sklearn.model_selection import KFold
    X, y = _data()
    order = np.random.RandomState(2).permutation(N)
    folds = [(np.setdiff1d(np.arange(N), order[k::3]), order[k::3])
             for k in range(3)]
    rj = lgb.cv(dict(PARAMS), lgb.Dataset(X, label=y), ROUNDS,
                folds=iter(folds))
    rt = lgt.cv(dict(PARAMS, device_type="cpu"), lgt.Dataset(X, label=y),
                ROUNDS, folds=iter(folds))
    _close(rj, rt)
    rj, rt = _both(folds=KFold(3, shuffle=True, random_state=0))
    _close(rj, rt)
    with pytest.raises(AttributeError, match="folds should be"):
        lgt.cv(dict(PARAMS, device_type="cpu"), lgt.Dataset(X, label=y), 1,
               folds=3)


def test_eval_train_metric_and_cvbooster_match_jax():
    rj, rt = _both(nfold=3, eval_train_metric=True, return_cvbooster=True)
    _close(rj, rt)
    assert "training auc-mean" in rt
    cvb = rt["cvbooster"]
    assert isinstance(cvb, lgt.CVBooster) and len(cvb.boosters) == 3
    X, _ = _data(n=50, seed=13)
    preds_t = cvb.predict(X)
    preds_j = rj["cvbooster"].predict(X)
    assert len(preds_t) == 3
    for a, b in zip(preds_t, preds_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert cvb.num_trees() == [ROUNDS] * 3


def test_early_stopping_matches_jax():
    params = dict(PARAMS, early_stopping_round=2, learning_rate=0.8,
                  metric="binary_logloss")
    data = _data(seed=16)
    rj, rt = _both(params, rounds=30, data=data, nfold=3,
                   return_cvbooster=True)
    _close(rj, rt)
    best = rt["cvbooster"].best_iteration
    assert 0 < best < 30
    assert best == rj["cvbooster"].best_iteration
    assert len(rt["valid binary_logloss-mean"]) == best
    assert all(b.best_iteration == best for b in rt["cvbooster"].boosters)


def test_init_model_and_fpreproc_match_jax():
    X, y = _data()
    params = {k: v for k, v in PARAMS.items() if k != "metric"}
    base_j = lgb.train(params, lgb.Dataset(X, label=y), 2)
    base_t = lgt.train(dict(params, device_type="cpu"),
                       lgt.Dataset(X, label=y), 2)
    seen = []

    def fpreproc(dtrain, dvalid, prm):
        seen.append((dtrain.num_data(), dvalid.num_data()))
        return dtrain, dvalid, dict(prm, learning_rate=0.1)

    rj = lgb.cv(dict(PARAMS), lgb.Dataset(X, label=y, free_raw_data=False),
                ROUNDS, nfold=3, init_model=base_j, fpreproc=fpreproc)
    rt = lgt.cv(dict(PARAMS, device_type="cpu"),
                lgt.Dataset(X, label=y, free_raw_data=False), ROUNDS,
                nfold=3, init_model=base_t, fpreproc=fpreproc)
    _close(rj, rt)
    assert seen == [(200, 100)] * 6
    # the base model's scores seed every fold: its first logloss is
    # below a fresh run's
    fresh = lgt.cv(dict(PARAMS, device_type="cpu", learning_rate=0.1),
                   lgt.Dataset(X, label=y), ROUNDS, nfold=3)
    assert rt["valid binary_logloss-mean"][0] < \
        fresh["valid binary_logloss-mean"][0]
    with pytest.raises(ValueError, match="raw data"):
        lgt.cv(dict(PARAMS, device_type="cpu"),
               lgt.Dataset(X, label=y).construct(), 1, init_model=base_t)


RANK = {"objective": "lambdarank", "num_leaves": 5, "max_bin": 15,
        "min_data_in_leaf": 3, "verbosity": -1, "metric": "ndcg",
        "eval_at": [3]}


def _rank_data(nq=12, q=20, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(nq * q, 4)
    y = np.clip(np.round(X[:, 0] + 0.5 * rng.randn(nq * q) + 1), 0, 3)
    return X, y, [q] * nq


def test_grouped_cv_keeps_whole_queries():
    """ROADMAP C23."""
    X, y, group = _rank_data()
    with pytest.raises(JLightGBMError, match="query information"):
        lgb.cv(dict(RANK), lgb.Dataset(X, label=y, group=group), 2, nfold=3)
    ds = lgt.Dataset(X, label=y, group=group)
    rounds = 3
    res = lgt.cv(dict(RANK, device_type="cpu"), ds, rounds, nfold=3,
                 seed=4, return_cvbooster=True)
    assert len(res["valid ndcg@3-mean"]) == rounds
    # the folds: nfold blocks of a RandomState(seed) permutation of the
    # 12 queries, each query's 20 rows whole
    perm = np.random.RandomState(4).permutation(12)
    for k, cvb in enumerate(res["cvbooster"].boosters):
        test_q = np.sort(perm[k * 4:(k + 1) * 4])
        train_q = np.setdiff1d(np.arange(12), test_q)
        tr = np.concatenate([np.arange(20 * q, 20 * q + 20) for q in train_q])
        te = np.concatenate([np.arange(20 * q, 20 * q + 20) for q in test_q])
        np.testing.assert_array_equal(
            cvb.train_set.binned.metadata.query_boundaries,
            np.arange(0, 161, 20))
        b = lgt.Booster(dict(RANK, device_type="cpu"), ds.subset(tr))
        b.add_valid(ds.subset(te), "valid")
        for _ in range(rounds):
            b.update()
        assert b.model_to_string() == cvb.model_to_string()
    # a splitter sees each row's query id as its group
    from sklearn.model_selection import GroupKFold
    res2 = lgt.cv(dict(RANK, device_type="cpu"), ds, 2, folds=GroupKFold(3))
    assert len(res2["valid ndcg@3-mean"]) == 2
