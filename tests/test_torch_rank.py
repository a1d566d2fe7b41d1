"""Ranking on the CPU: query groups, the lambdarank and XE-NDCG objectives
and the ranking metrics, against the JAX package and against the port's
own per-iteration path.

pad_queries gives the JAX package's padded layout; the objectives'
gradients and hessians agree with lightgbm_tpu.objectives_rank within
1e-5 (relative, 1e-7 absolute) on random scores, on scores with ties and
on signed zeros (documents ranked as jnp.argsort ranks them: -0.0 ties
0.0, NaN last, stably), with lambdarank_norm on and off, a truncation level and a
label_gain of the caller's, weights, and queries of uneven length split
into several batches; XE-NDCG's draws at iterations 0 and 3. ndcg@k,
map@k and auc_mu agree with lightgbm_tpu.metrics within 1e-12. A
3-iteration lambdarank booster (JAX: its MXU growth path in Pallas
interpret mode, as tests/test_torch_train.py runs it) writes the same
model at that file's exact-mode bars; XE-NDCG's the same structure with
values within 1e-3 (its gradients sum to about zero in a query, so a leaf's
gradient sum cancels and the JAX package's double-bf16 histogram sums
part from the port's float64 ones by up to ~1.2e-4 relative). Within the
port, train's block dispatch gives update()'s model byte for byte, and
engine.train evaluates ndcg@k and map@k on valid sets with groups. Data:
numpy seeds stated in each helper; at most 100 queries of at most 20
documents, 5 features, 7 leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import objectives_rank as jrank
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Metadata as JMetadata
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metrics, objectives_rank
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Metadata
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_train import _assert_same_model, _trees

_BASE = {"objective": "lambdarank", "num_leaves": 7, "learning_rate": 0.2,
         "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1}


def _data(num_queries=75, docs=20, seed=12):
    rng = np.random.RandomState(seed)
    n = num_queries * docs
    X = rng.randn(n, 5).astype(np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97])) \
        .astype(np.float32)
    return X, y, np.full(num_queries, docs)


def test_pad_queries_equals_jax():
    for group in ([3, 1, 4, 1, 5], [20] * 4, [1], [2, 0, 3]):
        qb = np.concatenate([[0], np.cumsum(group)])
        for got, want in zip(objectives_rank.pad_queries(qb),
                             jrank.pad_queries(qb)):
            np.testing.assert_array_equal(got, want)
        got = objectives_rank.pad_queries(qb, max_len=25)
        want = jrank.pad_queries(qb, max_len=25)
        np.testing.assert_array_equal(got[0], want[0])


def test_groups_on_datasets():
    md = Metadata(6, label=np.zeros(6, np.float32), group=[2, 4])
    np.testing.assert_array_equal(md.query_boundaries, [0, 2, 6])
    # boundaries are taken as boundaries
    md = Metadata(6, group=np.array([0, 2, 6]))
    np.testing.assert_array_equal(md.query_boundaries, [0, 2, 6])
    with pytest.raises(lgt.LightGBMError, match="Sum of query counts"):
        Metadata(6, group=[2, 3])
    X, y, group = _data(10, 5)
    ds = lgt.Dataset(X, label=y, group=group)
    assert ds.get_group() is group
    ds.construct()
    ds.set_group([25, 25])
    np.testing.assert_array_equal(
        ds.binned.metadata.query_boundaries, [0, 25, 50])
    valid = ds.create_valid(X[:10], label=y[:10], group=[4, 6])
    np.testing.assert_array_equal(
        valid.binned.metadata.query_boundaries, [0, 4, 10])


def _objectives(name, params, label, group, weight=None):
    n = len(label)
    cfg = dict(params, objective=name)
    obj = objectives_rank.LambdarankNDCG(Config(cfg)) \
        if name == "lambdarank" else objectives_rank.RankXENDCG(Config(cfg))
    obj.init(Metadata(n, label=label, weight=weight, group=group), n,
             torch.device("cpu"))
    jobj = jrank.LambdarankNDCG(JConfig(cfg)) if name == "lambdarank" \
        else jrank.RankXENDCG(JConfig(cfg))
    jobj.init(JMetadata(n, label=label, weight=weight, group=group), n)
    return obj, jobj


_SCORES = {
    "random": lambda rng, n: rng.randn(n),
    # few distinct values: ties inside every query
    "ties": lambda rng, n: rng.randint(0, 3, n) * 0.5,
    # signed zeros and ties at zero
    "signed_zero": lambda rng, n: np.where(rng.rand(n) < 0.5, 0.0, -0.0) *
    (rng.rand(n) < 0.7) + (rng.rand(n) >= 0.7) * rng.randn(n),
}
_OPTIONS = {
    "default": {},
    "no_norm": {"lambdarank_norm": False},
    "truncated": {"lambdarank_truncation_level": 3,
                  "label_gain": [0, 1, 3, 7, 15, 40]},
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("option", sorted(_OPTIONS))
@pytest.mark.parametrize("scores", sorted(_SCORES))
def test_lambdarank_gradients_equal_jax(scores, option, weighted):
    rng = np.random.RandomState(3)
    group = rng.randint(1, 21, 30)
    n = int(group.sum())
    label = rng.randint(0, 5, n).astype(np.float32)
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    obj, jobj = _objectives("lambdarank", _OPTIONS[option], label, group,
                            weight)
    score = _SCORES[scores](rng, n).astype(np.float32)
    g, h = obj.get_gradients(torch.as_tensor(score))
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-7)
    if scores == "signed_zero":
        assert (g.numpy() != 0).any()


def test_lambdarank_batches_and_signed_zero_order(monkeypatch):
    """Queries split into several batches (a small pair budget) give the
    one batch's gradients; documents rank as jnp.argsort ranks them: -0.0
    and 0.0 tie (and keep their order), NaN goes last."""
    rng = np.random.RandomState(4)
    group = rng.randint(2, 12, 40)
    n = int(group.sum())
    label = rng.randint(0, 4, n).astype(np.float32)
    score = torch.as_tensor(rng.randn(n).astype(np.float32))
    obj, _ = _objectives("lambdarank", {}, label, group)
    want = obj.get_gradients(score)
    monkeypatch.setattr(objectives_rank, "_PAIR_BUDGET", 7 * 11 * 11)
    small, _ = _objectives("lambdarank", {}, label, group)
    assert small.num_batches > 1
    for a, b in zip(small.get_gradients(score), want):
        assert torch.equal(a, b)
    for row in ([0.0, -0.0, 1.0, -0.0, 0.0, np.nan],
                [np.nan, -np.nan, -np.inf, np.inf, -0.0, 0.0, 2.0]):
        sc = np.asarray(row, np.float32)
        order = objectives_rank._descending_order(torch.as_tensor(sc[None]))
        jorder = np.asarray(jnp.argsort(-jnp.asarray(sc), stable=True))
        np.testing.assert_array_equal(order[0].numpy(), jorder)


@pytest.mark.parametrize("scores", sorted(_SCORES))
def test_xendcg_gradients_equal_jax(scores):
    rng = np.random.RandomState(5)
    group = rng.randint(1, 21, 30)
    n = int(group.sum())
    label = rng.randint(0, 5, n).astype(np.float32)
    obj, jobj = _objectives("rank_xendcg", {"seed": 3}, label, group)
    assert obj.draws_per_iteration
    score = _SCORES[scores](rng, n).astype(np.float32)
    for it in range(4):
        # the JAX objective draws under its count of calls
        jg, jh = jobj.get_gradients(jnp.asarray(score))
        if it not in (0, 3):
            continue
        g, h = obj.get_gradients(torch.as_tensor(score), it)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["ndcg", "map", "auc_mu"])
def test_metrics_equal_jax(name):
    rng = np.random.RandomState(6)
    group = rng.randint(1, 15, 40)
    n = int(group.sum())
    params = {"eval_at": [1, 2, 5], "label_gain": [0, 1, 3, 7, 15]}
    if name == "auc_mu":
        label = rng.randint(0, 4, n).astype(np.float32)
        score = rng.randint(0, 3, (n, 4)).astype(np.float32)  # ties
    else:
        label = rng.randint(0, 5, n).astype(np.float32)
        score = (rng.randint(0, 4, n) * 0.5).astype(np.float32)
    m = metrics.create_metric(name, Config(params))
    jm = jmetrics.create_metric(name, JConfig(params))
    m.init(Metadata(n, label=label, group=group), n)
    jm.init(JMetadata(n, label=label, group=group), n)
    assert m.evaluate(score) == pytest.approx(jm.evaluate(score), rel=1e-12)
    if name != "auc_mu":
        assert m.evaluate_multi(score) == pytest.approx(
            jm.evaluate_multi(score), rel=1e-12)
    assert m.is_higher_better


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_three_tree_model_matches_jax(name):
    X, y, group = _data()
    params = dict(_BASE, objective=name)
    jb = lgb.Booster(dict(params, pipeline=False),
                     lgb.Dataset(X, label=y, group=group, params=params))
    jb.gbdt._hist_impl = "mxu"           # the TPU growth path ...
    jb.gbdt._mxu_interpret = True        # ... in Pallas interpret mode
    p = dict(params, device_type="cpu")
    tb = lgt.Booster(p, lgt.Dataset(X, label=y, group=group, params=p))
    for _ in range(3):
        jb.update()
        tb.update()
    if name == "lambdarank":
        _assert_same_model(jb.model_to_string(), tb.model_to_string())
    else:
        jt, tt = _trees(jb.model_to_string()), _trees(tb.model_to_string())
        assert len(jt) == len(tt) == 3
        for a, b in zip(jt, tt):
            for key in ("num_leaves", "split_feature", "threshold",
                        "decision_type", "left_child", "right_child",
                        "leaf_count"):
                assert a[key] == b[key], key
            for key in ("leaf_value", "split_gain"):
                va = np.asarray(a[key].split(), np.float64)
                np.testing.assert_allclose(
                    np.asarray(b[key].split(), np.float64), va, rtol=1e-3,
                    atol=1e-3 * np.abs(va).max())
    np.testing.assert_allclose(tb.gbdt.train_score.numpy(),
                               tb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_train_equals_update_loop_with_valid_groups(name):
    X, y, group = _data()
    Xv, yv, gv = _data(20, seed=13)
    p = dict(_BASE, objective=name, device_type="cpu", fused_block_size=3,
             metric="ndcg,map", eval_at=[3, 10])
    a = lgt.Booster(p, lgt.Dataset(X, label=y, group=group, params=p))
    for _ in range(5):
        a.update()
    ev = {}
    ds = lgt.Dataset(X, label=y, group=group, params=p)
    b = lgt.train(p, ds, 5, valid_sets=[ds.create_valid(Xv, label=yv,
                                                        group=gv)],
                  callbacks=[lgt.record_evaluation(ev)])
    assert b.gbdt.fused_stats and b.gbdt.fused_stats[0]["trees"] == 4
    strip = [ln for ln in b.model_to_string().splitlines()
             if not ln.startswith("[fused_block_size:")]
    assert strip == [ln for ln in a.model_to_string().splitlines()
                     if not ln.startswith("[fused_block_size:")]
    assert sorted(ev["valid_0"]) == ["map@10", "map@3", "ndcg@10", "ndcg@3"]
    assert all(len(v) == 5 for v in ev["valid_0"].values())
    assert ev["valid_0"]["ndcg@10"][-1] > ev["valid_0"]["ndcg@10"][0] - 0.05
    # a ranking objective without groups refuses
    with pytest.raises(lgt.LightGBMError, match="query information"):
        lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
