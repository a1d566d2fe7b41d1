"""K iterations per dispatch (boosting/fused.py, Booster.update_batch,
engine.train's block dispatch) against the per-iteration path, on the CPU.

The fused trainer runs the growth programs eagerly on the CPU, in the
order its CUDA graphs replay them on the card. Booster.update_batch(k) and
train(..., fused_block_size=5) must write the model text, byte for byte,
and the train scores, bit for bit, of k Booster.update() calls with the
same params, in every configuration the port trains: exact and quantized
gradients, the pallas backend, 4-bit packed bins, the split options,
categorical and NaN splits, L2 regression, trees that need fix-up passes
and a run that stalls after its first tree. One case holds the port's
fused block to the JAX package's update_batch on its fused mxu scan (in
Pallas interpret mode), to the bars of the exact-mode parity tests
(tests/test_torch_train.py: structure identical, values within 1e-4).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

_BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "max_bin": 63, "verbosity": -1, "device_type": "cpu",
         "fused_block_size": 5}
_CONFIGS = {
    "exact": {},
    "quantized": {"use_quantized_grad": True},
    "pallas": {"hist_backend": "pallas"},
    "packed": {"max_bin": 15},
    "packed_quantized": {"max_bin": 15, "use_quantized_grad": True},
    "options": {"monotone_constraints": [1, -1, 0, 0, 0, 0],
                "interaction_constraints": [[0, 1, 2], [3, 4, 5]],
                "feature_fraction": 0.8, "feature_fraction_bynode": 0.8},
    "extra_trees": {"extra_trees": True},
    "categorical_nan": {"categorical_feature": "2"},
    "regression": {"objective": "regression"},
    # leaves of >= 150 rows: every tree runs fix-up passes
    "fixups": {"num_leaves": 7, "min_data_in_leaf": 150},
    "stalled": {"objective": "regression", "num_leaves": 7,
                "learning_rate": 1.0, "min_gain_to_split": 1e-3},
}
_ROUNDS = 7


def _data(name):
    rng = np.random.RandomState(3)
    n = 2000
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 2] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.1, 1] = np.nan
    if name == "stalled":
        # a step the first tree fits exactly: every later tree stalls
        return X, (X[:, 0] > 0).astype(np.float32) * 2.0
    if name == "regression":
        return X, (2 * X[:, 0] + np.nan_to_num(X[:, 1]) +
                   rng.randn(n)).astype(np.float32)
    logit = X[:, 0] + np.nan_to_num(X[:, 1]) + np.isin(X[:, 2], [1, 5, 7])
    return X, (logit + 0.3 * rng.randn(n) > 0.5).astype(np.float32)


def _per_iteration(name):
    X, y = _data(name)
    p = dict(_BASE, **_CONFIGS[name])
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    stops = [bst.update() for _ in range(_ROUNDS)]
    return bst, stops, X, y, p


def _assert_same(a, b):
    assert a.current_iteration() == b.current_iteration() == _ROUNDS
    assert torch.equal(a.gbdt.train_score.view(torch.int32),
                       b.gbdt.train_score.view(torch.int32))
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_update_batch_equals_update_loop(name):
    a, stops, X, y, p = _per_iteration(name)
    b = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    stop = b.update_batch(_ROUNDS)
    _assert_same(a, b)
    stats = b.gbdt._fused_run.stats
    assert stats["trees"] == _ROUNDS - 1 and stats["graphs"] == 0
    assert stats["fixup_reads"] == [n + 1 for n in stats["fixup_passes"]]
    if name == "fixups":
        assert sum(stats["fixup_passes"]) > 0
    if name == "stalled":
        assert stops == [False] + [True] * (_ROUNDS - 1)
        assert [int(t.num_leaves) for t in b.gbdt.trees] == \
            [2] + [1] * (_ROUNDS - 1)
    # the stall poll is lagged: the first block has nothing to read yet
    assert stop is False


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_train_block_dispatch_equals_update_loop(name):
    a, _, X, y, p = _per_iteration(name)
    b = lgt.train(p, lgt.Dataset(X, label=y, params=p), _ROUNDS)
    _assert_same(a, b)
    # blocks of 5 and 2: iteration 0 on the per-iteration path, then the
    # fused trainer, which train frees when it is done
    assert [st["trees"] for st in b.gbdt.fused_stats] == [_ROUNDS - 1]
    assert b.gbdt._fused_run is None


def test_trainer_is_freed_without_a_collection():
    """The trainer holds no reference to its booster: dropping the booster
    frees it (and on the card its graphs) at once, and a booster whose
    trainer was released trains on with a new one, the same trees."""
    a, _, X, y, p = _per_iteration("exact")
    b = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    collecting = gc.isenabled()
    gc.disable()
    try:
        b.update_batch(3)
        first = weakref.ref(b.gbdt._fused_run)
        b.gbdt.release_fused()
        assert first() is None
        b.update_batch(_ROUNDS - 3)
        _assert_same(a, b)
        assert [st["trees"] for st in b.gbdt.fused_stats] == \
            [2, _ROUNDS - 3]
        second = weakref.ref(b.gbdt._fused_run)
        del b
        assert second() is None
    finally:
        if collecting:
            gc.enable()


def test_dispatch_and_finalize_split_the_block():
    a, _, X, y, p = _per_iteration("exact")
    b = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    handle = b.update_batch_dispatch(_ROUNDS)
    assert b.current_iteration() == _ROUNDS and len(b.gbdt.trees) == 1
    assert b.finalize_block(handle) is False
    _assert_same(a, b)


def test_stall_poll_reads_an_earlier_block():
    X, y = _data("stalled")
    p = dict(_BASE, **_CONFIGS["stalled"])
    b = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    # iterations 0-4, then 5-9: the second block crosses the poll at 8 and
    # reads the first block's stalled last tree
    assert b.update_batch(5) is False
    assert b.update_batch(5) is True


def test_fused_block_matches_jax_package():
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 6).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
              "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1}
    bst = lgb.Booster(dict(params),
                      lgb.Dataset(X, label=y, params={"max_bin": 31}))
    g = bst.gbdt
    g._hist_impl = "mxu"          # the fused-eligible TPU path ...
    g._mxu_interpret = True       # ... in Pallas interpret mode
    g._fused_run = None
    assert g._fused_eligible()
    bst.update_batch(3)
    assert g._fused_run is not None

    p = dict(params, device_type="cpu")
    port = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    port.update_batch(3)
    assert port.gbdt._fused_run.stats["trees"] == 2
    _assert_same_model(bst.model_to_string(), port.model_to_string())
    np.testing.assert_allclose(port.gbdt.train_score.numpy(),
                               np.asarray(g.train_score), rtol=1e-4,
                               atol=1e-4)
