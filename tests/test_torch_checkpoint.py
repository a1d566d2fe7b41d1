"""Single-host checkpoint and resume (lightgbm_tpu_torch/reliability/
checkpoint.py, callback.checkpoint, train(resume_from=)) on the CPU.

The bar is the JAX package's: a killed run resumed from a bundle writes
model text byte-identical to an uninterrupted run's. The kill is
simulated by training run A to its checkpoint and throwing its state
away: run B starts from a fresh Dataset and Booster and learns only
through `resume_from`. Cases: plain, bagging (the bundle lands mid
bagging period), GOSS (its key stream), quantized gradients, multiclass,
a valid set with early stopping, and resuming into the pipelined
executor. Bundle mechanics: the layout, `keep_last`, LATEST, the tmp
sweep, the pin, a failed save (a warning; training goes on), the
refusals, among them valid sets other than the bundle's. Layout parity: the JAX package's latest_checkpoint and
load_checkpoint read the port's bundles (no training across packages).
Data from the numpy seeds in each helper.
"""

import json
import os

import numpy as np
import pytest

from lightgbm_tpu.reliability.checkpoint import \
    latest_checkpoint as jlatest_checkpoint
from lightgbm_tpu.reliability.checkpoint import \
    load_checkpoint as jload_checkpoint
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import callback as cb
from lightgbm_tpu_torch.reliability import counters
from lightgbm_tpu_torch.reliability.checkpoint import (
    FORMAT_VERSION, PIN_FILE, latest_checkpoint, load_checkpoint,
    save_checkpoint)
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 63, "verbosity": -1, "min_data_in_leaf": 5, "seed": 3,
          "device_type": "cpu", "fused_block_size": 3}


def _data(seed=1, n=500, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n) > 0) \
        .astype(np.float32)
    return X, y


def _ds(X, y):
    return lgt.Dataset(X.copy(), label=y.copy(), params={"max_bin": 63})


@pytest.fixture(autouse=True)
def _reset_counters():
    counters.reset()
    yield
    counters.reset()


def _strip(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith("[pipeline")
            and not ln.startswith("[fused_block_size")]


# ---------------------------------------------------------------------------
# kill and resume: byte identity
RESUME_CASES = {
    "plain": ({}, 4, 8),
    # the bundle at iteration 4 lands mid bagging period (freq 3)
    "bagging_mid_period": ({"bagging_fraction": 0.8, "bagging_freq": 3,
                            "bagging_seed": 7}, 4, 9),
    # GOSS draws from a key stream that the bundle carries
    "goss": ({"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
             3, 8),
    "quantized": ({"use_quantized_grad": True}, 4, 8),
    "feature_fraction": ({"feature_fraction": 0.7,
                          "feature_fraction_seed": 5}, 4, 10),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 3, 7),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_matches_uninterrupted(case, tmp_path):
    extra, k, total = RESUME_CASES[case]
    X, y = _data()
    if extra.get("objective") == "multiclass":
        y = (np.abs(X[:, 0]) * 3 % 3).astype(np.int32).astype(np.float32)
    params = dict(PARAMS, **extra)
    ref = lgt.train(dict(params), _ds(X, y), num_boost_round=total)
    # run A: train to k, checkpoint, "die" (one iteration a dispatch)
    d = str(tmp_path / "ckpts")
    a = lgt.train(dict(params), _ds(X, y), num_boost_round=k,
                  callbacks=[cb.checkpoint(k, d)])
    assert a.gbdt._pipeline_stats is None
    found = latest_checkpoint(d)
    assert found is not None and found.endswith(f"ckpt_{k:07d}")
    assert counters.get("checkpoint_saves") == 1
    # run B: a fresh Dataset and Booster, resumed
    resumed = lgt.train(dict(params), _ds(X, y), num_boost_round=total,
                        resume_from=found)
    assert resumed.current_iteration() == total
    assert resumed.num_trees() == ref.num_trees()
    assert resumed.model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(resumed.predict(X), ref.predict(X))


def test_resume_with_valid_set_and_early_stopping(tmp_path):
    # the best iteration lies after the bundle, so the resumed run's
    # early stopping (whose tracker starts at the bundle's iteration)
    # stops where the uninterrupted run does
    X, y = _data(seed=4)
    Xv, yv = _data(seed=5, n=300)
    # 30% of the held-out labels flipped: the best iteration is 11
    yv = np.where(np.random.RandomState(5).rand(300) < 0.3, 1 - yv, yv)
    p = dict(PARAMS, metric="binary_logloss", learning_rate=0.05,
             early_stopping_round=3)

    def run(rounds, params=p, **kw):
        ds = _ds(X, y)
        hist = {}
        bst = lgt.train(dict(params), ds, rounds,
                        valid_sets=[ds.create_valid(Xv, label=yv)],
                        valid_names=["v"],
                        callbacks=[lgt.record_evaluation(hist)] +
                        kw.pop("callbacks", []), **kw)
        return bst, hist

    ref, ref_hist = run(60)
    assert 6 < ref.best_iteration < ref.current_iteration() < 60
    d = str(tmp_path / "c")
    # run A dies at 5 (its last round would end an early-stopping run
    # before the checkpoint callback, order 40, saves)
    run(5, params={k: v for k, v in p.items()
                   if k != "early_stopping_round"},
        callbacks=[cb.checkpoint(5, d)])
    state = json.load(open(os.path.join(d, "ckpt_0000005", "state.json")))
    assert len(state["eval_history"]["v"]["binary_logloss"]) == 5
    resumed, hist = run(60, resume_from=d)
    assert resumed.best_iteration == ref.best_iteration
    assert resumed.current_iteration() == ref.current_iteration()
    assert resumed.model_to_string() == ref.model_to_string()
    assert resumed.best_score["v"]["binary_logloss"] == pytest.approx(
        ref.best_score["v"]["binary_logloss"], rel=1e-5)
    n = len(hist["v"]["binary_logloss"])
    np.testing.assert_allclose(hist["v"]["binary_logloss"],
                               ref_hist["v"]["binary_logloss"][-n:],
                               rtol=1e-5)


def test_checkpoint_resume_into_pipeline(tmp_path):
    # the checkpoint callback is not block safe, so run A trains one
    # iteration a dispatch; resuming without it runs the pipelined
    # executor for the tail and lands on the straight pipelined run's
    # model text
    X, y = _data(seed=19)
    params = dict(PARAMS, fused_block_size=4)
    ref = lgt.train(dict(params), _ds(X, y), 12)
    st = ref.gbdt._pipeline_stats
    assert st is not None and st.blocks >= 1
    # saving reads the lagged stall poll once, and is not a stall poll
    polls = ref.gbdt.stall_polls
    state, _ = ref.gbdt.training_state()
    assert "pending_nleaves" in state and ref.gbdt.stall_polls == polls
    d = str(tmp_path)
    ck = lgt.train(dict(params), _ds(X, y), 6,
                   callbacks=[cb.checkpoint(6, d)])
    assert ck.gbdt._pipeline_stats is None
    assert ck.current_iteration() == 6
    resumed = lgt.train(dict(params), _ds(X, y), 12,
                        resume_from=latest_checkpoint(d))
    st = resumed.gbdt._pipeline_stats
    assert st is not None and st.iterations == 6
    assert resumed.current_iteration() == 12
    assert _strip(resumed.model_to_string()) == \
        _strip(ref.model_to_string())


def test_params_attach_the_checkpoint_callback(tmp_path):
    # checkpoint_period with checkpoint_dir in params: bundles every
    # period and at the end, keep checkpoint_keep; resuming from the
    # directory picks the newest and continues to the same bytes
    X, y = _data(seed=6)
    d = str(tmp_path / "auto")
    params = dict(PARAMS, checkpoint_period=2, checkpoint_dir=d,
                  checkpoint_keep=2)
    ref = lgt.train(dict(params), _ds(X, y), 7)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_0000006",
                                     "ckpt_0000007"]
    assert counters.get("checkpoint_saves") == 4
    # kill at 4: resume from ckpt_0000004 of a second directory's run
    d2 = str(tmp_path / "kill")
    lgt.train(dict(params, checkpoint_dir=d2), _ds(X, y), 4)
    resumed = lgt.train(dict(params, checkpoint_dir=d2), _ds(X, y), 7,
                        resume_from=d2)
    assert resumed.current_iteration() == 7
    assert [ln for ln in resumed.model_to_string().splitlines()
            if not ln.startswith("[checkpoint_dir")] == \
        [ln for ln in ref.model_to_string().splitlines()
         if not ln.startswith("[checkpoint_dir")]


# ---------------------------------------------------------------------------
# bundle mechanics
def test_bundle_layout_latest_and_keep_last(tmp_path):
    X, y = _data()
    d = str(tmp_path / "c")
    lgt.train(dict(PARAMS), _ds(X, y), 5,
              callbacks=[cb.checkpoint(1, d, keep_last=2)])
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_0000004",
                                     "ckpt_0000005"]
    assert open(os.path.join(d, "LATEST")).read() == "ckpt_0000005\n"
    bundle = os.path.join(d, "ckpt_0000005")
    assert sorted(os.listdir(bundle)) == ["arrays.npz", "model.txt",
                                          "state.json"]
    state = json.load(open(os.path.join(bundle, "state.json")))
    assert state["iteration"] == 5 and state["world_size"] == 1
    assert state["format_version"] == FORMAT_VERSION == 1
    with np.load(os.path.join(bundle, "arrays.npz")) as npz:
        assert sorted(npz.files) == ["rng_key", "train_score"]
        assert npz["rng_key"].dtype == np.int64
        assert npz["train_score"].dtype == np.float32
    loaded = load_checkpoint(d)
    assert loaded.iteration == 5 and loaded.path == bundle
    assert loaded.model_str == open(os.path.join(bundle,
                                                 "model.txt")).read()


def test_tmp_sweep_pin_and_scan_fallback(tmp_path):
    d = str(tmp_path / "c")
    arrays = {"train_score": np.zeros(3, np.float32),
              "rng_key": np.zeros(2, np.int64)}
    save_checkpoint(d, 1, "m1", {}, arrays)
    # a killed writer's leftover and a stale LATEST
    os.makedirs(os.path.join(d, ".tmp-ckpt_0000002-999"))
    with open(os.path.join(d, PIN_FILE), "w") as f:
        f.write("ckpt_0000001\n")
    for it in (2, 3, 4):
        save_checkpoint(d, it, f"m{it}", {}, arrays, keep_last=2)
    assert sorted(os.listdir(d)) == ["LATEST", "PINNED", "ckpt_0000001",
                                     "ckpt_0000003", "ckpt_0000004"]
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("ckpt_0000099\n")
    assert latest_checkpoint(d) == os.path.join(d, "ckpt_0000004")
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(LightGBMError):
        load_checkpoint(str(tmp_path / "missing"))


def test_failed_save_warns_and_training_goes_on(tmp_path):
    X, y = _data(seed=2)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    bst = lgt.train(dict(PARAMS), _ds(X, y), 4,
                    callbacks=[cb.checkpoint(2, str(blocker))])
    assert bst.current_iteration() == 4
    assert counters.get("checkpoint_failures") == 2
    assert counters.get("checkpoint_saves") == 0


def test_refusals(tmp_path):
    X, y = _data()
    d = str(tmp_path / "c")
    bst = lgt.train(dict(PARAMS), _ds(X, y), 2,
                    callbacks=[cb.checkpoint(2, d)])
    bst.save_model(str(tmp_path / "m.txt"))
    with pytest.raises(ValueError, match="exclusive"):
        lgt.train(dict(PARAMS), _ds(X, y), 4, resume_from=d,
                  init_model=str(tmp_path / "m.txt"))
    with pytest.raises(ValueError):
        cb.checkpoint(0, d)
    with pytest.raises(ValueError):
        cb.checkpoint(2, "")
    with pytest.raises(LightGBMError, match="num_class"):
        lgt.train(dict(PARAMS, objective="multiclass", num_class=3),
                  _ds(X, (X[:, 0] > 0).astype(np.float32)), 4,
                  resume_from=d)
    with pytest.raises(LightGBMError, match="boosting"):
        lgt.train(dict(PARAMS, boosting="goss"), _ds(X, y), 4,
                  resume_from=d)
    with pytest.raises(LightGBMError, match="same dataset"):
        lgt.train(dict(PARAMS), _ds(X[:400], y[:400]), 4, resume_from=d)


# (valid sets of run A, valid sets at resume): sets "a" (300 rows) and
# "b" (200 rows); the resumed run's sets must be the bundle's, in order
VALID_MISMATCH = {
    "extra": ("a", "ab"),
    "missing": ("a", ""),
    "other": ("a", "b"),
    "swapped": ("ab", "ba"),
}


@pytest.mark.parametrize("case", sorted(VALID_MISMATCH))
def test_resume_refuses_other_valid_sets(case, tmp_path):
    saved, given = VALID_MISMATCH[case]
    X, y = _data(seed=9)
    held = {"a": _data(seed=10, n=300), "b": _data(seed=11, n=200)}

    def run(rounds, names, **kw):
        ds = _ds(X, y)
        return lgt.train(dict(PARAMS, metric="binary_logloss"), ds, rounds,
                         valid_sets=[ds.create_valid(*held[k])
                                     for k in names],
                         valid_names=list(names), **kw)

    d = str(tmp_path / "c")
    run(3, saved, callbacks=[cb.checkpoint(3, d)])
    with pytest.raises(LightGBMError, match="same valid sets"):
        run(6, given, resume_from=d)


def test_jax_package_reads_the_port_bundles(tmp_path):
    X, y = _data(seed=8)
    d = str(tmp_path / "c")
    bst = lgt.train(dict(PARAMS), _ds(X, y), 6,
                    callbacks=[cb.checkpoint(3, d, keep_last=3)])
    found = jlatest_checkpoint(d)
    assert found == latest_checkpoint(d) == os.path.join(d, "ckpt_0000006")
    state = jload_checkpoint(d)
    assert state.iteration == 6
    assert state.model_str == bst.model_to_string()
    assert state.path == found
    np.testing.assert_array_equal(state.arrays["train_score"],
                                  bst.gbdt.train_score.numpy())
