"""Device retries and the fused fall-back in training, on the CPU.

The growth dispatch (GBDT._grow, site histogram_build) and the fused
block (GBDT.train_many_dispatch, site fused_dispatch) retry a failed
attempt, and a fused block that fails every attempt trains per
iteration. An injected fault must change nothing in the model: each
faulted engine.train run below writes the model text of the clean run
byte for byte (the dispatch echo lines dropped), through the pipelined
executor and the block loop, with GOSS (whose key stream each attempt
rewinds), with CEGB (whose feature-used flags a retry puts back), and
with checkpoints (a failed save is counted, training carries on).

The flight recorder's bundles of a guard trip and of an exception out of
engine.train list the JAX package's events for the same run. The ladder
of retries and fall-backs is held call for call to the JAX package's in
tests/test_torch_retry_jax.py.
"""

import importlib
import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.observability.flightrec import recorder as jax_recorder
from lightgbm_tpu.reliability.counters import counters as jax_counters
from lightgbm_tpu_torch.observability.flightrec import recorder
from lightgbm_tpu_torch.reliability import counters
from lightgbm_tpu_torch.reliability.checkpoint import latest_checkpoint
from tests.test_torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.faults

faults_mod = importlib.import_module("lightgbm_tpu_torch.reliability.faults")
jax_faults_mod = importlib.import_module("lightgbm_tpu.reliability.faults")
faults, jax_faults = faults_mod.faults, jax_faults_mod.faults
_ENV = "LGBM_TPU_INJECT_FUSED_FAULT"

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1}
_PORT = dict(PARAMS, device_type="cpu", fused_block_size=5,
             retry_backoff_ms=0.0)
_ROUNDS = 15
_ECHO = ("[pipeline", "[fused_block_size", "[retry_", "[checkpoint_",
         "[flightrec", "[boosting:", "[top_rate", "[other_rate",
         "[cegb_")


def _data(n=1200, f=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _strip(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_ECHO))


def _reset():
    for reg in (faults, jax_faults):
        reg.clear()
    counters.reset()
    jax_counters.reset()
    for rec in (recorder, jax_recorder):
        rec.reset()
        rec.configure(enabled=True, out_dir="")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(_ENV, raising=False)
    _reset()
    yield
    _reset()


def _train(extra=None, rounds=_ROUNDS, valid=False, **kw):
    X, y = _data()
    p = dict(_PORT, **(extra or {}))
    ev = {}
    vs = None
    if valid:
        Xv, yv = _data(n=400, seed=9)
        ds = lgt.Dataset(X, label=y, params=p)
        vs = [ds.create_valid(Xv, label=yv)]
        kw["callbacks"] = [lgt.record_evaluation(ev)]
    else:
        ds = lgt.Dataset(X, label=y, params=p)
    bst = lgt.train(p, ds, rounds, valid_sets=vs, **kw)
    return bst, ev


_CLEAN = {}


def _clean_text(extra_key, extra):
    if extra_key not in _CLEAN:
        faults.clear()
        bst, ev = _train(extra, valid=extra_key.endswith("valid"))
        assert counters.snapshot()["device_retries"] == 0
        _CLEAN[extra_key] = (_strip(bst.model_to_string()), ev)
    return _CLEAN[extra_key]


# (name, schedule site, skip, fail, extra params, expected device_retries,
# fallbacks, _fused_disabled, clean run key)
_CASES = [
    ("histogram_build", "histogram_build", 0, 1, {}, 1, 0, False, "plain"),
    ("fused_retried", "fused_dispatch", 0, 1, {}, 1, 0, False, "plain"),
    ("fused_exhausted", "fused_dispatch", 1, 3, {}, 2, 1, False, "plain"),
    ("fused_twice_exhausted", "fused_dispatch", 0, 6, {}, 4, 2, True,
     "plain"),
    ("goss_exhausted", "fused_dispatch", 1, 3,
     {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2}, 2, 1,
     False, "goss"),
    ("serial_exhausted_valid", "fused_dispatch", 1, 3,
     {"pipeline": False, "metric": "binary_logloss"}, 2, 1, False,
     "serial_valid"),
    ("executor_exhausted_valid", "fused_dispatch", 1, 3,
     {"metric": "binary_logloss", "pipeline_device_eval": False}, 2, 1,
     False, "executor_valid"),
    ("cegb_histogram_build", "histogram_build", 3, 2,
     {"cegb_penalty_split": 0.5,
      "cegb_penalty_feature_coupled": [2.0] * 6}, 2, 0, False, "cegb"),
]
_CLEAN_EXTRA = {
    "plain": {}, "goss": {"boosting": "goss", "top_rate": 0.3,
                          "other_rate": 0.2},
    "serial_valid": {"pipeline": False, "metric": "binary_logloss"},
    "executor_valid": {"metric": "binary_logloss",
                       "pipeline_device_eval": False},
    "cegb": {"cegb_penalty_split": 0.5,
             "cegb_penalty_feature_coupled": [2.0] * 6},
}


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_faulted_train_writes_the_clean_model(case):
    name, site, skip, fail, extra, retries, fallbacks, disabled, key = case
    want, want_ev = _clean_text(key, _CLEAN_EXTRA[key])
    counters.reset()
    faults.schedule(site, skip=skip, fail=fail)
    bst, ev = _train(extra, valid=key.endswith("valid"))
    assert _strip(bst.model_to_string()) == want
    snap = counters.snapshot()
    assert (snap["device_retries"], snap["fallbacks"]) == \
        (retries, fallbacks)
    assert faults.snapshot() == {site: fail}
    assert faults.remaining(site) == (0, 0)
    gb = bst.gbdt
    assert gb._fused_disabled is disabled
    assert gb._fused_run is None          # train frees its trainer
    if key.endswith("valid"):
        # the k-point trajectory of a fall-back block: the same history
        assert ev == want_ev
    if name == "fused_twice_exhausted":
        # two blocks of 5 failed their 3 attempts each; the third block
        # ran per iteration without a fused attempt
        assert faults.calls("fused_dispatch") == 6
        assert gb.fused_stats == []
    if name == "fused_retried":
        # the first block's first attempt failed before the build: one
        # trainer ran the whole run
        assert len(gb.fused_stats) == 1
    if name == "fused_exhausted":
        # the trainer of block 1 was dropped; block 3 built a new one
        assert [st["trees"] for st in gb.fused_stats] == [4, 5]


def test_growth_exhaustion_raises_and_leaves_a_bundle(tmp_path):
    """histogram_build failing every attempt raises InjectedFault out of
    train, after retry_max_attempts - 1 retries; the engine's bundle
    (reason exception) lists the JAX package's events for the same run."""
    X, y = _data()
    lists = []
    for pkg, reg, rec, ctr, extra in (
            (lgt, faults, recorder, counters, {"device_type": "cpu"}),
            (lgb, jax_faults, jax_recorder, jax_counters, {})):
        d = tmp_path / pkg.__name__
        p = dict(PARAMS, retry_max_attempts=2, retry_backoff_ms=0.0,
                 flightrec_dir=str(d), **extra)
        reg.schedule("histogram_build", fail=10)
        with pytest.raises(RuntimeError, match="injected fault"):
            pkg.train(p, pkg.Dataset(X, label=y), 3)
        assert ctr.get("device_retries") == 1
        assert reg.trips("histogram_build") == 2
        with open(d / "postmortem_0.json") as fh:
            bundle = json.load(fh)
        assert bundle["reason"] == "exception"
        assert bundle["counters"]["device_retries"] == 1
        lists.append([(e["kind"], e["name"], e.get("mode"),
                       e.get("exc_type")) for e in bundle["events"]])
    assert lists[0] == lists[1] == [
        ("fault", "histogram_build", "raise", None),
        ("fault", "histogram_build", "raise", None),
        ("exception", "engine.train", None, "InjectedFault")]


def _nan_fobj(bad_call, label):
    def fobj(preds, dataset):
        g = np.asarray(preds, np.float64) - label
        h = np.ones_like(g)
        fobj.calls += 1
        if fobj.calls == bad_call:
            g = g.copy()
            g[0] = np.nan
        return g, h
    fobj.calls = 0
    return fobj


def test_guard_trip_bundle_matches_jax(tmp_path):
    """guard_nonfinite=raise on a custom objective whose third call has a
    NaN: GuardError out of train, and the guard bundle then the engine's
    exception bundle, with the JAX package's events."""
    X, y = _data()
    lists = []
    for pkg, extra in ((lgt, {"device_type": "cpu"}), (lgb, {})):
        d = tmp_path / pkg.__name__
        p = dict(PARAMS, guard_nonfinite="raise", flightrec_dir=str(d),
                 **extra)
        with pytest.raises(RuntimeError, match="non-finite"):
            pkg.train(p, pkg.Dataset(X, label=y), 5,
                      fobj=_nan_fobj(3, y))
        with open(d / "postmortem_0.json") as fh:
            bundle = json.load(fh)
        assert bundle["reason"] == "exception"
        assert bundle["counters"]["guard_trips"] == 1
        lists.append([(e["kind"], e["name"], e.get("policy"),
                       e.get("iteration"), e.get("exc_type"))
                      for e in bundle["events"]])
    assert lists[0] == lists[1] == [
        ("guard", "gradients/hessians", "raise", 2, None),
        ("exception", "engine.train", None, None, "GuardError")]


def test_checkpoint_io_failure_is_counted(tmp_path):
    """checkpoint_io fails the first save: counted, nothing of it on
    disk, the later periods saved, the model the clean run's."""
    want, _ = _clean_text("plain", {})
    counters.reset()
    faults.schedule("checkpoint_io", fail=1)
    d = tmp_path / "ck"
    bst, _ = _train({"checkpoint_period": 5, "checkpoint_dir": str(d)})
    assert _strip(bst.model_to_string()) == want
    snap = counters.snapshot()
    assert (snap["checkpoint_failures"], snap["checkpoint_saves"]) == (1, 2)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_0000010",
                                     "ckpt_0000015"]
    assert latest_checkpoint(str(d)).endswith("ckpt_0000015")
    # the saves are in the ring; no bundle was flushed (nothing fatal)
    saves = [e for e in recorder.events() if e["kind"] == "io"]
    assert [e["iteration"] for e in saves] == [10, 15]
    assert not [n for n in os.listdir(d) if n.startswith("postmortem")]
