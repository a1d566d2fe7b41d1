"""The port's crash flight recorder (observability/flightrec.py) on the CPU.

The ring's bound and drop count, the inert disabled recorder, the flush
reason policy (a non-fatal flush needs a configured directory, a fatal
one falls back to the working directory), the atomic flush with the
reliability counters' snapshot, and the event records of each record_*
call against the JAX package's recorder for the same calls (times
aside). current_rank reads LIGHTGBM_TPU_MACHINE_RANK, and importing the
recorder imports no JAX. A training Booster arms the recorder from its
config (flightrec, flightrec_ring, flightrec_dir, else checkpoint_dir);
a guard trip records and flushes. The collective brackets and clock
samples have no producer in the port yet and are not exercised here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.observability.flightrec import \
    FlightRecorder as JaxFlightRecorder
from lightgbm_tpu_torch.observability import configure_from_config
from lightgbm_tpu_torch.observability.flightrec import (FATAL_REASONS,
                                                        POSTMORTEM_PREFIX,
                                                        FlightRecorder,
                                                        current_rank,
                                                        recorder)
from lightgbm_tpu_torch.reliability import counters, guards
from tests.test_torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_MACHINE_RANK", raising=False)
    counters.reset()
    recorder.reset()
    recorder.configure(enabled=True, capacity=256, out_dir="")
    yield
    counters.reset()
    recorder.reset()
    recorder.configure(enabled=True, capacity=256, out_dir="")


def _bundle(dirpath, rank=0):
    path = os.path.join(str(dirpath), f"{POSTMORTEM_PREFIX}{rank}.json")
    assert os.path.exists(path), f"no postmortem bundle at {path}"
    with open(path) as fh:
        return json.load(fh)


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("t_wall", "t_mono")}
            for e in events]


def test_ring_bounded_and_drop_counted():
    rec = FlightRecorder(capacity=16)
    for i in range(40):
        rec.record("span", f"s{i}")
    snap = rec.snapshot()
    assert snap["events"] == 16 and snap["dropped"] == 24
    names = [e["name"] for e in rec.events()]
    assert names[0] == "s24" and names[-1] == "s39"
    # the capacity floor is 16, and resizing keeps the newest events
    rec.configure(capacity=4)
    assert rec.snapshot()["events"] == 16
    rec.configure(capacity=20)
    rec.record("span", "s40")
    assert [e["name"] for e in rec.events()][-1] == "s40"
    assert rec.snapshot()["events"] == 17


def test_disabled_recorder_is_inert(tmp_path):
    rec = FlightRecorder()
    rec.configure(enabled=False)
    rec.record("span", "x")
    rec.record_fault("histogram_build", "raise")
    assert rec.snapshot() == {"enabled": 0, "events": 0, "dropped": 0,
                              "flushes": 0}
    assert rec.flush("rank_death", out_dir=str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def test_flush_reason_policy(tmp_path, monkeypatch):
    assert FATAL_REASONS == ("watchdog_abort", "rank_death")
    rec = FlightRecorder()
    rec.record("span", "x")
    monkeypatch.chdir(tmp_path)
    # a non-fatal reason with no destination writes nothing anywhere
    for reason in ("exception", "guard_nonfinite"):
        assert rec.flush(reason) is None
    assert os.listdir(tmp_path) == []
    # a fatal one falls back to the working directory
    path = rec.flush("rank_death")
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    bundle = _bundle(tmp_path)
    assert bundle["reason"] == "rank_death"
    assert bundle["events"][0]["name"] == "x"


def test_flush_is_atomic_and_carries_counters(tmp_path):
    rec = FlightRecorder()
    rec.record_fault("fused_dispatch", "raise")
    counters.inc("device_retries", 2)
    counters.inc("fallbacks")
    path = rec.flush("exception", out_dir=str(tmp_path / "pm"),
                     extra={"diag": "block 3"})
    assert path == str(tmp_path / "pm" / "postmortem_0.json")
    assert os.listdir(tmp_path / "pm") == ["postmortem_0.json"]
    bundle = _bundle(tmp_path / "pm")
    assert bundle["counters"] == counters.snapshot()
    assert bundle["counters"]["device_retries"] == 2
    assert bundle["counters"]["fallbacks"] == 1
    assert bundle["diag"] == "block 3" and bundle["dropped"] == 0
    assert bundle["rank"] == 0 and bundle["pid"] == os.getpid()
    assert rec.snapshot()["flushes"] == 1 and rec.last_flush_path == path
    # a second flush replaces the bundle; no temp file is left behind
    rec.record_exception("engine.train", ValueError("x"))
    rec.flush("exception", out_dir=str(tmp_path / "pm"))
    assert os.listdir(tmp_path / "pm") == ["postmortem_0.json"]
    assert len(_bundle(tmp_path / "pm")["events"]) == 2


def test_flush_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rec = FlightRecorder()
    rec.record("span", "x")
    assert rec.flush("rank_death", out_dir=str(blocker / "sub")) is None
    assert rec.snapshot()["flushes"] == 0


def test_records_match_jax_recorder():
    """Each record_* call writes the JAX package's event, field for field
    (times aside); None fields are left out as there."""
    calls = [
        ("record", ("io", "x"), {"a": 1, "b": None}),
        ("record_span", ("grow", 0.5, 0.0123456, 2, "block"), {}),
        ("record_span", ("root", 0.0, 1.0, 0, None), {}),
        ("record_fault", ("histogram_build", "raise"), {}),
        ("record_fault", ("checkpoint_io", "rank_death"), {}),
        ("record_guard_trip", ("split gains/scores", "warn", 7), {}),
        ("record_guard_trip", ("gradients", "raise", np.int64(3)), {}),
        ("record_checkpoint", ("checkpoint_save", 20, "/x/ckpt_0000020"),
         {}),
        ("record_exception", ("engine.train",
                              RuntimeError("y" * 900)), {}),
    ]
    port, jax = FlightRecorder(), JaxFlightRecorder()
    for name, args, kw in calls:
        getattr(port, name)(*args, **kw)
        getattr(jax, name)(*args, **kw)
    assert _untimed(port.events()) == _untimed(jax.events())
    assert port.snapshot() == jax.snapshot()
    assert len(port.events()[-1]["exc"]) == 500


def test_current_rank_reads_the_env(monkeypatch, tmp_path):
    assert current_rank() == 0
    monkeypatch.setenv("LIGHTGBM_TPU_MACHINE_RANK", "3")
    assert current_rank() == 3
    rec = FlightRecorder()
    rec.flush("exception", out_dir=str(tmp_path))
    assert _bundle(tmp_path, rank=3)["rank"] == 3
    monkeypatch.setenv("LIGHTGBM_TPU_MACHINE_RANK", "not a rank")
    assert current_rank() == 0


def test_recorder_imports_no_jax():
    code = ("import os, sys; os.environ['LIGHTGBM_TPU_MACHINE_RANK'] = '2'\n"
            "from lightgbm_tpu_torch.observability.flightrec import "
            "current_rank, recorder\n"
            "from lightgbm_tpu_torch.reliability import faults\n"
            "assert current_rank() == 2\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lightgbm_tpu.', 'lightgbm_tpu'))\n"
            "            and not m.startswith('lightgbm_tpu_torch')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("LIGHTGBM_TPU_MACHINE_RANK", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, check=True,
                         stdin=subprocess.DEVNULL)
    assert out.stdout.strip() == "[]"


def _cfg(**params):
    return lgt.Config(dict(params))


def test_configure_from_config(tmp_path):
    configure_from_config(_cfg())
    assert (recorder.enabled, recorder.out_dir) == (True, "")
    assert recorder.snapshot()["enabled"] == 1
    configure_from_config(_cfg(checkpoint_dir=str(tmp_path / "ck")))
    assert recorder.out_dir == str(tmp_path / "ck")
    configure_from_config(_cfg(checkpoint_dir=str(tmp_path / "ck"),
                               flightrec_dir=str(tmp_path / "fr"),
                               flightrec_ring=32))
    assert recorder.out_dir == str(tmp_path / "fr")
    for i in range(40):
        recorder.record("span", str(i))
    assert recorder.snapshot()["events"] == 32
    configure_from_config(_cfg(flightrec=False))
    assert recorder.snapshot()["enabled"] == 0


def test_training_booster_arms_the_recorder(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(200, 3)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 4, "verbosity": -1,
              "device_type": "cpu", "flightrec_dir": str(tmp_path)}
    bst = lgt.Booster(params, lgt.Dataset(X, label=y))
    assert recorder.enabled and recorder.out_dir == str(tmp_path)
    # a booster loaded from a model leaves the recorder as it is
    lgt.Booster(model_str=bst.model_to_string())
    assert recorder.out_dir == str(tmp_path)
    lgt.Booster(dict(params, flightrec=False), lgt.Dataset(X, label=y))
    assert not recorder.enabled


def test_guard_trip_records_and_flushes(tmp_path):
    recorder.configure(out_dir=str(tmp_path))
    guards.trip("gradients", "warn", iteration=7)
    bundle = _bundle(tmp_path)
    assert bundle["reason"] == "guard_nonfinite"
    last = bundle["events"][-1]
    assert (last["kind"], last["name"], last["policy"],
            last["iteration"]) == ("guard", "gradients", "warn", 7)
    assert bundle["counters"]["guard_trips"] == 1
    with pytest.raises(guards.GuardError):
        guards.trip("gradients", "raise", iteration=8)
    assert _bundle(tmp_path)["events"][-1]["iteration"] == 8
