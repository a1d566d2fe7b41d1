"""Observability wired into the port's training, on the CPU.

The same small problem trains in both packages with observe=true and
observe_norms=true, one update() an iteration: the per-iteration records
(iteration, trees, iterations, fused, bagging fraction, the reliability
counters' deltas, the phase keys, leaves) are equal and the gradient and
hessian norms agree within rtol 1e-6. The JAX booster takes its portable
grower on the CPU, where its tree_macs_for is 0 as the port's is on every
path (ROADMAP C21), so neither record carries estimated MACs. The
port-only paths follow: engine.train through the fused trainer and the
pipelined executor (one record a fused block, the fused_train compile
counted on the block that built the trainer and a hit on each later one,
one pipeline_block record and span a block, a trace dump that loads as
Chrome JSON), the model text byte-equal to an observe-off run's once the
observe*/profile_* echo lines are dropped, the flight recorder's bundle
with the registry's collective, clock_skew and counters entries and the
span events of the trace tap, torch.profiler captures of pipeline_block
and grow_tree on the CPU, the dataset timers, and the nvcc build's
compile entries (a stand-in compiler: there is no nvcc here).
"""

import json
import os
import stat
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.observability import recorder as jax_recorder
from lightgbm_tpu.observability import registry as jax_obs
from lightgbm_tpu.reliability.counters import counters as jax_counters
from lightgbm_tpu.utils.timer import global_timer as jax_timer

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.observability import profiler, recorder
from lightgbm_tpu_torch.observability import registry as obs
from lightgbm_tpu_torch.observability.profile import TRACE_FILE
from lightgbm_tpu_torch.reliability import counters
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_one_thread import one_thread  # noqa: F401

# growth_overshoot 0: the MXU grower's trees are the portable grower's
# (no best-first replay), so the two packages' norms follow each other
PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "verbosity": -1, "min_data_in_leaf": 5,
          "bagging_fraction": 0.8, "bagging_freq": 2,
          "growth_overshoot": 0.0}
ITERS = 5
ROUNDS = 12
BLOCK = 4


def _data(n=400, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0) \
        .astype(np.float32)
    return X, y


def _reset():
    for reg in (obs, jax_obs):
        reg.disable()
        reg.reset()
        reg.record_norms = False
    profiler.reset()
    counters.reset()
    jax_counters.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    recorder.reset()
    yield
    _reset()
    recorder.reset()
    recorder.configure(enabled=True, capacity=256, out_dir="")


def _updates(pkg, reg, ctr, extra=None):
    """ITERS update() calls with observe on and a counter moved before
    the third: the registry's records, snapshot and spans."""
    X, y = _data()
    params = dict(PARAMS, observe=True, observe_norms=True, **(extra or {}))
    ds = pkg.Dataset(X, label=y, params={"max_bin": 31})
    bst = pkg.Booster(params=params, train_set=ds)
    assert reg.enabled and reg.record_norms
    for i in range(ITERS):
        if i == 2:
            ctr.inc("checkpoint_saves")
        bst.update()
    out = (reg.training.records(), reg.snapshot(), reg.trace.spans())
    _reset()
    return out


@pytest.fixture(scope="module")
def jax_run():
    _reset()
    return _updates(lgb, jax_obs, jax_counters)


@pytest.fixture(scope="module")
def off_text():
    """engine.train's model with observe off (the byte-equality oracle)."""
    _reset()
    X, y = _data()
    bst = lgt.train(dict(PARAMS, device_type="cpu", fused_block_size=BLOCK),
                    lgt.Dataset(X, label=y), ROUNDS)
    return _strip(bst.model_to_string())


def _strip(text):
    """Model text without the observe*/profile_* parameter echo."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(("[observe", "[profile")))


def test_per_iteration_records_equal_jax(jax_run):
    want, want_snap, want_spans = jax_run
    got, snap, spans = _updates(lgt, obs, counters, {"device_type": "cpu"})
    assert len(got) == len(want) == ITERS
    for g, w in zip(got, want):
        for key in ("iteration", "trees", "iterations", "fused",
                    "bagging_fraction", "counters", "leaves",
                    "estimated_macs"):
            assert g.get(key) == w.get(key), (key, g, w)
        assert set(g["phases"]) == set(w["phases"])
        for key in ("grad_norm", "hess_norm"):
            assert g[key] == pytest.approx(w[key], rel=1e-6), (key, g, w)
        assert g["wall_s"] > 0
    assert got[2]["counters"] == {"checkpoint_saves": 1}
    assert got[2]["bagging_fraction"] == 0.8 and "leaves" in got[0]
    for key in ("iterations", "trees", "records_buffered"):
        assert snap["training"][key] == want_snap["training"][key]
    assert set(snap["training"]["phase_totals"]) == \
        set(want_snap["training"]["phase_totals"])
    assert snap["device_utilization"]["mfu"] is None and \
        want_snap["device_utilization"]["mfu"] is None
    assert snap["device_utilization"]["estimated_macs"] == 0
    # the JAX Dataset streams the array in (a streaming_chunk span)
    iters = lambda sp: [(s["name"], s.get("attrs"))  # noqa: E731
                        for s in sp if s["name"] == "train_iter"]
    assert iters(spans) == iters(want_spans)
    assert [s["name"] for s in spans] == ["train_iter"] * ITERS


def test_dataset_timers_match_jax():
    """The mapper search's buckets as in the JAX package; the port's
    dense Dataset quantizes in BinnedDataset.from_raw (dataset_quantize,
    the JAX package's from_raw bucket; its Booster bins a dense array
    through another route, which times only the mappers)."""
    X, y = _data(n=300)
    for pkg, t in ((lgb, jax_timer), (lgt, global_timer)):
        t.reset()
        pkg.Booster(params=dict(PARAMS, device_type="cpu"),
                    train_set=pkg.Dataset(X, label=y))
    keys = lambda t: {k for k in t.totals()  # noqa: E731
                      if k.startswith("dataset_")}
    assert keys(jax_timer) == {"dataset_sample", "dataset_bounds"}
    assert keys(global_timer) == {"dataset_sample", "dataset_bounds",
                                  "dataset_quantize"}


def _observed_train(tmp_path, **extra):
    X, y = _data()
    params = dict(PARAMS, device_type="cpu", fused_block_size=BLOCK,
                  observe=True,
                  observe_trace_file=str(tmp_path / "trace.json"), **extra)
    bst = lgt.train(params, lgt.Dataset(X, label=y), ROUNDS)
    return bst, params


def test_train_records_fused_and_pipeline_blocks(tmp_path, off_text):
    bst, params = _observed_train(tmp_path)
    assert _strip(bst.model_to_string()) == off_text
    snap = obs.snapshot()
    recs = obs.training.records()
    stats = bst.gbdt._pipeline_stats
    # iteration 0 per iteration, then one record a fused block
    assert recs[0]["iteration"] == 0 and "fused" not in recs[0]
    fused = [r for r in recs if r.get("fused")]
    assert len(fused) == len(recs) - 1 == stats.blocks
    assert sum(r.get("trees", 1) for r in recs) == \
        snap["training"]["trees"] == ROUNDS
    assert [r["iteration"] for r in fused] == \
        [1] + list(np.cumsum(stats.block_sizes)[:-1])
    comp = snap["compiles"]["entries"]["fused_train"]
    assert comp["compiles"] == 1 and comp["hits"] == stats.blocks - 1
    assert comp["compile_seconds"] > 0
    assert snap["pipeline"]["blocks"] == stats.blocks
    assert snap["pipeline"]["iterations"] == ROUNDS
    assert snap["hist_backend"]["choice"] == "mxu" and \
        snap["hist_backend"]["is_mxu"] == 1
    # the chrome dump the CLI writes from observe_trace_file
    assert obs.dump_trace(params["observe_trace_file"]) == "chrome"
    with open(params["observe_trace_file"]) as fh:
        doc = json.load(fh)
    events = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    by = lambda n: [ev for ev in events if ev["name"] == n]  # noqa: E731
    assert len(by("train_iter")) == 1
    assert len(by("train_iter")) + sum(
        ev["args"]["iterations"] for ev in by("fused_block")) == ROUNDS
    assert [ev["args"]["compiled"] for ev in by("fused_block")] == \
        [True] + [False] * (stats.blocks - 1)
    assert [ev["args"]["iterations"] for ev in by("pipeline_block")] == \
        stats.block_sizes
    assert doc["lightgbm_tpu_meta"]["rank"] == 0
    # the scrape's totals are the snapshot's
    text = obs.prometheus_text()
    assert f"lightgbm_tpu_training_trees {ROUNDS}" in text.splitlines()
    assert f"lightgbm_tpu_pipeline_blocks {stats.blocks}" in \
        text.splitlines()


def test_observe_off_records_nothing(off_text):
    X, y = _data()
    bst = lgt.train(dict(PARAMS, device_type="cpu", fused_block_size=BLOCK),
                    lgt.Dataset(X, label=y), ROUNDS)
    assert _strip(bst.model_to_string()) == off_text
    snap = obs.snapshot()
    assert not snap["enabled"] and snap["training"]["iterations"] == 0
    assert snap["trace"]["spans_buffered"] == 0
    assert snap["compiles"]["entries"] == {}
    assert snap["pipeline"]["blocks"] == 0
    assert global_timer.totals()["tree_train"] > 0


def test_recorder_bundle_carries_the_registry_entries(tmp_path):
    _observed_train(tmp_path)
    counters.inc("fallbacks")
    obs.record_collective_guard(0.5)
    path = recorder.flush("exception", out_dir=str(tmp_path / "pm"))
    with open(path) as fh:
        bundle = json.load(fh)
    assert bundle["collective"] == obs.collective_snapshot()
    assert bundle["collective"]["guarded"] == 1
    assert bundle["clock_skew"] == obs.clock_skew_snapshot()
    assert bundle["counters"] == counters.snapshot()
    assert bundle["counters"]["fallbacks"] == 1
    spans = [e["name"] for e in bundle["events"] if e["kind"] == "span"]
    assert {"train_iter", "fused_block", "pipeline_block"} <= set(spans)
    # the JAX package's bundle has the same entries
    jax_recorder.configure(enabled=True)
    jpath = jax_recorder.flush("exception", out_dir=str(tmp_path / "jpm"))
    with open(jpath) as fh:
        assert set(json.load(fh)) == set(bundle)


def test_profiled_blocks_and_growth_on_the_cpu(tmp_path, off_text):
    """torch.profiler (CPU activities) around the executor's blocks, at
    most two, and around one update()'s growth: each capture's directory
    holds its Chrome trace, nothing failed, and the models are the
    unprofiled ones."""
    d = tmp_path / "prof"
    bst, _ = _observed_train(tmp_path, profile_spans="pipeline_block",
                             profile_dir=str(d), profile_max_captures=2)
    assert _strip(bst.model_to_string()) == off_text
    assert profiler.snapshot() == {"armed": 0, "captures": 2,
                                   "max_captures": 2, "failed": 0}
    assert sorted(os.listdir(d)) == ["pipeline_block_001",
                                     "pipeline_block_002"]
    for sub in os.listdir(d):
        with open(d / sub / TRACE_FILE) as fh:
            names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
        assert any(str(n).startswith("aten::") for n in names)
    profiler.reset()
    X, y = _data()
    g = tmp_path / "grow"
    plain = lgt.Booster(dict(PARAMS, device_type="cpu"),
                        lgt.Dataset(X, label=y))
    bst = lgt.Booster(dict(PARAMS, device_type="cpu",
                           profile_spans="grow_tree", profile_dir=str(g),
                           profile_max_captures=1),
                      lgt.Dataset(X, label=y))
    for b in (plain, bst):
        for _ in range(2):
            b.update()
    assert _strip(bst.model_to_string()) == _strip(plain.model_to_string())
    assert profiler.snapshot()["captures"] == 1
    assert profiler.snapshot()["failed"] == 0
    assert os.listdir(g) == ["grow_tree_001"]
    assert os.path.exists(g / "grow_tree_001" / TRACE_FILE)


def test_nvcc_builds_are_compile_entries(tmp_path, monkeypatch):
    """build_all records one nvcc_<stem> compile a library it builds (here
    with a stand-in compiler that writes its output file), observe on or
    off, and nothing when every library is up to date."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv\n"
                    "open(a[a.index('-o') + 1], 'wb').write(b'lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    libs = _cuda.build_all()
    stems = sorted({_cuda.SOURCES.get(k, k) for k in _cuda.KERNELS})
    assert sorted(libs) == stems
    entries = obs.compiles.snapshot()
    assert sorted(entries) == [f"nvcc_{s}" for s in stems]
    assert all(e["compiles"] == 1 and e["hits"] == 0 and
               e["compile_seconds"] > 0 for e in entries.values())
    _cuda.build_all()
    assert obs.compiles.snapshot() == entries
