"""The port's serving engine (lightgbm_tpu_torch/serving) on the CPU:
the server parts of tests/test_serving.py, at device_type="cpu", where
the forest sum runs its plain version.

Bucket bound, registry lifecycle, LRU and refresh, batcher FIFO, max size
and shedding, breaker transitions on a fake clock, deadline shed and
expiry, failover under injected faults, hot-swap drain, worker death,
and the Prometheus families. Answers are held to the port's
Booster.predict within RTOL 1e-5 / ATOL 1e-7 (f32 device accumulation
against the float64 host walk) and to the JAX package's Server.predict
on the same model text bit for bit (the same f32 adds in the same order,
the same float64 conversion); the snapshot's key sets and the serving
Prometheus families equal the JAX server's, and task=serve writes the
JAX CLI's predictions file and metrics schema. A Server without
device_type="cpu" raises when there is no card. Data from
tests/conftest.py's makers at the seeds given.
"""

import json
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.reliability import faults
from lightgbm_tpu_torch.serving import (BucketedPredictor, CircuitBreaker,
                                        DeadlineExceeded, MicroBatcher,
                                        ModelRegistry, OverloadError,
                                        Server, breaker_state_code,
                                        max_compilations, next_bucket)
from tests.conftest import make_binary, make_multiclass
from tests.test_torch_one_thread import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
PARAMS = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
          "device_type": "cpu"}


def _train(objective="binary", n=400, f=8, seed=0, rounds=8):
    if objective == "multiclass":
        X, y = make_multiclass(n=n, f=f, k=3, seed=seed)
        params = dict(PARAMS, objective="multiclass", num_class=3)
    else:
        X, y = make_binary(n=n, f=f, seed=seed)
        params = dict(PARAMS, objective="binary")
    bst = lgt.train(params, lgt.Dataset(X, label=y), rounds)
    return bst, X, y


def _server(**kw):
    return Server(device_type="cpu", **kw)


@pytest.fixture(scope="module")
def binary_model():
    return _train("binary")


# ---------------------------------------------------------------------------
# the device and the bucket ladder


def test_server_needs_a_card_or_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        Server()
    from lightgbm_tpu_torch.config import Config
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        Server.from_config(Config({}))
    srv = Server.from_config(Config({"device_type": "cpu",
                                     "serve_max_bucket": 32}))
    assert srv.device.type == "cpu" and srv.engine.max_bucket == 32
    srv.close()


def test_exports_and_imports_no_jax():
    import os
    import subprocess
    import sys
    import lightgbm_tpu.serving as jserving
    import lightgbm_tpu_torch.serving as serving
    assert serving.__all__ == jserving.__all__
    assert hasattr(lgt.Booster, "device_forest")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import lightgbm_tpu_torch.serving\n"
            "import lightgbm_tpu_torch.serving.multimodel\n"
            "import lightgbm_tpu_torch.testing.chaos_serve\n"
            "import lightgbm_tpu_torch.convert\n"
            "import lightgbm_tpu_torch.cli\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lightgbm_tpu.')) or "
            "m == 'lightgbm_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
                         capture_output=True, text=True, check=True,
                         stdin=subprocess.DEVNULL)
    assert out.stdout.strip() == "[]"


def test_next_bucket_and_bound():
    assert next_bucket(1, 4, 64) == 4
    assert next_bucket(4, 4, 64) == 4
    assert next_bucket(5, 4, 64) == 8
    assert next_bucket(64, 4, 64) == 64
    assert next_bucket(1000, 4, 64) == 64
    assert max_compilations(64) == 7
    assert max_compilations(1) == 2


def test_bucket_cache_bounds_compilations(binary_model):
    bst, X, _ = binary_model
    forest = bst.device_forest()
    engine = BucketedPredictor(min_bucket=4, max_bucket=64)
    sizes = [1, 2, 3, 5, 9, 17, 33, 64, 150, 400, 7, 40, 1, 64]
    outs = [engine.predict_raw(forest, forest.bin_rows(X[:s]))
            for s in sizes]
    assert engine.compile_count <= max_compilations(64)
    before = engine.compile_count
    for s, out in zip(sizes, outs):
        again = engine.predict_raw(forest, forest.bin_rows(X[:s]))
        assert np.array_equal(again, out)
        np.testing.assert_allclose(
            forest.convert_raw(again), bst.predict(X[:s]), rtol=RTOL,
            atol=ATOL)
    assert engine.compile_count == before and engine.hit_count > 0


# ---------------------------------------------------------------------------
# registry lifecycle


def test_registry_load_get_evict(binary_model):
    bst, _, _ = binary_model
    reg = ModelRegistry(max_models=4)
    entry = reg.load("m", booster=bst)
    assert entry.version == 1 and entry.forest.supported
    assert "m" in reg and len(reg) == 1 and reg.get("m") is entry
    assert reg.evict("m") is True and reg.evict("m") is False
    with pytest.raises(lgt.LightGBMError):
        reg.get("m")


def test_registry_refresh_and_lru(binary_model, tmp_path):
    bst, _, _ = binary_model
    reg = ModelRegistry(max_models=2)
    reg.load("a", booster=bst)
    assert reg.refresh("a", booster=bst).version == 2
    with pytest.raises(lgt.LightGBMError):
        reg.refresh("ghost", booster=bst)
    reg.load("b", model_str=bst.model_to_string())
    reg.get("a")                      # b becomes LRU
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    entry = reg.load("c", model_file=str(path))
    assert reg.names() == ["a", "c"]
    assert entry.forest.num_trees == bst.num_trees()


# ---------------------------------------------------------------------------
# micro-batching


def test_microbatcher_coalesces_in_fifo_order():
    calls = []

    def run(bins):
        calls.append(len(bins))
        return bins.astype(np.float32) * 2.0

    b = MicroBatcher(run, max_batch_size=100, max_wait_ms=50.0,
                     max_queue=16, name="t")
    try:
        b.pause()
        reqs = [np.full((i + 1, 2), i, np.uint8) for i in range(4)]
        futs = [b.submit(r) for r in reqs]
        assert b.queue_depth() == 4
        b.resume()
        outs = [f.result(timeout=10) for f in futs]
        assert calls == [sum(len(r) for r in reqs)]
        assert b.batch_count == 1 and b.coalesced_requests == 4
        for i, (r, o) in enumerate(zip(reqs, outs)):
            assert o.shape[0] == len(r) and np.all(o == 2.0 * i)
    finally:
        b.close()


def test_microbatcher_max_size_and_shedding():
    calls = []

    def run(bins):
        calls.append(len(bins))
        return bins.astype(np.float32)

    b = MicroBatcher(run, max_batch_size=5, max_wait_ms=50.0, name="t")
    try:
        b.pause()
        futs = [b.submit(np.zeros((3, 1), np.uint8)) for _ in range(3)]
        b.resume()
        for f in futs:
            f.result(timeout=10)
        assert sum(calls) == 9 and len(calls) >= 2
        assert all(c <= 5 or c == 3 for c in calls)
    finally:
        b.close()
    b = MicroBatcher(run, max_batch_size=8, max_wait_ms=5.0, max_queue=2,
                     name="t")
    try:
        b.pause()
        b.submit(np.zeros((1, 1), np.uint8))
        b.submit(np.zeros((1, 1), np.uint8))
        with pytest.raises(OverloadError):
            b.submit(np.zeros((1, 1), np.uint8))
        assert b.shed_count == 1
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the Server facade


def test_server_parity_mixed_sizes_and_jax_server(binary_model):
    """Mixed sizes within the tolerance of Booster.predict, and equal to
    the JAX package's Server on the same model text."""
    bst, X, _ = binary_model
    jbst = jlgb.Booster(model_str=bst.model_to_string())
    sizes = [1, 3, 17, 64, 120, 2, 33]
    with _server(min_bucket=4, max_bucket=64, max_wait_ms=1.0) as srv, \
            jlgb.serving.Server(min_bucket=4, max_bucket=64,
                                max_wait_ms=1.0) as jsrv:
        srv.load_model("m", booster=bst)
        jsrv.load_model("m", booster=jbst)
        lo = 0
        for s in sizes:
            sl = X[lo % 200: lo % 200 + s]
            got = srv.predict("m", sl)
            assert got.shape == bst.predict(sl).shape
            np.testing.assert_allclose(got, bst.predict(sl), rtol=RTOL,
                                       atol=ATOL)
            assert np.array_equal(got, jsrv.predict("m", sl))
            assert np.array_equal(srv.predict("m", sl, raw_score=True),
                                  jsrv.predict("m", sl, raw_score=True))
            lo += s
        snap, jsnap = srv.metrics_snapshot(), jsrv.metrics_snapshot()
        m = snap["models"]["m"]
        assert m["buckets_compiled"] <= m["max_compilations"]
        # the snapshot's schema is the JAX server's
        assert set(snap) == set(jsnap)
        assert set(m) == set(jsnap["models"]["m"])
        assert set(snap["engine"]) == set(jsnap["engine"])
        assert set(m["replicas"][0]) == \
            set(jsnap["models"]["m"]["replicas"][0])
        assert m["buckets_compiled"] == \
            jsnap["models"]["m"]["buckets_compiled"]
        json.dumps(snap)


def test_server_parity_multiclass_categorical_file(tmp_path):
    bst, X, _ = _train("multiclass", n=300, rounds=4)
    r = np.random.RandomState(7)
    Xc = r.randn(400, 5)
    Xc[:, 2] = r.randint(0, 12, 400)
    Xc[r.rand(400) < 0.15, 0] = np.nan
    y = ((Xc[:, 2] % 3 == 0) + 0.1 * np.nan_to_num(Xc[:, 0])) \
        .astype(np.float32)
    cat = lgt.train(dict(PARAMS, objective="regression"),
                    lgt.Dataset(Xc, label=y, categorical_feature=[2]), 6)
    Xq = Xc[:60].copy()
    Xq[0, 2] = 99          # unseen category -> right child
    Xq[1, 2] = np.nan      # NaN category -> right child
    path = tmp_path / "m.txt"
    cat.save_model(str(path))
    with _server(min_bucket=4, max_bucket=64) as srv:
        srv.load_model("mc", booster=bst)
        got = srv.predict("mc", X[:29])
        assert got.shape == (29, 3)
        np.testing.assert_allclose(got, bst.predict(X[:29]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(
            srv.predict("mc", X[:9], raw_score=True),
            bst.predict(X[:9], raw_score=True), rtol=RTOL, atol=1e-6)
        srv.load_model("cat", booster=cat)
        np.testing.assert_allclose(srv.predict("cat", Xq), cat.predict(Xq),
                                   rtol=RTOL, atol=ATOL)
        srv.load_model("f", model_file=str(path))
        np.testing.assert_allclose(
            srv.predict("f", Xq),
            lgt.Booster(model_file=str(path)).predict(Xq), rtol=RTOL,
            atol=ATOL)


def test_server_cpu_fallback_and_breaker_heal(binary_model, monkeypatch):
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64, retry_attempts=1,
                 breaker_threshold=2, breaker_cooldown_ms=150.0) as srv:
        srv.load_model("m", booster=bst)

        def boom(*a, **k):
            raise RuntimeError("device lost")

        monkeypatch.setattr(srv.engine, "predict_raw", boom)
        assert np.array_equal(srv.predict("m", X[:21]),
                              bst.predict(X[:21]))
        assert srv.metrics_snapshot("m")["models"]["m"][
            "fallback_count"] >= 1
        assert np.array_equal(srv.predict("m", X[:5]), bst.predict(X[:5]))
        breaker = srv.replicas("m").replicas()[0].breaker
        assert breaker.state == "open"
        assert srv.metrics_snapshot("m")["models"]["m"]["degraded"] is True
        monkeypatch.undo()
        time.sleep(0.2)
        np.testing.assert_allclose(srv.predict("m", X[:9]),
                                   bst.predict(X[:9]), rtol=RTOL,
                                   atol=ATOL)
        srv.predict("m", X[:3])
        assert breaker.state == "closed"
        assert breaker.opens >= 1 and breaker.closes >= 1
        assert srv.metrics_snapshot("m")["models"]["m"]["degraded"] is False


def test_server_unsupported_model_host_path():
    X, y = make_binary(n=300, f=5, seed=2)
    bst = lgt.train(dict(PARAMS, objective="regression", num_leaves=7,
                         linear_tree=True), lgt.Dataset(X, label=y), 3)
    assert "linear" in bst.device_forest().unsupported_reason
    with _server() as srv:
        srv.load_model("lin", booster=bst)
        assert np.array_equal(srv.predict("lin", X[:31]),
                              bst.predict(X[:31]))
        snap = srv.metrics_snapshot("lin")["models"]["lin"]
        assert snap["device_resident"] is False
        assert snap["fallback_count"] == 1


def test_server_shedding_metrics_evict_and_save(binary_model, tmp_path):
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64, max_queue=2,
                 max_wait_ms=50.0) as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        futs = [srv.predict_async("m", X[:3]) for _ in range(2)]
        with pytest.raises(OverloadError):
            srv.predict("m", X[:3])
        srv.batcher("m").resume()
        for f in futs:
            f.result(timeout=10)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["shed_count"] == 1 and snap["requests"] == 2
        path = tmp_path / "metrics.json"
        srv.save_metrics(str(path))
        saved = json.loads(path.read_text())
        assert saved["models"]["m"]["requests"] == 2 and "timers" in saved
        assert srv.evict_model("m") is True
        assert srv.evict_model("m") is False
        with pytest.raises(lgt.LightGBMError):
            srv.predict("m", X[:2])


# ---------------------------------------------------------------------------
# circuit breaker


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_transitions():
    clk = _FakeClock()
    br = CircuitBreaker(threshold=3, cooldown_s=1.0, clock=clk)
    assert br.state == "closed" and br.try_acquire()
    br.record_failure()
    br.record_failure()
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    assert not br.try_acquire() and not br.available()
    clk.t += 1.5
    assert br.try_acquire() and br.state == "half_open"
    assert not br.try_acquire()           # one probe at a time
    br.record_failure()                   # probe failed
    assert br.state == "open" and br.opens == 2
    assert not br.try_acquire()
    clk.t += 1.1
    assert br.try_acquire()
    br.record_success()
    assert br.state == "closed" and br.closes == 1 and br.probes == 2
    assert br.snapshot()["state_code"] == breaker_state_code("closed") == 0
    forced = CircuitBreaker(threshold=5, cooldown_s=60.0)
    forced.force_open()
    assert forced.state == "open" and not forced.available()


# ---------------------------------------------------------------------------
# SLO deadlines


def test_deadline_shed_and_expiry():
    b = MicroBatcher(lambda bins: np.zeros((len(bins), 1)),
                     max_batch_size=8, max_wait_ms=1.0, name="slo")
    try:
        b.pause()
        bins = np.zeros((4, 3), np.uint8)
        f1 = b.submit(bins, deadline=None)
        with pytest.raises(DeadlineExceeded):
            b.submit(bins, deadline=time.monotonic() + 1e-4)
        assert b.deadline_shed_count == 1
        f2 = b.submit(bins, deadline=time.monotonic() + 60.0)
        b.resume()
        assert f1.result(timeout=5.0).shape == (4, 1)
        assert f2.result(timeout=5.0).shape == (4, 1)
    finally:
        b.close()
    b = MicroBatcher(lambda bins: np.zeros((len(bins), 1)),
                     max_batch_size=8, max_wait_ms=1.0, name="slo2")
    try:
        b.pause()
        fut = b.submit(np.zeros((2, 3), np.uint8),
                       deadline=time.monotonic() + 0.05)
        time.sleep(0.15)
        b.resume()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5.0)
        assert b.deadline_expired_count == 1
    finally:
        b.close()


def test_server_deadline_policies(binary_model):
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64, slo_ms=0.001,
                 deadline_policy="fallback") as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        srv.predict("m", X[:4])
        assert np.array_equal(srv.predict("m", X[:7]), bst.predict(X[:7]))
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["deadline_misses"] >= 1 and snap["fallback_count"] >= 1
    with _server(min_bucket=4, max_bucket=64, slo_ms=0.001,
                 deadline_policy="fail") as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        try:
            srv.predict("m", X[:4])
        except DeadlineExceeded:
            pass
        with pytest.raises(DeadlineExceeded):
            srv.predict("m", X[:7])


# ---------------------------------------------------------------------------
# replica failover, hot swap, drain races, worker death


def test_replica_failover_on_injected_faults(binary_model):
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64, n_replicas=2,
                 retry_attempts=1, breaker_threshold=1,
                 breaker_cooldown_ms=60000.0) as srv:
        srv.load_model("m", booster=bst)
        reps = srv.replicas("m").replicas()
        assert len(reps) == 2 and reps[0].forest is reps[1].forest
        with faults.injected("serving_replica_predict", fail=1):
            got = srv.predict("m", X[:9])
        np.testing.assert_allclose(got, bst.predict(X[:9]), rtol=RTOL,
                                   atol=ATOL)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["failovers"] >= 1 and snap["breaker_open_replicas"] == 1
        states = {r["replica"]: r["state"] for r in snap["replicas"]}
        assert sorted(states.values()) == ["closed", "open"]
        np.testing.assert_allclose(srv.predict("m", X[:5]),
                                   bst.predict(X[:5]), rtol=RTOL, atol=ATOL)


def test_hot_swap_drains_queue_through_old_model(binary_model):
    bst, X, _ = binary_model
    X2, y2 = make_binary(n=400, f=X.shape[1], seed=99)
    bst2 = lgt.train(dict(PARAMS, objective="binary", num_leaves=9),
                     lgt.Dataset(X2, label=y2), 5)
    with _server(min_bucket=4, max_bucket=64) as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        futs = [srv.predict_async("m", X[i:i + 3]) for i in range(6)]
        entry = srv.hot_swap("m", booster=bst2)
        assert entry.version == 2
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(timeout=10.0),
                                  bst.predict(X[i:i + 3]))
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["swap_drains"] == 6 and snap["requests"] == 6
        np.testing.assert_allclose(srv.predict("m", X[:11]),
                                   bst2.predict(X[:11]), rtol=RTOL,
                                   atol=ATOL)
        assert srv.metrics_snapshot("m")["models"]["m"]["version"] == 2


def test_batcher_closed_drain_races_concurrent_evict(binary_model):
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64) as srv:
        entry = srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        futs = [srv.predict_async("m", X[i:i + 2]) for i in range(8)]
        stop = threading.Event()

        def _evict():
            stop.wait()
            srv.evict_model("m")

        def _late_submits():
            stop.wait()
            # each races the close: queued then drained, refused with
            # BatcherClosed (both host-resolve), or, once the evict has
            # unregistered the model, refused at lookup
            for i in range(4):
                try:
                    futs.append(srv.predict_async("m", X[i:i + 2]))
                except lgt.LightGBMError:
                    break

        racers = [threading.Thread(target=_evict),
                  threading.Thread(target=_late_submits)]
        for t in racers:
            t.start()
        stop.set()
        for t in racers:
            t.join(timeout=10.0)
        for i, f in enumerate(futs):
            got = f.result(timeout=10.0)
            assert np.array_equal(got, bst.predict(X[i % 8:i % 8 + 2])) \
                or got.shape == (2,)
        assert entry.metrics.requests == len(futs)
        assert "m" not in srv.registry.names()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_worker_death_flightrec_and_no_hang(tmp_path):
    from lightgbm_tpu_torch.observability.flightrec import recorder
    from lightgbm_tpu_torch.serving import BatcherClosed

    recorder.configure(enabled=True, out_dir=str(tmp_path))
    recorder.reset()

    def _die(bins):
        raise KeyboardInterrupt("worker killed")   # escapes Exception

    b = MicroBatcher(_die, max_batch_size=4, max_wait_ms=0.5, name="doomed")
    fut = b.submit(np.zeros((2, 3), np.uint8))
    with pytest.raises(BatcherClosed):
        fut.result(timeout=10.0)
    deadline = time.monotonic() + 5.0
    bundles = []
    while not bundles and time.monotonic() < deadline:
        bundles = list(tmp_path.glob("postmortem_*.json"))
        time.sleep(0.02)
    assert bundles
    rec = json.loads(bundles[0].read_text())
    evs = [e for e in rec["events"] if e.get("kind") == "exception"]
    assert any("serving_batcher_worker" in e.get("name", "") for e in evs)
    recorder.configure(out_dir="")
    with pytest.raises(BatcherClosed):
        b.submit(np.zeros((1, 3), np.uint8))


# ---------------------------------------------------------------------------
# the card's ladder: no host rung (ROADMAP C29), run here on the CPU with
# host_fallback=False, the card's default


def test_no_host_rung_device_error_reaches_the_caller(binary_model,
                                                       monkeypatch):
    """A dispatch error that is not an injected fault is neither retried
    nor failed over nor answered by the host: the caller gets it and
    `errors` counts it. Injected faults still take the breaker and
    failover rungs; with every breaker open the caller gets
    NoReplicaAvailable."""
    from lightgbm_tpu_torch.serving import NoReplicaAvailable
    bst, X, _ = binary_model
    with _server(min_bucket=4, max_bucket=64, n_replicas=2,
                 retry_attempts=3, retry_backoff_ms=0.0,
                 breaker_threshold=1, breaker_cooldown_ms=60000.0,
                 host_fallback=False) as srv:
        srv.load_model("m", booster=bst)
        with faults.injected("serving_replica_predict", fail=3):
            got = srv.predict("m", X[:9])
        np.testing.assert_allclose(got, bst.predict(X[:9]), rtol=RTOL,
                                   atol=ATOL)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["device_retries"] == 2 and snap["failovers"] == 1
        assert snap["breaker_open_replicas"] == 1
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("launch failed")

        monkeypatch.setattr(srv.engine, "predict_raw", boom)
        with pytest.raises(RuntimeError, match="launch failed"):
            srv.predict("m", X[:9])
        monkeypatch.undo()
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert len(calls) == 1 and snap["device_retries"] == 2
        assert snap["failovers"] == 1 and snap["errors"] == 1
        assert snap["breaker_open_replicas"] == 2
        with pytest.raises(NoReplicaAvailable):
            srv.predict("m", X[:5])
        assert srv.metrics_snapshot("m")["models"]["m"][
            "fallback_count"] == 0


def test_no_host_rung_deadline_swap_and_unsupported_model(binary_model):
    """Without the host rung a request past its deadline under
    "fallback" is answered late by the device, a hot swap drains the old
    queue through the old forest, and a model the kernel cannot serve is
    refused at load."""
    bst, X, _ = binary_model
    X2, y2 = make_binary(n=400, f=X.shape[1], seed=99)
    bst2 = lgt.train(dict(PARAMS, objective="binary", num_leaves=9),
                     lgt.Dataset(X2, label=y2), 5)
    with _server(min_bucket=4, max_bucket=64, deadline_policy="fallback",
                 host_fallback=False) as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        late = srv.predict_async("m", X[:7], slo_ms=50.0)
        time.sleep(0.15)
        srv.batcher("m").resume()
        np.testing.assert_allclose(late.result(timeout=10.0),
                                   bst.predict(X[:7]), rtol=RTOL,
                                   atol=ATOL)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["deadline_misses"] == 1 and snap["fallback_count"] == 0
        srv.batcher("m").pause()
        futs = [srv.predict_async("m", X[i:i + 3]) for i in range(6)]
        assert srv.hot_swap("m", booster=bst2).version == 2
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10.0),
                                       bst.predict(X[i:i + 3]), rtol=RTOL,
                                       atol=ATOL)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["swap_drains"] == 0 and snap["fallback_count"] == 0
        np.testing.assert_allclose(srv.predict("m", X[:11]),
                                   bst2.predict(X[:11]), rtol=RTOL,
                                   atol=ATOL)
        Xl, yl = make_binary(n=300, f=5, seed=2)
        lin = lgt.train(dict(PARAMS, objective="regression", num_leaves=7,
                             linear_tree=True), lgt.Dataset(Xl, label=yl), 3)
        with pytest.raises(lgt.LightGBMError, match="linear"):
            srv.load_model("lin", booster=lin)
        assert "lin" not in srv.registry


def _families(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE lightgbm_tpu_serving") or
                   ln.startswith("# TYPE lightgbm_tpu_multimodel")})


def test_prometheus_families_equal_jax(binary_model):
    bst, X, _ = binary_model
    text = bst.model_to_string()
    with _server(min_bucket=4, max_bucket=64, n_replicas=2) as srv, \
            jlgb.serving.Server(min_bucket=4, max_bucket=64,
                                n_replicas=2) as jsrv:
        srv.load_model("m", model_str=text)
        jsrv.load_model("m", model_str=text)
        srv.predict("m", X[:5])
        jsrv.predict("m", X[:5])
        got, want = srv.prometheus_text(), jsrv.prometheus_text()
    for line in ('lightgbm_tpu_serving_replica_breaker_state'
                 '{model="m",replica="0"} 0',
                 'lightgbm_tpu_serving_replica_breaker_state'
                 '{model="m",replica="1"} 0',
                 'lightgbm_tpu_serving_model_deadline_misses{model="m"}',
                 'lightgbm_tpu_serving_model_failovers{model="m"}',
                 'lightgbm_tpu_serving_model_swap_drains{model="m"}'):
        assert line in got
    assert _families(got) == _families(want)
    assert len(_families(got)) > 20


# ---------------------------------------------------------------------------
# CLI task=serve


def test_cli_task_serve_matches_jax_cli(tmp_path):
    """task=serve through the port's CLI against the JAX CLI's, on the
    same CSV and model file: the same predictions file (its values equal,
    since both sum the same f32 adds) and the same metrics schema."""
    from lightgbm_tpu.cli import main as jax_cli
    from lightgbm_tpu_torch.cli import main as port_cli
    X, y = make_binary(n=200, f=5, seed=4)
    train_file = tmp_path / "train.csv"
    np.savetxt(train_file, np.column_stack([y, X]), delimiter=",",
               fmt="%.8g")
    model_file = tmp_path / "model.txt"
    assert port_cli([f"data={train_file}", "task=train", "objective=binary",
                     "num_leaves=7", "num_iterations=3", "verbosity=-1",
                     "min_data=5", "device_type=cpu",
                     f"output_model={model_file}"]) == 0
    outs = {}
    for tag, main, extra in (("port", port_cli, ["device_type=cpu"]),
                             ("jax", jax_cli, [])):
        out_file = tmp_path / f"preds_{tag}.tsv"
        assert main([f"data={train_file}", "task=serve",
                     f"input_model={model_file}",
                     f"output_result={out_file}", "verbosity=-1",
                     "max_bucket=64", "min_bucket=4"] + extra) == 0
        snap = json.loads(open(str(out_file) + ".metrics.json").read())
        outs[tag] = (out_file.read_text(), snap)
    preds = np.loadtxt(tmp_path / "preds_port.tsv")
    assert preds.shape == (200,)
    np.testing.assert_allclose(
        preds, lgt.Booster(model_file=str(model_file)).predict(X),
        rtol=RTOL, atol=1e-6)
    assert np.array_equal(preds, np.loadtxt(tmp_path / "preds_jax.tsv"))
    (text, snap), (jtext, jsnap) = outs["port"], outs["jax"]
    assert text == jtext
    m, jm = snap["models"]["default"], jsnap["models"]["default"]
    assert set(snap) == set(jsnap) and set(m) == set(jm)
    assert set(snap["engine"]) == set(jsnap["engine"])
    assert m["rows"] == 200 and m["shed_count"] == 0
    assert (m["requests"], m["buckets_compiled"]) == \
        (jm["requests"], jm["buckets_compiled"])
    assert m["buckets_compiled"] <= snap["engine"][
        "max_compilations_per_model"]
