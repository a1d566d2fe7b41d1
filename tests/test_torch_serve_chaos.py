"""The serving chaos runs of tests/test_serve_chaos.py on the port's
harness (lightgbm_tpu_torch/testing/chaos_serve.py), at device_type="cpu"
and a small size.

Concurrent closed-loop load from the harness while the fault registry
kills replica dispatches, a breaker is forced open and the model is
hot-swapped mid-run. The ledger then shows: no request dropped or left
hanging, every answer bit-identical to a host predict of the same rows
under the old or the new model (dyadic boosters make the f32 device sums
equal the float64 host sums, so a torn model or a wrong batch slice
cannot hide inside a tolerance), and the breaker opening, probing and
closing again in the metrics. The port's dyadic rule rewrites a model
text as the JAX package's does.
"""

import time

import numpy as np
import pytest

from lightgbm_tpu.testing import chaos_serve as jchaos
from lightgbm_tpu_torch.reliability import InjectedFault, faults
from lightgbm_tpu_torch.serving import Server
from lightgbm_tpu_torch.testing.chaos_serve import (dyadic_booster,
                                                    dyadic_copy,
                                                    heavy_tailed_sizes,
                                                    run_closed_loop,
                                                    verify_bit_identical)
from tests.test_torch_one_thread import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def dyadic():
    return dyadic_booster(seed=3, device_type="cpu")


@pytest.fixture(scope="module")
def dyadic_v2():
    return dyadic_booster(seed=11, device_type="cpu")


def _server(**kw):
    return Server(device_type="cpu", min_bucket=4, max_bucket=256, **kw)


def test_dyadic_rule_equals_jax_and_is_bit_exact(dyadic):
    bst, X = dyadic
    text = bst.model_to_string()
    assert dyadic_copy(bst).model_to_string() == text   # a fixed point
    want = jchaos._LEAF_LINE.sub(
        lambda m: m.group(1) + " ".join(jchaos._quantize(v)
                                        for v in m.group(2).split()),
        text)
    assert want == text
    with _server() as srv:
        srv.load_model("m", booster=bst)
        got = srv.predict("m", X[:200], raw_score=True)
    assert np.array_equal(got, bst.predict(X[:200], raw_score=True))
    sizes = heavy_tailed_sizes(np.random.RandomState(0), 5000, max_rows=64)
    assert sizes.min() >= 1 and sizes.max() <= 64
    assert np.median(sizes) <= 8 and sizes.max() >= 32
    assert np.array_equal(
        sizes, jchaos.heavy_tailed_sizes(np.random.RandomState(0), 5000,
                                         max_rows=64))


def test_chaos_closed_loop_faults_breaker_and_hot_swap(dyadic, dyadic_v2):
    bst, X = dyadic
    bst2, _ = dyadic_v2
    faults.clear()
    with _server(n_replicas=2, retry_attempts=1, breaker_threshold=2,
                 breaker_cooldown_ms=50.0, max_queue=512,
                 slo_ms=30000.0) as srv:
        srv.load_model("m", booster=bst)

        def _chaos(_i):
            faults.schedule("serving_replica_predict", fail=3)
            srv.hot_swap("m", booster=bst2)
            srv.replicas("m").replicas()[0].breaker.force_open()

        res = run_closed_loop(srv, "m", X, n_requests=120, workers=6,
                              max_rows=48, raw_score=True, timeout_s=60.0,
                              seed=1, mid_run=_chaos)
        assert res.dropped == 0, res.by_outcome()
        outcomes = res.by_outcome()
        assert set(outcomes) <= {"ok", "shed", "deadline"}, outcomes
        assert outcomes.get("ok", 0) >= 110
        for rec in res.ok_records():
            val = np.asarray(rec.value)
            assert np.array_equal(
                val, bst.predict(X[rec.lo:rec.hi], raw_score=True)) or \
                np.array_equal(
                    val, bst2.predict(X[rec.lo:rec.hi], raw_score=True))
        assert faults.trips("serving_replica_predict") >= 1
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["version"] == 2
        reps = {r["replica"]: r for r in snap["replicas"]}
        assert reps[0]["opens"] >= 1
        time.sleep(0.1)
        for i in range(12):
            srv.predict("m", X[i:i + 4], raw_score=True)
        snap = srv.metrics_snapshot("m")["models"]["m"]
        reps = {r["replica"]: r for r in snap["replicas"]}
        assert reps[0]["state"] == "closed"
        assert reps[0]["probes"] >= 1 and reps[0]["closes"] >= 1
        assert snap["degraded"] is False
    faults.clear()


def test_chaos_every_replica_open_host_answers(dyadic):
    bst, X = dyadic
    faults.clear()
    with _server(n_replicas=2, retry_attempts=1, breaker_threshold=1,
                 breaker_cooldown_ms=60000.0, max_queue=512) as srv:
        srv.load_model("m", booster=bst)
        for rep in srv.replicas("m").replicas():
            rep.breaker.force_open()
        assert srv.metrics_snapshot("m")["models"]["m"]["degraded"] is True
        res = run_closed_loop(srv, "m", X, n_requests=40, workers=4,
                              max_rows=32, raw_score=True, seed=2)
        assert res.dropped == 0
        assert verify_bit_identical(res, bst, X) == len(res.ok_records())
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["fallback_count"] >= len(res.ok_records())


def test_hot_swap_fault_leaves_old_model_serving(dyadic, dyadic_v2):
    bst, X = dyadic
    bst2, _ = dyadic_v2
    with _server() as srv:
        srv.load_model("m", booster=bst)
        with faults.injected("serving_hot_swap", fail=1):
            with pytest.raises(InjectedFault):
                srv.hot_swap("m", booster=bst2)
        assert faults.trips("serving_hot_swap") >= 1
        snap = srv.metrics_snapshot("m")["models"]["m"]
        assert snap["version"] == 1 and snap["swap_drains"] == 0
        assert np.array_equal(srv.predict("m", X[:50], raw_score=True),
                              bst.predict(X[:50], raw_score=True))
        # the commit-side fault: the new entry is published, the swap
        # raises, and the new model serves
        with faults.injected("serving_hot_swap_commit", fail=1):
            with pytest.raises(InjectedFault):
                srv.hot_swap("m", booster=bst2)
        assert srv.metrics_snapshot("m")["models"]["m"]["version"] == 2
        assert np.array_equal(srv.predict("m", X[:50], raw_score=True),
                              bst2.predict(X[:50], raw_score=True))


def test_deadline_misses_under_pressure(dyadic):
    bst, X = dyadic
    with _server(slo_ms=0.001, deadline_policy="fallback",
                 max_queue=512) as srv:
        srv.load_model("m", booster=bst)
        srv.batcher("m").pause()
        srv.predict_async("m", X[:4], raw_score=True)
        res = run_closed_loop(srv, "m", X, n_requests=30, workers=3,
                              max_rows=16, raw_score=True, seed=3)
        assert res.dropped == 0
        assert verify_bit_identical(res, bst, X) == len(res.ok_records())
        assert srv.metrics_snapshot("m")["models"]["m"][
            "deadline_misses"] >= 1
        srv.batcher("m").resume()
