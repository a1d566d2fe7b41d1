"""The port's multi-model packs (lightgbm_tpu_torch/serving/multimodel.py)
on the CPU, against the JAX package's.

- predict_packed_forest_ref (the plain version of csrc/serve_forest.cu's
  packed mode) is bit-equal to the JAX package's XLA predict_packed_forest
  on packs built from the same model texts (every pack field equal too),
  and each member's rows to the member's solo forest sum; pad trees (a
  pack of 37 real trees in 64 slots) add nothing, even when their leaves
  hold -0.0, 7.0 or NaN, and a -0.0 leaf sums to +0.0 as in the JAX
  formulation;
- a served pack answers each member bit-equal to its solo device path,
  within RTOL 1e-5 / ATOL 1e-7 of host predict, and bit-equal to host
  predict on dyadic boosters; the per-pack first-seen shapes stay within
  max_compilations;
- the slo skip-and-fill and the fifo prefix dispatch the JAX batcher's
  batches on the same queue; the rows-aware admission model, member
  evict drain and the serving_pack_predict fault site behave as the JAX
  package's.
Data from tests/conftest.py's makers and chaos_serve's seeds.
"""

import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.serving.batcher import MicroBatcher as JMicroBatcher
from lightgbm_tpu.serving.multimodel import (
    build_forest_pack as jax_build_pack,
    predict_packed_forest as jax_packed)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.convert import tree_arrays_to_numpy
from lightgbm_tpu_torch.learner.predict import predict_binned_forest
from lightgbm_tpu_torch.reliability import faults
from lightgbm_tpu_torch.serving import (DeadlineExceeded, MicroBatcher,
                                        Server, max_compilations)
from lightgbm_tpu_torch.serving.batcher import _ServiceModel
from lightgbm_tpu_torch.serving.multimodel import (build_forest_pack,
                                                   predict_packed_forest,
                                                   predict_packed_forest_ref)
from lightgbm_tpu_torch.testing.chaos_serve import dyadic_booster
from tests.conftest import make_binary, make_multiclass, make_regression
from tests.test_torch_one_thread import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
PARAMS = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
          "device_type": "cpu"}


def _train(objective="binary", n=400, f=8, seed=0, rounds=8):
    if objective == "multiclass":
        X, y = make_multiclass(n=n, f=f, k=3, seed=seed)
        params = dict(PARAMS, objective="multiclass", num_class=3)
    elif objective == "regression":
        X, y = make_regression(n=n, f=f, seed=seed)
        params = dict(PARAMS, objective="regression")
    else:
        X, y = make_binary(n=n, f=f, seed=seed)
        params = dict(PARAMS, objective="binary")
    return lgt.train(params, lgt.Dataset(X, label=y), rounds), X


def _train_categorical(seed=7):
    r = np.random.RandomState(seed)
    X = r.randn(400, 5)
    X[:, 2] = r.randint(0, 12, 400)
    X[r.rand(400) < 0.15, 0] = np.nan
    y = ((X[:, 2] % 3 == 0) + 0.1 * np.nan_to_num(X[:, 0])) \
        .astype(np.float32)
    bst = lgt.train(dict(PARAMS, objective="regression"),
                    lgt.Dataset(X, label=y, categorical_feature=[2]), 6)
    Xq = X[:60].copy()
    Xq[0, 2] = 99          # unseen category -> right child
    Xq[1, 2] = np.nan      # NaN category -> right child
    Xq[2, 0] = np.nan      # missing numeric on a NaN-typed feature
    return bst, Xq


@pytest.fixture(scope="module")
def matrix():
    """Regression + binary + multiclass + a categorical/NaN model, and a
    query set each."""
    reg, Xr = _train("regression", seed=0)
    binm, Xb = _train("binary", seed=1)
    mc, Xm = _train("multiclass", seed=2, rounds=5)
    cat, Xq = _train_categorical()
    members = [("reg", reg), ("bin", binm), ("mc", mc), ("cat", cat)]
    queries = {"reg": Xr[:37], "bin": Xb[:64], "mc": Xm[:21], "cat": Xq}
    return members, queries


def _packs(members):
    port = build_forest_pack([(nm, b.device_forest("cpu"))
                              for nm, b in members])
    jax = jax_build_pack([(nm, jlgb.Booster(
        model_str=b.model_to_string()).device_forest())
        for nm, b in members])
    return port, jax


def _slot_batch(pack, members, queries, block):
    bins = np.zeros((pack.num_slots * block, pack.num_features),
                    pack.bin_dtype)
    valid = np.zeros(pack.num_slots * block, bool)
    for s, (nm, _) in enumerate(members):
        f = pack.forests[nm]
        b = f.bin_rows(queries[nm][:block])
        bins[s * block:s * block + len(b), :b.shape[1]] = b
        valid[s * block:s * block + len(b)] = True
    return bins, valid


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_packed_ref_bit_equal_jax_and_solo(matrix):
    import jax.numpy as jnp
    members, queries = matrix
    pack, jpack = _packs(members)
    assert pack.num_trees == jpack.num_trees == 37
    assert pack.stacked.split_feature.shape[0] == 64     # 27 pad trees
    got = tree_arrays_to_numpy(pack.stacked)
    for field, want in jpack.stacked._asdict().items():
        assert np.array_equal(got[field], np.asarray(want)), field
    for key in ("tree_model", "tree_class", "num_bins", "missing_is_nan"):
        assert np.array_equal(getattr(pack, key).numpy(),
                              np.asarray(getattr(jpack, key))), key
    assert pack.tree_off.tolist() == [0, 8, 16, 31, 37]
    for block in (16, 64):
        bins, valid = _slot_batch(pack, members, queries, block)
        for rv in (valid, None):
            want = np.asarray(jax_packed(
                jpack.stacked, jpack.tree_model, jpack.tree_class,
                jnp.int32(jpack.num_trees),
                jnp.asarray(bins.astype(np.int32)), jpack.num_bins,
                jpack.missing_is_nan, num_outputs=jpack.num_outputs,
                row_block=block,
                row_valid=None if rv is None else jnp.asarray(rv)))
            out = predict_packed_forest(
                pack.stacked, pack.tree_model, pack.tree_class,
                pack.num_trees, torch.from_numpy(bins), pack.num_bins,
                pack.missing_is_nan, pack.num_outputs, block,
                None if rv is None else torch.from_numpy(rv))
            assert np.array_equal(_bits(out), _bits(want))
        out = predict_packed_forest_ref(
            pack.stacked, pack.tree_model, pack.tree_class,
            pack.num_trees, torch.from_numpy(bins), pack.num_bins,
            pack.missing_is_nan, pack.num_outputs, block,
            torch.from_numpy(valid))
        assert np.all(_bits(out.numpy()[~valid]) == 0)
        for s, (nm, _) in enumerate(members):
            f = pack.forests[nm]
            q = f.bin_rows(queries[nm][:block])
            solo = predict_binned_forest(f.stacked, f.tree_class,
                                         torch.from_numpy(q), f.num_bins,
                                         f.missing_is_nan, f.num_outputs)
            blk = out[s * block:s * block + len(q), :f.num_outputs]
            assert np.array_equal(_bits(blk), _bits(solo)), (block, nm)


def test_pad_trees_add_nothing_and_signed_zero(matrix):
    """Pad trees are never read: poisoning their leaves changes no bit.
    Member trees whose leaves are all -0.0 add them onto +0.0 and give
    +0.0, as the JAX formulation does."""
    import jax.numpy as jnp
    members, queries = matrix
    pack, jpack = _packs(members[:3])
    block = 16
    bins, valid = _slot_batch(pack, members[:3], queries, block)
    args = (pack.tree_model, pack.tree_class, pack.num_trees,
            torch.from_numpy(bins), pack.num_bins, pack.missing_is_nan,
            pack.num_outputs, block, torch.from_numpy(valid))
    clean = predict_packed_forest(pack.stacked, *args)
    for poison in (-0.0, 7.0, float("nan")):
        lv = pack.stacked.leaf_value.clone()
        lv[pack.num_trees:] = poison
        out = predict_packed_forest(pack.stacked._replace(leaf_value=lv),
                                    *args)
        assert torch.equal(out.view(torch.int32), clean.view(torch.int32))
    # every real tree's leaves -0.0
    lv = pack.stacked.leaf_value.clone()
    lv[:pack.num_trees] = -0.0
    out = predict_packed_forest(pack.stacked._replace(leaf_value=lv), *args)
    jlv = np.asarray(jpack.stacked.leaf_value).copy()
    jlv[:jpack.num_trees] = -0.0
    want = np.asarray(jax_packed(
        jpack.stacked._replace(leaf_value=jnp.asarray(jlv)),
        jpack.tree_model, jpack.tree_class, jnp.int32(jpack.num_trees),
        jnp.asarray(bins.astype(np.int32)), jpack.num_bins,
        jpack.missing_is_nan, num_outputs=jpack.num_outputs,
        row_block=block, row_valid=jnp.asarray(valid)))
    assert np.array_equal(_bits(out), _bits(want))
    assert np.all(_bits(out) == 0)


def test_pack_serving_bit_identical_to_solo_and_close_to_host(matrix):
    members, queries = matrix
    solo = {}
    with Server(device_type="cpu", min_bucket=4, max_bucket=64) as srv:
        for nm, bst in members:
            srv.load_model(nm, booster=bst)
            solo[nm] = srv.predict(nm, queries[nm], raw_score=True)
    with Server(device_type="cpu", min_bucket=4, max_bucket=64,
                pack_size=8) as srv:
        srv.load_pack("matrix", members)
        for nm, bst in members:
            got = srv.predict(nm, queries[nm], raw_score=True)
            assert np.array_equal(got, solo[nm]), nm
            np.testing.assert_allclose(
                got, bst.predict(queries[nm], raw_score=True), rtol=RTOL,
                atol=ATOL)
            np.testing.assert_allclose(
                srv.predict(nm, queries[nm]), bst.predict(queries[nm]),
                rtol=RTOL, atol=ATOL)


def test_pack_dyadic_bit_identical_to_host_and_bounded():
    members = [(f"d{i}", dyadic_booster(trees=8 + 6 * i, seed=30 + i,
                                        device_type="cpu")[0])
               for i in range(3)]
    _, X = dyadic_booster(trees=1, seed=30, device_type="cpu")
    with Server(device_type="cpu", min_bucket=4, max_bucket=64,
                pack_size=4) as srv:
        srv.load_pack("dy", members)
        for nm, bst in members:
            for rows in (1, 5, 16, 33):
                got = srv.predict(nm, X[:rows], raw_score=True)
                assert np.array_equal(
                    got, bst.predict(X[:rows], raw_score=True))
        rng = np.random.RandomState(0)
        for _ in range(30):
            nm = members[rng.randint(len(members))][0]
            srv.predict(nm, X[:int(rng.randint(1, 100))], raw_score=True)
        snap = srv.metrics_snapshot()["packs"]["dy"]
    assert snap["compile_count"] <= max_compilations(64)
    assert snap["fused_dispatches"] >= 42


# ---------------------------------------------------------------------------
# the continuous-batching schedulers, against the JAX batcher


def _mk_req(rows, tag):
    return np.full((rows, 2), tag, np.int32)


def _dispatch_order(cls, scheduler):
    dispatched = []

    def run(bins):
        dispatched.append(sorted(set(int(v) for v in bins[:, 0])))
        return np.zeros((len(bins), 1), np.float32)

    mb = cls(run, max_batch_size=8, max_wait_ms=5.0, scheduler=scheduler)
    try:
        mb.pause()
        now = time.monotonic()
        futs = [mb.submit(_mk_req(4, 1), deadline=now + 10.0),
                mb.submit(_mk_req(6, 2), deadline=now + 2.0),
                mb.submit(_mk_req(2, 3), deadline=now + 10.0)]
        mb.resume()
        for f in futs:
            f.result(timeout=10.0)
    finally:
        mb.close()
    return dispatched, mb.interleave_count


@pytest.mark.parametrize("scheduler,want", [
    ("slo", ([[2, 3], [1]], 1)),     # tightest first, skip-and-fill
    ("fifo", ([[1], [2, 3]], 0)),    # a strict prefix
])
def test_scheduler_orders_equal_jax(scheduler, want):
    got = _dispatch_order(MicroBatcher, scheduler)
    assert got == _dispatch_order(JMicroBatcher, scheduler) == want


def test_service_model_is_rows_aware():
    svc = _ServiceModel(seed_s=0.002)
    for _ in range(30):
        svc.update(1024, 1.0)
        svc.update(8, 0.01)
    assert svc.projected(8) < 0.1 and svc.projected(1024) > 0.5
    assert svc.projected(1024) > 5 * svc.projected(8)


def test_admission_poisoned_estimate_and_looser_deadlines():
    fake = [100.0]

    def run(bins):
        return np.zeros((len(bins), 1), np.float32)

    mb = MicroBatcher(run, max_batch_size=64, max_wait_ms=2.0,
                      scheduler="slo", clock=lambda: fake[0])
    try:
        mb.pause()
        mb._svc.update(64, 10.0)
        mb.submit(_mk_req(4, 1), deadline=fake[0] + 0.005)
        assert mb.deadline_shed_count == 0
        with pytest.raises(DeadlineExceeded):
            mb.submit(_mk_req(4, 2), deadline=fake[0] + 0.005)
        assert mb.deadline_shed_count == 1
    finally:
        mb.close(drain_queued=False)
    mb = MicroBatcher(run, max_batch_size=64, max_wait_ms=2.0,
                      scheduler="slo", clock=lambda: fake[0])
    try:
        mb.pause()
        mb._svc.update(64, 10.0)
        mb.submit(_mk_req(32, 1))
        mb.submit(_mk_req(32, 2), deadline=fake[0] + 60.0)
        mb.submit(_mk_req(4, 3), deadline=fake[0] + 0.005)
        assert mb.deadline_shed_count == 0
    finally:
        mb.close(drain_queued=False)


# ---------------------------------------------------------------------------
# pack lifecycle and the fault site


def test_pack_member_evict_drains_queued_to_host_exactly_once():
    members = [(f"m{i}", dyadic_booster(trees=8, seed=50 + i,
                                        device_type="cpu")[0])
               for i in range(3)]
    boosters = dict(members)
    _, X = dyadic_booster(trees=1, seed=50, device_type="cpu")
    with Server(device_type="cpu", min_bucket=4, max_bucket=64,
                pack_size=4) as srv:
        srv.load_pack("lp", members)
        for nm, _ in members:
            srv.predict(nm, X[:8], raw_score=True)
        ents = {nm: srv.registry.get(nm) for nm, _ in members}
        base = {nm: ents[nm].metrics.snapshot()["requests"] for nm in ents}
        srv.batcher("m0").pause()
        f_evicted = srv.predict_async("m0", X[:5], raw_score=True)
        f_survivor = srv.predict_async("m1", X[:7], raw_score=True)
        assert srv.batcher("m0").queue_depth() == 2
        srv.evict_model("m0")
        assert np.array_equal(f_evicted.result(timeout=10.0),
                              boosters["m0"].predict(X[:5], raw_score=True))
        assert np.array_equal(f_survivor.result(timeout=10.0),
                              boosters["m1"].predict(X[:7], raw_score=True))
        for nm in ("m0", "m1"):
            s = ents[nm].metrics.snapshot()
            assert s["requests"] == base[nm] + 1
            assert s["fallback_count"] == 1
        snap = srv.metrics_snapshot()
        psnap = snap["packs"]["lp"]
        assert psnap["version"] == 2 and "m0" not in psnap["members"]
        assert psnap["rebuild_drains"] == 2
        assert snap["engine"]["pack_rebuilds"] == 1
        before = psnap["fused_dispatches"]
        assert np.array_equal(srv.predict("m1", X[:9], raw_score=True),
                              boosters["m1"].predict(X[:9], raw_score=True))
        assert srv.metrics_snapshot()["packs"]["lp"][
            "fused_dispatches"] > before
        assert "m0" not in srv.registry


def test_pack_fault_site_retries_inside_replica_bracket():
    members = [(f"m{i}", dyadic_booster(trees=8, seed=60 + i,
                                        device_type="cpu")[0])
               for i in range(2)]
    boosters = dict(members)
    _, X = dyadic_booster(trees=1, seed=60, device_type="cpu")
    faults.clear("serving_pack_predict")
    with Server(device_type="cpu", min_bucket=4, max_bucket=64,
                pack_size=4, retry_attempts=2,
                retry_backoff_ms=1.0) as srv:
        srv.load_pack("ft", members)
        srv.predict("m0", X[:8], raw_score=True)
        with faults.injected("serving_pack_predict", fail=1):
            got = srv.predict("m1", X[:12], raw_score=True)
        assert np.array_equal(got,
                              boosters["m1"].predict(X[:12], raw_score=True))
        assert faults.trips("serving_pack_predict") == 1
        assert srv.metrics_snapshot()["packs"]["ft"]["device_retries"] >= 1


def test_slot_ranges_need_contiguous_slots(matrix):
    """ROADMAP C27: the card's packed kernel walks each slot's trees as
    one range, `tree_off`, which build_forest_pack records as it lays
    members out: each slot's trees contiguous, in slot order, so the
    ranges are those tree_model gives. The plain version keeps the JAX
    semantics for any mapping and needs no tree_off."""
    members, _ = matrix
    pack, _ = _packs(members)
    tm = pack.tree_model[:pack.num_trees].numpy()
    assert (np.diff(tm) >= 0).all() and tm.min() >= 0
    want = np.zeros(pack.num_slots + 1, np.int32)
    want[1:] = np.cumsum(np.bincount(tm, minlength=pack.num_slots))
    assert pack.tree_off.dtype == torch.int32
    assert pack.tree_off.tolist() == want.tolist()
