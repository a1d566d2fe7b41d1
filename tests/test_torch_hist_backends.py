"""The port's histogram backends (hist_backend=mxu|pallas|scatter|auto)
against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, its partition and
segment-sum oracle as plain XLA; the port's wrappers run their plain
versions. Same inputs from one numpy seed. The partition layout and the
route counts must be identical; quantized histograms bit-identical on every
backend (integer sums), exact ones within the bar of test_torch_kernels.py;
the grower under each backend grows the JAX grower's tree (routing,
structure and refit leaves bit for bit, as test_torch_quantized.py holds
the mxu backend); and the port's quantized model text is byte-equal
across its backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner import histogram as jax_hist
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import gbdt as torch_gbdt
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner import histogram as torch_hist
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.test_torch_kernels import (BMAX, N, NUM_SLOTS, _assert_hist_close,
                                      _inputs, _jax_tables, _t,
                                      _torch_tables)
from tests.test_torch_quantized import (_dyadic_problem, _quantized_channels,
                                        _same_bits)


def strip_backend_echo(model_str):
    """model.txt records every param, hist_backend included: the one line
    that differs across backends."""
    return "\n".join(line for line in model_str.splitlines()
                     if not line.startswith("[hist_backend:"))


# ---------------------------------------------------------------------------
# partition_rows
# ---------------------------------------------------------------------------

def _slots(case):
    r = np.random.RandomState(3)
    if case == "mixed":             # parked rows, empty slots, n % nb != 0
        slot = r.randint(-2, 14, 2999)
        slot[np.isin(slot, [3, 7])] = 11
        return slot, 12, 256
    if case == "single_row":
        return np.array([4]), 6, 128
    if case == "all_parked":
        return np.full(700, -1), 5, 128
    if case == "exact_blocks":      # every slot a multiple of the block
        return np.repeat(np.arange(4), 64), 4, 64
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mixed", "single_row", "all_parked",
                                  "exact_blocks"])
@pytest.mark.parametrize("with_counts", [False, True],
                         ids=["counted_here", "route_counts"])
def test_partition_rows_matches_jax(case, with_counts):
    slot, s, nb = _slots(case)
    slot = slot.astype(np.int32)
    live = slot[(slot >= 0) & (slot < s)]
    counts = np.bincount(live, minlength=s).astype(np.int32) \
        if with_counts else None
    want_bs, want_src = jax_p.partition_rows(
        jnp.asarray(slot), num_slots=s, row_block=nb,
        counts=None if counts is None else jnp.asarray(counts),
        impl="argsort")
    for impl in ("argsort", "scan", "auto"):
        bs, src = torch_p.partition_rows(
            _t(slot), num_slots=s, row_block=nb,
            counts=None if counts is None else _t(counts), impl=impl)
        assert bs.dtype == src.dtype == torch.int32
        _same_bits(bs, want_bs)
        _same_bits(src, want_src)
    n = slot.shape[0]
    real = src.numpy()[src.numpy() < n]
    assert sorted(real.tolist()) == list(range(n))


def test_partition_matches_jax_scan_over_many_blocks():
    # the JAX package's blocked prefix-sum partition carries per-slot
    # totals across its 4096-row blocks; rows past several such blocks
    # must land where the port's stable sort puts them
    slot = np.random.RandomState(8).randint(-1, 10, 9000).astype(np.int32)
    want_bs, want_src = jax_p.partition_rows(
        jnp.asarray(slot), num_slots=9, row_block=128, impl="scan")
    bs, src = torch_p.partition_rows(_t(slot), num_slots=9, row_block=128,
                                     impl="scan")
    _same_bits(bs, want_bs)
    _same_bits(src, want_src)


def test_partition_rejects_unknown_impl():
    with pytest.raises(ValueError, match="partition impl"):
        torch_p.partition_rows(_t(np.zeros(4, np.int32)), num_slots=2,
                               row_block=8, impl="radix")


# ---------------------------------------------------------------------------
# route_rows(emit_counts=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_slots", [NUM_SLOTS, 7])
def test_route_counts_match_jax(num_slots):
    d = _inputs(6)
    tbl, member, feat_tbl = _jax_tables(d)
    rn_j, rs_j, c_j = jax_k.route_rows_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["row_node"]), tbl, member,
        feat_tbl, emit_counts=True, num_slots=num_slots, interpret=True)
    rn_t, rs_t, c_t = torch_k.route_rows(
        _t(d["bins"]), _t(d["row_node"]), *_torch_tables(d),
        emit_counts=True, num_slots=num_slots)
    _same_bits(rn_t, rn_j)
    _same_bits(rs_t, rs_j)
    assert c_t.dtype == torch.int32 and c_t.shape == (num_slots,)
    _same_bits(c_t, c_j)
    # slots past num_slots and parked rows are not counted
    rs = rs_t.numpy()
    assert int(c_t.sum()) == int(((rs >= 0) & (rs < num_slots)).sum()) < N


def test_route_counts_need_slots():
    d = _inputs(6)
    with pytest.raises(ValueError, match="num_slots"):
        torch_k.route_rows(_t(d["bins"]), _t(d["row_node"]),
                           *_torch_tables(d), emit_counts=True)


# ---------------------------------------------------------------------------
# build_histograms_scatter (K7) and the segment-sum oracle
# ---------------------------------------------------------------------------

def _scatter_both(d, slot, quantized, const_hess, impl="auto"):
    if quantized:
        g, h, tg, th, tc = _quantized_channels(d, 10)
    else:
        g, h = d["grad"], d["hess"]
        tg, th, tc = _t(g), _t(h), _t(d["cnt"])
    h_j = jax_p.build_histograms_scatter(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(slot), num_slots=NUM_SLOTS,
        bmax=BMAX, quantized=quantized, const_hess=const_hess,
        partition_impl=impl, interpret=True)
    h_t = torch_p.build_histograms_scatter(
        _t(d["bins"]), tg, th, tc, _t(slot), num_slots=NUM_SLOTS, bmax=BMAX,
        quantized=quantized, const_hess=const_hess, partition_impl=impl)
    assert h_t.shape == (NUM_SLOTS, d["bins"].shape[1], BMAX, 3)
    return h_t, h_j


def _slot_vector(seed):
    return np.random.RandomState(seed).randint(-1, NUM_SLOTS + 3, N) \
        .astype(np.int32)


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
@pytest.mark.parametrize("impl", ["scan", "argsort"])
def test_quantized_scatter_matches_jax_bit_for_bit(const_hess, impl):
    d = _inputs(7)
    h_t, h_j = _scatter_both(d, _slot_vector(11), True, const_hess, impl)
    _same_bits(h_t, h_j)
    assert np.abs(h_t[..., 0].numpy()).max() > 127     # real sums


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_exact_scatter_matches_jax(const_hess):
    d = _inputs(8)
    h_t, h_j = _scatter_both(d, _slot_vector(12), False, const_hess)
    _assert_hist_close(h_t, h_j)
    assert h_t[..., 2].sum() > 0


def test_scatter_equals_build_histograms_with_route_counts():
    # the plain version over the partition is the per-row histogram, and
    # route counts are a pure shortcut for the partition's own count
    d = _inputs(9)
    g, h, tg, th, tc = _quantized_channels(d, 13)
    slot = _slot_vector(14)
    counts = _t(np.bincount(slot[(slot >= 0) & (slot < NUM_SLOTS)],
                            minlength=NUM_SLOTS).astype(np.int32))
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX, quantized=True)
    want = torch_k.build_histograms(_t(d["bins"]), tg, th, tc, _t(slot),
                                    **kw)
    got = torch_p.build_histograms_scatter(_t(d["bins"]), tg, th, tc,
                                           _t(slot), slot_counts=counts,
                                           **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["exact", "quantized"])
def test_segment_sum_oracle_matches_jax(quantized):
    d = _inputs(10)
    slot = _slot_vector(15)
    if quantized:
        g, h, tg, th, _ = _quantized_channels(d, 16)
    else:
        g, h = d["grad"], d["hess"]
        tg, th = _t(g), _t(h)
    h_j = np.asarray(jax_hist.build_histograms(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(slot), jnp.asarray(d["cnt"]), num_slots=NUM_SLOTS,
        bmax=BMAX))
    h_t = torch_hist.build_histograms(_t(d["bins"]), tg, th, _t(slot),
                                      _t(d["cnt"]), num_slots=NUM_SLOTS,
                                      bmax=BMAX)
    if quantized:
        _same_bits(h_t, h_j)
        # ... and equal to the integer-mode kernel's plain version
        assert torch.equal(h_t, torch_k.build_histograms(
            _t(d["bins"]), tg, th, _t(d["cnt"]), _t(slot),
            num_slots=NUM_SLOTS, bmax=BMAX, quantized=True))
    else:
        np.testing.assert_allclose(h_t.numpy(), h_j, rtol=1e-5, atol=1e-5)


def test_fits_v2_mirrors_jax():
    for s in (2, 24, 136, 263, 511):
        for f in (8, 28, 200):
            for bmax in (16, 64, 256):
                for quant in (False, True):
                    for rw in (0, f, 3 * f):
                        for rb in (2048, 4096, 8192):
                            for ch in (0.0, 1.0):
                                assert torch_k.fits_v2(
                                    s, f, bmax, quant, route_width=rw,
                                    row_block=rb, const_hess=ch) == \
                                    jax_k.fits_v2(
                                        s, f, bmax, True, quant,
                                        route_width=rw, row_block=rb,
                                        const_hess=ch), (s, f, bmax, rw)


@pytest.mark.parametrize("num_slots", [NUM_SLOTS, 6000],
                         ids=["v2", "v1_wide"])
def test_build_histograms_auto_matches_jax(num_slots):
    d = _inputs(11)
    g, h, tg, th, tc = _quantized_channels(d, 17)
    slot = np.random.RandomState(18).randint(-1, num_slots, N) \
        .astype(np.int32)
    f = d["bins"].shape[1]
    assert torch_k.fits_v2(num_slots, f, BMAX, True) == (num_slots < 6000)
    h_j = jax_k.build_histograms_mxu_auto(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(slot), num_slots=num_slots,
        bmax=BMAX, quantized=True, interpret=True)
    h_t = torch_k.build_histograms_auto(
        _t(d["bins"]), tg, th, tc, _t(slot), num_slots=num_slots,
        bmax=BMAX, quantized=True)
    _same_bits(h_t, h_j)


# ---------------------------------------------------------------------------
# the grower under each backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,const_hess", [
    ("pallas", 0.0), ("scatter", 1.0)])
def test_grower_backend_matches_jax(backend, const_hess):
    n = 3000
    ds, grad, hess = _dyadic_problem(n, 8, seed=31, const_hess=bool(
        const_hess))
    key = jax.random.fold_in(jax.random.PRNGKey(6), 4)
    kw = dict(num_leaves=15, max_depth=-1, overshoot=2.0, tail_split_cap=8,
              hist_subtraction=True, bmax=int(ds.num_bins.max()),
              const_hessian=const_hess, quantized_grad=True,
              hist_backend=backend)
    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(n, jnp.float32), jnp.ones(ds.num_features, jnp.float32),
        jnp.asarray(ds.num_bins), jnp.asarray(ds.missing_types == 2),
        jnp.asarray(ds.is_categorical), hp=JaxHP(), interpret=True,
        rng_key=key, **kw)
    args = (torch.as_tensor(ds.bins), torch.as_tensor(grad),
            torch.as_tensor(hess), torch.ones(n), torch.ones(ds.num_features),
            torch.as_tensor(ds.num_bins),
            torch.as_tensor(ds.missing_types == 2),
            torch.as_tensor(ds.is_categorical))
    tkey = convert.key_from_numpy(np.asarray(key))
    torch_k.reset_launch_counts()
    t_torch, r_torch = torch_grower.grow_tree_mxu(
        *args, hp=SplitHyperParams(), rng_key=tkey, **kw)
    assert set(torch_k.launch_counts().values()) == {0}     # plain versions
    want = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in t_jax._asdict().items()})
    nn = int(want.num_nodes)
    assert int(t_torch.num_nodes) == nn and int(t_torch.num_leaves) == 15
    _same_bits(r_torch, r_jax)
    leaf = want.is_leaf[:nn]
    for fld in ("split_feature", "left", "right", "parent", "depth",
                "is_leaf", "count"):
        _same_bits(getattr(t_torch, fld)[:nn], getattr(want, fld)[:nn])
    for fld in ("leaf_value", "sum_grad", "sum_hess"):
        _same_bits(getattr(t_torch, fld)[:nn][leaf],
                   getattr(want, fld)[:nn][leaf])
    # and the same tree as the port's own mxu backend
    t_mxu, r_mxu = torch_grower.grow_tree_mxu(
        *args, hp=SplitHyperParams(), rng_key=tkey,
        **dict(kw, hist_backend="mxu"))
    assert torch.equal(r_mxu, r_torch)
    for fld in t_mxu._fields:
        assert torch.equal(getattr(t_mxu, fld), getattr(t_torch, fld)), fld


def test_grower_rejects_unresolved_auto():
    ds, grad, hess = _dyadic_problem(300, 3, seed=2, const_hess=False)
    with pytest.raises(ValueError, match="resolved hist_backend"):
        torch_grower.grow_tree_mxu(
            torch.as_tensor(ds.bins), torch.as_tensor(grad),
            torch.as_tensor(hess), torch.ones(300), torch.ones(3),
            torch.as_tensor(ds.num_bins),
            torch.as_tensor(ds.missing_types == 2),
            torch.as_tensor(ds.is_categorical), num_leaves=7, max_depth=-1,
            hp=SplitHyperParams(), bmax=int(ds.num_bins.max()),
            hist_backend="auto")


# ---------------------------------------------------------------------------
# resolution of hist_backend and the autotune
# ---------------------------------------------------------------------------

def _gbdt(**params):
    r = np.random.RandomState(3)
    X = r.randn(300, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    p = dict({"objective": "binary", "num_leaves": 255, "max_bin": 31,
              "verbosity": -1, "min_data_in_leaf": 5, "device_type": "cpu",
              "use_quantized_grad": True}, **params)
    return lgt.Booster(p, lgt.Dataset(X, label=y, params=p)).gbdt


class _FakeCard:
    type = "cuda"


@pytest.mark.parametrize("params,autotunes", [
    ({}, True),
    ({"use_quantized_grad": False}, False),
    ({"hist_autotune": False}, False),
    ({"hist_backend": "scatter"}, False),
    ({"hist_backend": "mxu"}, False),
], ids=["quantized", "exact", "autotune_off", "pinned_scatter",
        "pinned_mxu"])
def test_resolved_hist_backend_rules(params, autotunes, monkeypatch):
    calls = []

    def fake_autotune(bins, **kw):
        calls.append(kw)
        return "pallas", {"mxu": 2.0, "pallas": 1.0}
    monkeypatch.setattr(torch_gbdt, "autotune_hist_backend", fake_autotune)
    g = _gbdt(**params)
    g.device = _FakeCard()        # the rules, not a launch: no tensor moves
    hb = g._resolved_hist_backend()
    if autotunes:
        # the JAX package's s_rep: the kernel cap of 255 x 2 + 1 slots
        assert calls == [dict(num_slots=263, bmax=g.bmax, num_features=0,
                              quantized=True, const_hess=0.0)]
        assert hb == "pallas"
        assert g._hist_autotune == {"choice": "pallas", "autotuned": True,
                                    "timings_ms": {"mxu": 2.0,
                                                   "pallas": 1.0}}
    else:
        want = params.get("hist_backend", "mxu")
        assert not calls and hb == want
        assert g._hist_autotune == {"choice": want, "autotuned": False,
                                    "timings_ms": {}}
    g.device = torch.device("cpu")
    assert g._resolved_hist_backend() == hb          # pinned for the run


def test_auto_pins_mxu_on_cpu():
    g = _gbdt()
    assert g._resolved_hist_backend() == "mxu"
    assert g._hist_autotune == {"choice": "mxu", "autotuned": False,
                                "timings_ms": {}}


def test_autotune_times_both_backends():
    bins = torch.as_tensor(np.random.RandomState(0).randint(
        0, 15, size=(512, 4)).astype(np.uint8))
    choice, timings = torch_grower.autotune_hist_backend(
        bins, num_slots=4, bmax=15)
    assert set(timings) == {"mxu", "pallas"}
    assert all(np.isfinite(t) and t >= 0 for t in timings.values())
    assert choice == min(timings, key=timings.get)


def test_autotune_all_failures_fall_back_to_mxu(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no kernel")
    monkeypatch.setattr(torch_grower, "build_histograms_auto", boom)
    monkeypatch.setattr(torch_grower, "build_histograms_scatter", boom)
    bins = torch.zeros((256, 4), dtype=torch.uint8)
    choice, timings = torch_grower.autotune_hist_backend(
        bins, num_slots=4, bmax=15)
    assert choice == "mxu"
    assert timings == {"mxu": float("inf"), "pallas": float("inf")}


def test_autotune_failing_backend_loses(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no kernel")
    monkeypatch.setattr(torch_grower, "build_histograms_auto", boom)
    bins = torch.zeros((256, 4), dtype=torch.uint8)
    choice, timings = torch_grower.autotune_hist_backend(
        bins, num_slots=4, bmax=15)
    assert choice == "pallas" and timings["mxu"] == float("inf")


# ---------------------------------------------------------------------------
# booster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_quantized_model_text_byte_equal_across_backends(objective):
    r = np.random.RandomState(7)
    X = r.randn(1500, 6).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32) \
        if objective == "binary" else \
        (X[:, 0] + 0.3 * r.randn(1500)).astype(np.float32)
    texts = {}
    for hb in ("mxu", "pallas", "scatter", "auto"):
        p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
             "verbosity": -1, "device_type": "cpu",
             "use_quantized_grad": True, "hist_backend": hb}
        b = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
        assert b.gbdt._hist_backend == ("mxu" if hb == "auto" else hb)
        texts[hb] = strip_backend_echo(b.model_to_string())
    assert len(set(texts.values())) == 1
    assert texts["mxu"].count("Tree=") == 3


def test_pallas_booster_matches_jax_package():
    from tests.test_torch_train import (_assert_same_model, _jax_booster,
                                        _torch_booster)
    r = np.random.RandomState(21)
    n = 2048
    X = r.randn(n, 6).astype(np.float32)
    # dyadic labels: the first tree's gradients are exact in f32
    y = (np.round((2 * X[:, 0] + X[:, 1] ** 2) * 8) / 8).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "hist_backend": "pallas"}
    b_jax = _jax_booster(X, y, params, 2)
    b_torch = _torch_booster(X, y, params, 2)
    assert b_jax.gbdt._resolved_hist_backend() == "pallas"
    assert b_torch.gbdt._hist_backend == "pallas"
    _assert_same_model(b_jax.model_to_string(), b_torch.model_to_string())
