"""4-bit packed bin storage in the port against the JAX package, on the CPU.

pack_bins_4bit's split-nibble layout (feature j < ceil(F/2) in byte j's low
nibble, the rest in the high nibbles) must give the JAX package's bytes;
the routing and histogram kernels read it in their packed mode (the JAX
kernels in Pallas interpret mode, the port's wrappers their plain
versions): routing and quantized sums identical, exact sums within the bar
of test_torch_kernels.py. Packed storage grows the same trees as unpacked
storage, in the port and in the JAX grower, and the booster packs exactly
where the JAX package does and writes the same model text either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from lightgbm_tpu_torch.utils.log import Log
from tests.test_torch_hist_backends import strip_backend_echo
from tests.test_torch_kernels import (M1, M_PAD, N, NUM_SLOTS,
                                      _assert_hist_close, _t, _torch_tables)
from tests.test_torch_quantized import (_dyadic_problem, _quantized_channels,
                                        _same_bits)
from tests.test_torch_one_thread import one_thread  # noqa: F401

BMAX4 = 16


def _inputs4(seed, f):
    """test_torch_kernels._inputs's pass at nibble width: bins < 16 (the
    NaN bin and bin 15 among them), split tables over f features."""
    r = np.random.RandomState(seed)
    num_bins = r.randint(4, BMAX4 + 1, f).astype(np.int32)
    num_bins[0] = BMAX4
    missing_is_nan = np.zeros(f, bool)
    missing_is_nan[[1, f - 1]] = True
    is_cat = np.zeros(f, bool)
    is_cat[2] = True
    bins = (r.rand(N, f) * num_bins).astype(np.uint8)
    bins[r.rand(N) < 0.2, 0] = 15                       # top nibble value
    split = r.rand(M1) < 0.6
    split[M1 - 1] = False
    feat = r.randint(0, f, M1).astype(np.int32)
    feat[:40] = f - 1                                   # a high-nibble feature
    thr = (r.rand(M1) * (num_bins[feat] - 1)).astype(np.int32)
    cat_bitset = r.randint(0, 2 ** 16, (M1, 1)).astype(np.uint32)
    cat_bitset[~is_cat[feat]] = 0
    return dict(num_bins=num_bins, missing_is_nan=missing_is_nan, bins=bins,
                split=split, feat=feat, is_cat=is_cat[feat], thr=thr,
                default_left=r.rand(M1) < 0.5,
                child_l=r.randint(0, M1, M1).astype(np.int32),
                child_r=r.randint(0, M1, M1).astype(np.int32),
                slot_of_node=r.randint(-1, NUM_SLOTS + 4, M1)
                .astype(np.int32), cat_bitset=cat_bitset,
                row_node=r.randint(0, M1, N).astype(np.int32),
                grad=r.randn(N).astype(np.float32),
                hess=r.uniform(0.1, 1.0, N).astype(np.float32),
                cnt=np.ones(N, np.float32))


def _jax_tables4(d):
    tbl, member = jax_k.pack_route_tables(
        jnp.asarray(d["split"]), jnp.asarray(d["feat"]),
        jnp.asarray(d["thr"]), jnp.asarray(d["default_left"]),
        jnp.asarray(d["is_cat"]), jnp.asarray(d["child_l"]),
        jnp.asarray(d["child_r"]), jnp.asarray(d["slot_of_node"]),
        jnp.asarray(d["cat_bitset"]), M_PAD, BMAX4)
    feat_tbl = jnp.stack([jnp.asarray(d["num_bins"], jnp.float32),
                          jnp.asarray(d["missing_is_nan"], jnp.float32)],
                         axis=1)
    return tbl, member, feat_tbl


# ---------------------------------------------------------------------------
# pack_bins_4bit / unpack_bins_4bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [1, 2, 6, 7, 8, 28])
def test_pack_bins_matches_jax_bytes(f):
    bins = np.random.RandomState(f).randint(0, 16, (257, f)).astype(np.uint8)
    want = jax_k.pack_bins_4bit(bins)
    got = torch_k.pack_bins_4bit(bins)
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.uint8 and got.shape == (257, (f + 1) // 2)
    np.testing.assert_array_equal(got, want)
    back = torch_k.unpack_bins_4bit(_t(got), f)
    np.testing.assert_array_equal(back.numpy(), bins)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_k.unpack_bins_4bit(jnp.asarray(want),
                                                        f)))


def test_pack_bins_refuses_ids_above_15(monkeypatch):
    from lightgbm_tpu_torch.utils import log
    bins = np.zeros((32, 4), np.uint8)
    bins[7, 2] = 16
    said = []
    monkeypatch.setattr(log, "_custom_sink", said.append)
    monkeypatch.setattr(Log, "verbosity", 0)
    assert torch_k.pack_bins_4bit(bins) is None
    assert jax_k.pack_bins_4bit(bins) is None
    assert len(said) == 1 and "exceeds the 4-bit limit" in said[0]


# ---------------------------------------------------------------------------
# the packed modes of the routing and histogram kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [7, 8])
def test_packed_route_rows_matches_jax(f):
    d = _inputs4(1, f)
    packed = jax_k.pack_bins_4bit(d["bins"])
    tbl, member, feat_tbl = _jax_tables4(d)
    rn_j, rs_j, c_j = jax_k.route_rows_mxu(
        jnp.asarray(packed), jnp.asarray(d["row_node"]), tbl, member,
        feat_tbl, num_features=f, emit_counts=True, num_slots=NUM_SLOTS,
        interpret=True)
    rn_t, rs_t, c_t = torch_k.route_rows(
        _t(packed), _t(d["row_node"]), *_torch_tables(d), num_features=f,
        emit_counts=True, num_slots=NUM_SLOTS)
    _same_bits(rn_t, rn_j)
    _same_bits(rs_t, rs_j)
    _same_bits(c_t, c_j)
    # packed and unpacked plain versions agree
    un = torch_k.route_rows_ref(_t(d["bins"]), _t(d["row_node"]),
                                *_torch_tables(d), emit_counts=True,
                                num_slots=NUM_SLOTS)
    assert all(torch.equal(a, b) for a, b in zip(un, (rn_t, rs_t, c_t)))
    # the high-nibble feature decided some rows
    routed = d["split"][d["row_node"]] & (d["feat"][d["row_node"]] == f - 1)
    assert routed.any()


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["exact", "quantized"])
def test_packed_fused_route_hist_matches_jax(quantized):
    f = 7
    d = _inputs4(2, f)
    packed = jax_k.pack_bins_4bit(d["bins"])
    if quantized:
        g, h, tg, th, tc = _quantized_channels(d, 3)
    else:
        g, h = d["grad"], d["hess"]
        tg, th, tc = _t(g), _t(h), _t(d["cnt"])
    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(packed), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(d["row_node"]),
        *_jax_tables4(d), num_slots=NUM_SLOTS, bmax=BMAX4, has_cat=True,
        quantized=quantized, num_features=f, interpret=True)
    h_t, rn_t = torch_k.fused_route_hist(
        _t(packed), tg, th, tc, _t(d["row_node"]), *_torch_tables(d),
        num_slots=NUM_SLOTS, bmax=BMAX4, quantized=quantized,
        num_features=f)
    _same_bits(rn_t, rn_j)
    if quantized:
        _same_bits(h_t, h_j)
    else:
        _assert_hist_close(h_t, h_j)
    h_u, rn_u = torch_k.fused_route_hist_ref(
        _t(d["bins"]), tg, th, tc, _t(d["row_node"]), *_torch_tables(d),
        num_slots=NUM_SLOTS, bmax=BMAX4, quantized=quantized)
    assert torch.equal(h_u, h_t) and torch.equal(rn_u, rn_t)
    assert h_t[:, 0, 15, 2].sum() > 0                  # bin 15 reached


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_packed_build_histograms_match_jax(const_hess):
    f = 9
    d = _inputs4(4, f)
    packed = jax_k.pack_bins_4bit(d["bins"])
    g, h, tg, th, tc = _quantized_channels(d, 5)
    slot = np.random.RandomState(6).randint(-1, NUM_SLOTS + 2, N) \
        .astype(np.int32)
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX4, quantized=True,
              const_hess=const_hess, num_features=f)
    jargs = (jnp.asarray(packed), jnp.asarray(g), jnp.asarray(h),
             jnp.asarray(d["cnt"]), jnp.asarray(slot))
    targs = (_t(packed), tg, th, tc, _t(slot))
    # K4 (v2, packed) behind build_histograms_auto, and K7 packed
    want_v2 = jax_k.build_histograms_mxu_auto(*jargs, interpret=True, **kw)
    _same_bits(torch_k.build_histograms_auto(*targs, **kw), want_v2)
    want_k7 = jax_p.build_histograms_scatter(*jargs, interpret=True, **kw)
    _same_bits(torch_p.build_histograms_scatter(*targs, **kw), want_k7)
    # packed and unpacked plain versions agree
    unpacked = torch_k.build_histograms_ref(
        _t(d["bins"]), tg, th, tc, _t(slot), num_slots=NUM_SLOTS,
        bmax=BMAX4, quantized=True, const_hess=const_hess)
    assert torch.equal(torch_k.build_histograms_ref(*targs, **kw), unpacked)
    assert torch.equal(torch_p.build_histograms_scatter_ref(*targs, **kw),
                       unpacked)


def test_packed_exact_scatter_matches_jax():
    f = 8
    d = _inputs4(7, f)
    packed = jax_k.pack_bins_4bit(d["bins"])
    slot = np.random.RandomState(8).randint(-1, NUM_SLOTS, N) \
        .astype(np.int32)
    h_j = jax_p.build_histograms_scatter(
        jnp.asarray(packed), jnp.asarray(d["grad"]), jnp.asarray(d["hess"]),
        jnp.asarray(d["cnt"]), jnp.asarray(slot), num_slots=NUM_SLOTS,
        bmax=BMAX4, num_features=f, interpret=True)
    h_t = torch_p.build_histograms_scatter(
        _t(packed), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]), _t(slot),
        num_slots=NUM_SLOTS, bmax=BMAX4, num_features=f)
    _assert_hist_close(h_t, h_j)


def test_packed_width_is_checked():
    d = _inputs4(9, 7)
    with pytest.raises(ValueError, match="packed bins"):
        torch_k._bin_dims(_t(d["bins"][:, :3]).contiguous(), 7)


# ---------------------------------------------------------------------------
# growth on packed storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["mxu", "pallas"])
def test_packed_grower_matches_jax_and_unpacked(backend):
    n = 3000
    ds, grad, hess = _dyadic_problem(n, 7, seed=41, const_hess=False)
    # 15 bins incl. the NaN bin: nibble-wide, as max_bin 15 gives
    bins = (ds.bins.astype(np.int64) * 15 // int(ds.num_bins.max())) \
        .astype(np.uint8)
    num_bins = np.full(ds.num_features, 15, np.int32)
    packed = jax_k.pack_bins_4bit(bins)
    key = jax.random.fold_in(jax.random.PRNGKey(6), 5)
    kw = dict(num_leaves=15, max_depth=-1, overshoot=2.0, tail_split_cap=8,
              hist_subtraction=True, bmax=15, quantized_grad=True,
              hist_backend=backend)
    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(packed), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(n, jnp.float32), jnp.ones(ds.num_features, jnp.float32),
        jnp.asarray(num_bins), jnp.asarray(ds.missing_types == 2),
        jnp.asarray(ds.is_categorical), hp=JaxHP(), interpret=True,
        rng_key=key, packed4=True, **kw)
    rest = (torch.as_tensor(grad), torch.as_tensor(hess), torch.ones(n),
            torch.ones(ds.num_features), torch.as_tensor(num_bins),
            torch.as_tensor(ds.missing_types == 2),
            torch.as_tensor(ds.is_categorical))
    tkey = convert.key_from_numpy(np.asarray(key))
    t_pk, r_pk = torch_grower.grow_tree_mxu(
        _t(packed), *rest, hp=SplitHyperParams(), rng_key=tkey,
        packed4=True, **kw)
    want = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in t_jax._asdict().items()})
    nn = int(want.num_nodes)
    assert int(t_pk.num_nodes) == nn and int(t_pk.num_leaves) == 15
    _same_bits(r_pk, r_jax)
    leaf = want.is_leaf[:nn]
    for fld in ("split_feature", "left", "right", "parent", "depth",
                "is_leaf", "count"):
        _same_bits(getattr(t_pk, fld)[:nn], getattr(want, fld)[:nn])
    for fld in ("leaf_value", "sum_grad", "sum_hess"):
        _same_bits(getattr(t_pk, fld)[:nn][leaf],
                   getattr(want, fld)[:nn][leaf])
    # packed storage grows the port's unpacked tree, every field
    t_un, r_un = torch_grower.grow_tree_mxu(
        _t(bins), *rest, hp=SplitHyperParams(), rng_key=tkey, **kw)
    assert torch.equal(r_un, r_pk)
    for fld in t_un._fields:
        assert torch.equal(getattr(t_un, fld), getattr(t_pk, fld)), fld


# ---------------------------------------------------------------------------
# the booster's packing gate and model text
# ---------------------------------------------------------------------------

def _booster(max_bin, rounds=3, **params):
    r = np.random.RandomState(5)
    X = r.randn(1200, 7).astype(np.float32)
    X[r.rand(1200) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) > 0).astype(np.float32)
    p = dict({"objective": "binary", "num_leaves": 15, "max_bin": max_bin,
              "verbosity": -1, "device_type": "cpu"}, **params)
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds)


@pytest.mark.parametrize("params,packs", [
    ({"max_bin": 15}, True),
    ({"max_bin": 15, "use_quantized_grad": True}, True),
    ({"max_bin": 15, "bin_pack_4bit": False}, False),
    ({"max_bin": 63}, False),
    # 2 x 4000 slots: no growth pass fits the fused kernel
    ({"max_bin": 15, "num_leaves": 4000}, False),
], ids=["max_bin_15", "quantized", "pack_off", "max_bin_63", "wide_tree"])
def test_packing_gate_follows_jax(params, packs):
    g = _booster(rounds=0, **params).gbdt
    assert g._packed4 is packs
    assert g.bmax <= 16 or not packs
    cfg = g.config
    over = cfg.growth_overshoot if cfg.growth_overshoot >= 1.0 else 0.0
    L_g = int(np.ceil(cfg.num_leaves * over)) if over else cfg.num_leaves
    assert packs == (cfg.bin_pack_4bit and g.bmax <= 16 and jax_k.fits_v2(
        L_g + 1, 7, g.bmax, True, cfg.use_quantized_grad))
    assert g.bins.shape == ((1200, 4) if packs else (1200, 7))
    assert g.bins.dtype == torch.uint8


def _strip_packing_echo(model_str):
    return "\n".join(line for line in strip_backend_echo(model_str)
                     .splitlines() if not line.startswith("[bin_pack_4bit:"))


@pytest.mark.parametrize("params", [
    {"use_quantized_grad": True},
    {"use_quantized_grad": True, "hist_backend": "pallas"},
    {},
], ids=["quantized", "quantized_pallas", "exact"])
def test_packed_model_text_byte_equal_to_unpacked(params):
    on = _booster(15, **params)
    off = _booster(15, bin_pack_4bit=False, **params)
    assert on.gbdt._packed4 and not off.gbdt._packed4
    assert _strip_packing_echo(on.model_to_string()) == \
        _strip_packing_echo(off.model_to_string())
    np.testing.assert_allclose(on.gbdt.train_score.numpy(),
                               on.predict(_booster_X(), raw_score=True),
                               rtol=1e-5, atol=1e-5)


def _booster_X():
    r = np.random.RandomState(5)
    X = r.randn(1200, 7).astype(np.float32)
    X[r.rand(1200) < 0.05, 3] = np.nan
    return X
