"""Single-precision hessians (gpu_use_dp=false) against the JAX package.

The JAX histogram kernels' double_prec=False keeps the gradient sums
hi/lo-exact and sums each row's hessian as one bf16 value
(lightgbm_tpu/learner/histogram_mxu.py _hist_channels, :221-224). The
port's plain versions round each hessian to bf16 (round to nearest even)
and sum the fixed-point values exactly. Held here, on the CPU, with the
JAX kernels in Pallas interpret mode and inputs from numpy seeds 0-7:

- K1 (fused_route_hist), K3/K4 (build_histograms, the JAX v1 and v2
  kernels) and K7 (build_histograms_scatter): counts equal, gradient and
  hessian cells within rtol 1e-4 / atol 1e-4 (the JAX cells are f32 sums
  of bf16 operands), and the hessian cells equal to a numpy rule (the
  float64 sum of the bf16-rounded hessians, rounded to f32 once);
- fits_v2 at 4 channels, as the JAX function's;
- boosters with gpu_use_dp=false (the JAX booster pinned to its MXU path
  in interpret mode): binary, a weighted L2 (user weights turn the
  constant-hessian gate off, so the mode is live), and binary on the
  port's segment-sum backend (hist_backend=scatter), structure and
  pred_leaf identical, raw predictions within 5e-5 — with the JAX
  grower handed bf16-rounded hessians (test-side, the package unchanged;
  idempotent for its histograms), because the port repairs ROADMAP C15:
  the JAX package's root sums the unrounded hessians, its histograms the
  rounded ones, and the larger siblings (parent minus smaller) carry the
  difference down; the port's root sums the rounded ones;
- C15 pinned: on hessians that bf16 rounds one way the JAX booster's
  growth call gives leaf hessian sums that part from their rows' rounded
  sums; the port's equal them (each node's sum is its rows'), on the
  kernel backends and the segment sums;
- train and update_batch byte-equal to update() with gpu_use_dp=false.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from tests.conftest import make_binary, make_regression
from tests.test_torch_kernels import (BMAX, NUM_SLOTS, _inputs, _jax_tables,
                                      _t, _torch_tables)
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _assert_single_hist(h_torch, h_jax, d, slot):
    h_t, h_j = h_torch.numpy(), np.asarray(h_jax)
    np.testing.assert_array_equal(h_t[..., 2], h_j[..., 2])
    np.testing.assert_allclose(h_t[..., :2], h_j[..., :2], rtol=1e-4,
                               atol=1e-4)
    # the hessian cells: each row's bf16-rounded hessian, summed exactly
    h16 = torch.as_tensor(d["hess"]).to(torch.bfloat16).float().numpy()
    want = np.zeros(h_t.shape[:3])
    live = (slot >= 0) & (slot < h_t.shape[0])
    for j in range(h_t.shape[1]):
        np.add.at(want, (slot[live], j, d["bins"][live, j].astype(np.int64)),
                  h16[live].astype(np.float64))
    np.testing.assert_array_equal(h_t[..., 1], want.astype(np.float32))


def test_build_histograms_single_prec_matches_jax_v1_and_v2():
    d = _inputs(1)
    slot = np.random.RandomState(5).randint(
        -1, NUM_SLOTS + 3, len(d["grad"])).astype(np.int32)
    args = [jnp.asarray(d[k]) for k in ("bins", "grad", "hess", "cnt")]
    h_t = torch_k.build_histograms(
        _t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]),
        _t(slot), num_slots=NUM_SLOTS, bmax=BMAX, double_prec=False)
    for fn in (jax_k.build_histograms_mxu, jax_k.build_histograms_mxu_v2):
        h_j = fn(*args, jnp.asarray(slot), num_slots=NUM_SLOTS, bmax=BMAX,
                 double_prec=False, interpret=True)
        _assert_single_hist(h_t, h_j, d, slot)
    # the mode is live: full-precision hessian sums differ
    h_dp = torch_k.build_histograms(
        _t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]),
        _t(slot), num_slots=NUM_SLOTS, bmax=BMAX)
    assert not torch.equal(h_dp[..., 1], h_t[..., 1])
    assert torch.equal(h_dp[..., 0], h_t[..., 0])
    assert torch.equal(h_dp[..., 2], h_t[..., 2])


def test_fused_route_hist_single_prec_matches_jax():
    d = _inputs(2)
    tbl, member, feat_tbl = _jax_tables(d)
    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["grad"]),
        jnp.asarray(d["hess"]), jnp.asarray(d["cnt"]),
        jnp.asarray(d["row_node"]), tbl, member, feat_tbl,
        num_slots=NUM_SLOTS, bmax=BMAX, has_cat=True, double_prec=False,
        interpret=True)
    h_t, rn_t = torch_k.fused_route_hist(
        _t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]),
        _t(d["row_node"]), *_torch_tables(d), num_slots=NUM_SLOTS,
        bmax=BMAX, double_prec=False)
    np.testing.assert_array_equal(rn_t.numpy(), np.asarray(rn_j))
    _, slot = torch_k.route_rows(_t(d["bins"]), _t(d["row_node"]),
                                 *_torch_tables(d))
    _assert_single_hist(h_t, h_j, d, slot.numpy())


@pytest.mark.parametrize("packed", [False, True])
def test_scatter_single_prec_matches_jax(packed):
    rng = np.random.RandomState(6)
    n, f, bmax, s = 3000, 5, 15, 9
    bins = rng.randint(0, bmax, (n, f)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.uniform(0.05, 2.0, n).astype(np.float32)
    cnt = np.ones(n, np.float32)
    slot = rng.randint(-1, s + 2, n).astype(np.int32)
    stored = torch_k.pack_bins_4bit(bins) if packed else bins
    nf = f if packed else 0
    h_j = jax_p.build_histograms_scatter(
        jnp.asarray(stored), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(slot), num_slots=s, bmax=bmax,
        num_features=nf, double_prec=False, interpret=True)
    h_t = torch_p.build_histograms_scatter(
        _t(stored), _t(grad), _t(hess), _t(cnt), _t(slot), num_slots=s,
        bmax=bmax, num_features=nf, double_prec=False)
    _assert_single_hist(h_t, h_j, dict(bins=bins, hess=hess), slot)
    # the plain versions agree bit for bit
    h_r = torch_k.build_histograms_ref(
        _t(stored), _t(grad), _t(hess), _t(cnt), _t(slot), num_slots=s,
        bmax=bmax, num_features=nf, double_prec=False)
    assert torch.equal(h_t, h_r)


def test_single_prec_ignored_where_jax_ignores_it():
    """Quantized and constant-hessian modes take no rounding (the JAX
    package's _hist_channels drops to 3 or 2 channels there)."""
    d = _inputs(3)
    slot = _t(np.random.RandomState(7).randint(-1, NUM_SLOTS, len(d["grad"]))
              .astype(np.int32))
    b, g, h, c = (_t(d[k]) for k in ("bins", "grad", "hess", "cnt"))
    for kw in (dict(const_hess=1.0), dict(quantized=True)):
        if "quantized" in kw:
            g = torch.round(g * 30).clamp(-127, 127)
            h = torch.round(h * 100)
        one = torch_k.build_histograms(b, g, h, c, slot, num_slots=NUM_SLOTS,
                                       bmax=BMAX, **kw)
        two = torch_k.build_histograms(b, g, h, c, slot, num_slots=NUM_SLOTS,
                                       bmax=BMAX, double_prec=False, **kw)
        assert torch.equal(one, two)


def test_fits_v2_four_channels_match_jax():
    from lightgbm_tpu.learner.histogram_mxu import fits_v2
    for s in (2, 24, 72, 136, 200, 263, 300, 511):
        for dp in (True, False):
            for ch in (0.0, 1.0):
                rb = torch_k.fused_row_block(s, 28, 256, ch, double_prec=dp)
                assert torch_k.fits_v2(s, 28, 256, row_block=rb,
                                       const_hess=ch, double_prec=dp) == \
                    fits_v2(s, 28, 256, dp, False, row_block=rb,
                            const_hess=ch)
    # 4 channels fit a wider frontier than 5: the 511-slot fix-up passes
    # take the fused kernel at the 2048-row block
    assert torch_k.fits_v2(511, 28, 256, row_block=2048, double_prec=False)
    assert not torch_k.fits_v2(511, 28, 256, row_block=2048)


@pytest.fixture
def jax_rounded_hessians(monkeypatch):
    """The JAX booster's MXU grower handed bf16-rounded hessians where it
    runs the single-precision mode: its histograms take the same values,
    and its root sums them too (ROADMAP C15)."""
    import lightgbm_tpu.learner.grower_mxu as jax_grower
    grow = jax_grower.grow_tree_mxu

    def rounded(bins, grad, hess, *args, **kw):
        if not kw.get("hist_double_prec", True):
            hess = hess.astype(jnp.bfloat16).astype(jnp.float32)
        return grow(bins, grad, hess, *args, **kw)
    monkeypatch.setattr(jax_grower, "grow_tree_mxu", rounded)


def _boosters(X, y, params, weight=None, rounds=5):
    # the JAX booster on its MXU kernels whatever the port's backend: with
    # rounded hessians they sum what its segment sums would, and the
    # binary cases share one interpret compile
    jp = {k: v for k, v in params.items() if k != "hist_backend"}
    jbst = lgb.Booster(dict(jp, pipeline=False),
                       lgb.Dataset(X, label=y, weight=weight, params=jp))
    g = jbst.gbdt
    g._hist_impl = "mxu"           # the TPU growth path ...
    g._mxu_interpret = True        # ... in Pallas interpret mode
    for _ in range(rounds):
        jbst.update()
    p = dict(params, device_type="cpu")
    bst = lgt.train(p, lgt.Dataset(X, label=y, weight=weight, params=p),
                    rounds)
    return jbst, bst


@pytest.mark.parametrize("objective",
                         ["binary", "weighted_l2", "binary_scatter"])
def test_booster_single_prec_matches_jax(objective, jax_rounded_hessians):
    params = {"num_leaves": 15, "max_bin": 63, "verbosity": -1,
              "gpu_use_dp": False}
    if objective == "binary_scatter":
        # the port's segment-sum backend sums the rounded hessians too
        params["hist_backend"] = "scatter"
    weight = None
    if objective.startswith("binary"):
        X, y = make_binary(n=2500, f=6)
        params["objective"] = "binary"
    else:
        X, y = make_regression(n=2500, f=6)
        params["objective"] = "regression"
        weight = np.random.RandomState(3).uniform(0.5, 2.0, len(y))
    jbst, bst = _boosters(X, y, params, weight)
    assert bst.gbdt._hist_impl == "mxu"
    assert bst.gbdt._resolved_hist_backend() == \
        params.get("hist_backend", "mxu")
    assert bst.gbdt._const_hessian() == 0.0
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  jbst.predict(X, pred_leaf=True))
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jbst.predict(X, raw_score=True), rtol=1e-5,
                               atol=5e-5)
    # the mode is live: full precision grows other leaf values
    dp = lgt.train(dict(params, gpu_use_dp=True, device_type="cpu"),
                   lgt.Dataset(X, label=y, weight=weight), 5)
    assert dp.model_to_string() != bst.model_to_string()


def test_train_and_update_batch_equal_update_single_prec():
    X, y = make_binary(n=2000, f=6)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "device_type": "cpu", "gpu_use_dp": False, "fused_block_size": 4}
    ds = lgt.Dataset(X, label=y, params=p).construct()
    stepped = lgt.Booster(p, ds)
    for _ in range(9):
        stepped.update()
    trained = lgt.train(p, ds, 9)
    batched = lgt.Booster(p, ds)
    batched.update_batch(5)
    batched.update_batch(4)
    assert trained.gbdt.fused_stats and batched.gbdt.fused_stats
    text = stepped.model_to_string()
    assert trained.model_to_string() == text
    assert batched.model_to_string() == text


def test_c15_root_sums_the_rounded_hessians():
    """ROADMAP C15, pinned: hessians in a narrow band just below 0.25,
    which bf16 rounds up to 0.25, through the JAX booster's own growth
    call (the binary booster test's data and params, so its interpret
    compile is shared). The JAX grower's root sums them unrounded, so the
    larger siblings carry the whole difference down the tree (leaf
    hessian sums off their rows' by more than a tenth of a row's hessian
    here); in the port every node sums its rows' rounded hessians (within
    f32 rounding of the sums), on the kernel backends and on the segment
    sums alike."""
    from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
    from lightgbm_tpu_torch.learner.split import SplitHyperParams
    X, y = make_binary(n=2500, f=6)
    params = {"num_leaves": 15, "max_bin": 63, "verbosity": -1,
              "gpu_use_dp": False, "objective": "binary"}
    g = lgb.Booster(dict(params, pipeline=False),
                    lgb.Dataset(X, label=y, params=params)).gbdt
    g._hist_impl = "mxu"
    g._mxu_interpret = True
    p = (0.5 + 0.02 * np.tanh(X[:, 0])).astype(np.float32)
    grad, hess = p - y, p * (1.0 - p)
    h16 = torch.as_tensor(hess).to(torch.bfloat16).double().numpy()
    assert 0.2495 < hess.min() and (h16 == 0.25).all()
    gj, hj, cnt = g._bagging(jnp.asarray(grad), jnp.asarray(hess))
    t_j, r_j = g._grow(gj, hj, cnt, g._feature_mask())

    def leaf_gap(sum_hess, row_node):
        rows = np.zeros(len(sum_hess))
        np.add.at(rows, row_node, h16)
        leaf = np.bincount(row_node, minlength=len(sum_hess)) > 0
        return np.abs(np.asarray(sum_hess, np.float64)[leaf] -
                      rows[leaf]).max()
    assert leaf_gap(np.asarray(t_j.sum_hess), np.asarray(r_j)) > 0.025
    n, f = X.shape
    for backend in ("mxu", "scatter"):
        t_t, r_t = torch_grower.grow_tree_mxu(
            torch.as_tensor(np.array(g.bins)), torch.as_tensor(grad),
            torch.as_tensor(hess), torch.ones(n), torch.ones(f),
            torch.as_tensor(np.array(g.num_bins_d)).to(torch.int32),
            torch.as_tensor(np.array(g.missing_is_nan_d)),
            torch.as_tensor(np.array(g.is_cat_d)),
            hp=SplitHyperParams(), num_leaves=15, max_depth=-1,
            bmax=g.bmax, hist_double_prec=False, hist_backend=backend)
        assert int(t_t.num_leaves) == 15
        assert leaf_gap(t_t.sum_hess.numpy(),
                        r_t.numpy().astype(np.int64)) < 1e-3, backend
