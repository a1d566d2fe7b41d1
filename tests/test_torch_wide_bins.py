"""max_bin > 256 (uint16 bins) end to end, against the JAX package.

On the CPU, from numpy seeds 0-9:

- K7's plain version over uint16 bins at bmax 300 and 1024 (exact,
  single-precision and integer modes) against the JAX package's
  build_histograms_scatter in Pallas interpret mode: counts and integer
  sums equal, f32 sums within rtol 1e-4 / atol 1e-4 (the JAX kernel sums
  bf16 hi/lo channels in f32); the kernel's bin-axis limit named where it
  refuses;
- kernel V's plain version over uint16 bins (unbundled and bundled)
  against the JAX predict_binned_tree: leaf ids equal, scores within 1e-6;
- the native binning at max_bin 1023 equal to the numpy binning (mappers,
  bin bytes) and to the JAX package's;
- boosters at max_bin 1023 (the portable grower with the scatter kernel,
  and use_pallas=false; with a 2,000-row valid set), DART and RF at
  max_bin 1023, and EFB at max_bin 511 on sparse data (a uint16 bundled
  matrix), each against the JAX booster on its portable grower: tree
  structure and pred_leaf identical, raw predictions within 5e-5, the
  valid scores within 5e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import binning as jbinning
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu.learner import predict as jpredict
from lightgbm_tpu_torch import binning
from lightgbm_tpu_torch.data import BinnedDataset, Metadata
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from lightgbm_tpu_torch.learner import predict
from tests.conftest import make_binary
from tests.test_torch_grower_portable import _sparse, _sparse_raw
from tests.test_torch_predict_binned import _random_stack, _to_jax, _tree
from tests.test_torch_train import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _hist_inputs(seed, bmax, n=4000, f=5, s=11):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, bmax, (n, f)).astype(np.uint16)
    bins[:, 0] = rng.randint(bmax - 40, bmax, n)      # the top bins
    grad = rng.randn(n).astype(np.float32)
    hess = rng.uniform(0.05, 2.0, n).astype(np.float32)
    cnt = (rng.rand(n) < 0.9).astype(np.float32)
    slot = rng.randint(-1, s + 2, n).astype(np.int32)
    return bins, grad, hess, cnt, slot, s


@pytest.mark.parametrize("mode", ["exact", "single", "integer"])
@pytest.mark.parametrize("bmax", [300, 1024])
def test_scatter_uint16_matches_jax(bmax, mode):
    bins, grad, hess, cnt, slot, s = _hist_inputs(bmax, bmax)
    if mode == "integer":
        grad = np.round(grad * 30).clip(-127, 127).astype(np.float32)
        hess = np.round(hess * 50).astype(np.float32)
    kw = dict(num_slots=s, bmax=bmax, quantized=mode == "integer",
              double_prec=mode != "single")
    h_j = np.asarray(jax_p.build_histograms_scatter(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(slot), interpret=True, **kw))
    g, h = torch.as_tensor(grad), torch.as_tensor(hess)
    if mode == "integer":
        g, h = g.to(torch.int8), h.to(torch.int8)
    tb = torch.as_tensor(bins)
    assert tb.dtype == torch.uint16
    h_t = torch_p.build_histograms_scatter(
        tb, g, h, torch.as_tensor(cnt), torch.as_tensor(slot), **kw).numpy()
    assert h_t.shape == h_j.shape == (s, 5, bmax, 3)
    np.testing.assert_array_equal(h_t[..., 2], h_j[..., 2])
    if mode == "integer":
        np.testing.assert_array_equal(h_t, h_j)
    else:
        np.testing.assert_allclose(h_t[..., :2], h_j[..., :2], rtol=1e-4,
                                   atol=1e-4)
    # the top bins hold rows, and the plain versions agree bit for bit
    assert h_t[:, 0, bmax - 40:, 2].sum() > 0
    h_r = torch_k.build_histograms_ref(
        tb, g, h, torch.as_tensor(cnt), torch.as_tensor(slot), **kw)
    assert np.array_equal(h_r.numpy(), h_t)


def test_scatter_uint16_bin_limit_named():
    limit = torch_k.wide_bin_limit()
    assert (limit, torch_k.wide_bin_limit(True)) == (4266, 8533)
    bins = torch.zeros((4, 2), dtype=torch.uint16)
    ones = torch.ones(4)
    torch_k._check_hist_args(bins, ones, ones, ones, limit, False, 0,
                             wide_ok=True)
    with pytest.raises(ValueError, match="4266"):
        torch_k._check_hist_args(bins, ones, ones, ones, limit + 1, False, 0,
                                 wide_ok=True)
    # routing and the uint8 kernels refuse uint16 bins
    with pytest.raises(ValueError, match="dtype"):
        torch_k._check_hist_args(bins, ones, ones, ones, 300, False, 0)


@pytest.mark.parametrize("case", ["plain", "bundled"])
def test_predict_binned_uint16_matches_jax(case):
    rng = np.random.RandomState(4)
    n, f, bmax = 900, 6, 1000
    stack = _random_stack(rng, 3, 62, 31, f, bmax, (bmax + 31) // 32, 0.2)
    nan = np.zeros(f, bool)
    nan[[1, 4]] = True
    num_bins = np.full(f, bmax, np.int32)
    bins = rng.randint(0, bmax, (n, f)).astype(np.uint16)
    efb_t = efb_j = None
    if case == "bundled":
        ds, _, (efb_j, efb_t), bins = _sparse(5)
        num_bins = ds.num_bins.astype(np.int32)
        nan = ds.missing_types == 2
        f = len(num_bins)
        stack = _random_stack(rng, 3, 62, 31, f, int(num_bins.max()), 16,
                              0.0)
        for t in range(3):     # thresholds inside each feature's bins
            sf = stack.split_feature[t].clamp(min=0).long()
            stack.threshold_bin[t] = torch.minimum(
                stack.threshold_bin[t],
                torch.as_tensor(num_bins)[sf] - 2).clamp(min=0)
    tb, tn, tm = (torch.as_tensor(a) for a in (bins, num_bins, nan))
    assert tb.dtype == torch.uint16
    jb, jn, jm = (jnp.asarray(a) for a in (bins, num_bins, nan))
    for i in range(3):
        tree = _tree(stack, i)
        jtree = _to_jax(tree)
        got = predict.predict_binned_tree(tree, tb, tn, tm,
                                          efb=efb_t).numpy()
        want = np.asarray(jpredict.predict_binned_tree(jtree, jb, jn, jm,
                                                       efb_j))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            predict._traverse_ref(tree, tb, tn, tm, efb_t).numpy(),
            np.asarray(jpredict.leaf_node_tree(jtree, jb, jn, jm, efb_j)))
    if case == "plain":
        # the block trajectory walks the same leaves
        fin, traj = predict.stacked_score_traj(stack, torch.zeros(n), tb, tn,
                                               tm)
        want = sum(predict.predict_binned_tree(_tree(stack, i), tb, tn, tm)
                   for i in range(3))
        np.testing.assert_allclose(fin.numpy(), want.numpy(), atol=1e-6)


def test_native_binning_1023_equals_numpy_and_jax():
    rng = np.random.RandomState(9)
    X = rng.randn(12000, 4)
    X[:, 1] = np.round(X[:, 1] * 100)           # many distinct values
    X[rng.rand(12000) < 0.05, 2] = np.nan
    md = Metadata(len(X), label=np.zeros(len(X), np.float32))
    a = BinnedDataset.from_raw(X, md, max_bin=1023, native=True)
    b = BinnedDataset.from_raw(X, md, max_bin=1023, native=False)
    assert a.bins.dtype == np.uint16 and int(a.num_bins.max()) > 256
    assert [repr(m.to_dict()) for m in a.mappers] == \
        [repr(m.to_dict()) for m in b.mappers]
    assert np.array_equal(a.bins, b.bins)
    jm = jbinning.find_bin_mappers(X, max_bin=1023)
    assert [repr(m.to_dict()) for m in binning.find_bin_mappers(
        X, max_bin=1023)] == [repr(m.to_dict()) for m in jm]


def _wide_data(seed, n=3000):
    X, y = make_binary(n=n, f=6, seed=seed)
    X[np.random.RandomState(seed).rand(n) < 0.05, 3] = np.nan
    return X, y


_BOOSTERS = {
    "pallas": {},
    "scatter": {"use_pallas": False},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
    "rf": {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
}


@pytest.mark.parametrize("case", sorted(_BOOSTERS))
def test_booster_max_bin_1023_matches_jax(case):
    X, y = _wide_data(1)
    Xv, yv = _wide_data(2, n=2000)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 1023,
                   "verbosity": -1, "metric": "binary_logloss"},
                  **_BOOSTERS[case])
    dj = lgb.Dataset(X, label=y, params=params)
    jbst = lgb.Booster(dict(params, pipeline=False), dj)
    jbst.add_valid(lgb.Dataset(Xv, label=yv, reference=dj), "v")
    assert jbst.gbdt._hist_impl == "scatter"
    for _ in range(4):
        jbst.update()
    p = dict(params, device_type="cpu")
    dt = lgt.Dataset(X, label=y, params=p)
    bst = lgt.Booster(p, dt)
    bst.add_valid(lgt.Dataset(Xv, label=yv, reference=dt), "v")
    for _ in range(4):
        bst.update()
    g = bst.gbdt
    assert g.bins.dtype == torch.uint16 and g.valid_bins[0].dtype == \
        torch.uint16 and g.bmax > 256
    assert g._hist_impl == ("scatter" if case == "scatter" else "pallas")
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  jbst.predict(X, pred_leaf=True))
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jbst.predict(X, raw_score=True), rtol=1e-5,
                               atol=5e-5)
    np.testing.assert_allclose(
        g._valid_score_host(0), np.asarray(jbst.gbdt.valid_scores[0]),
        rtol=1e-5, atol=5e-5)
    assert np.isfinite(g.eval_valid(0)["binary_logloss"])


def test_booster_efb_max_bin_511_matches_jax():
    """Sparse data at max_bin 511: both packages bundle, the bundled
    matrix is uint16 (the dense features keep 511-bin columns) and both
    grow on the portable grower with the segment sums (the JAX package's
    choice under EFB)."""
    Xs, y = _sparse_raw(2, n=2500)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 511,
              "verbosity": -1, "min_gain_to_split": 1e-3}
    jbst = lgb.Booster(dict(params, pipeline=False),
                       lgb.Dataset(Xs, label=y, params=params))
    assert jbst.gbdt._efb is not None and jbst.gbdt._hist_impl == "scatter"
    for _ in range(4):
        jbst.update()
    p = dict(params, device_type="cpu")
    bst = lgt.train(p, lgt.Dataset(Xs, label=y, params=p), 4)
    g = bst.gbdt
    assert g._efb is not None and g._hist_impl == "scatter"
    assert g.bins.dtype == torch.uint16 and g.bins.shape[1] < 26
    _assert_same_model(jbst.model_to_string(), bst.model_to_string())
    np.testing.assert_array_equal(bst.predict(Xs, pred_leaf=True),
                                  jbst.predict(Xs, pred_leaf=True))
    np.testing.assert_allclose(bst.predict(Xs, raw_score=True),
                               jbst.predict(Xs, raw_score=True), rtol=1e-5,
                               atol=5e-5)
