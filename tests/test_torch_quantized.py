"""Quantized-gradient training in the port against the JAX package.

The counter-based generator (lightgbm_tpu_torch.rng) must give jax.random's
bits, so that both packages quantize the same gradients to the same
integers under the same key. Integer histogram sums are exact, so the
quantized histograms and node sums are held bit for bit, and so are the
quantized grower's row routing, tree structure and exactly refit leaves —
on dyadic gradients, whose f32 sums (the fold-in of sum(grad) into each
tree's key, the refit's node sums) come out the same in any order. The
split scan's prefix sums over the scaled histograms are not integers: XLA
on the CPU takes them as an associative scan, torch as a running sum, so
internal nodes' values and gains agree to f32 rounding, and a threshold
may land on the other side of bins that none of the node's rows occupy
(two tied candidates). The JAX kernels run in Pallas interpret mode, the
port's wrappers their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.data import BinnedDataset, Metadata
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu_torch import convert, rng
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.test_torch_kernels import (BMAX, N, NUM_SLOTS, _inputs,
                                      _jax_tables, _torch_tables)
from tests.test_torch_train import _jax_booster, _torch_booster, _trees
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _words(a):
    """A key or f32 array as integer words, for exact comparison."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else \
        a.astype(np.int64)


def _same_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_words(got), _words(want))


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 6, 2 ** 31 - 1])
def test_prng_key_matches_jax(seed):
    _same_bits(rng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [7, 6271, -5.25],
                         ids=["7", "6271", "bitcast_negative_f32"])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(6)
    if isinstance(data, float):
        # the grower folds in the bits of an f32 sum: negative as int32
        j_data = jax.lax.bitcast_convert_type(jnp.float32(data), jnp.int32)
        t_data = torch.tensor(data, dtype=torch.float32).view(torch.int32)
        assert int(t_data) < 0
    else:
        j_data = t_data = data
    _same_bits(rng.fold_in(rng.PRNGKey(6), t_data),
               jax.random.fold_in(key, j_data))


def test_split_matches_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(6), 3)
    _same_bits(rng.split(convert.key_from_numpy(np.asarray(key))),
               jax.random.split(key))


@pytest.mark.parametrize("n", [1, 1000, 2049])
def test_uniform_matches_jax(n):
    key = jax.random.PRNGKey(11)
    got = rng.uniform(convert.key_from_numpy(np.asarray(key)), n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    _same_bits(got, jax.random.uniform(key, (n,)))


def test_key_from_numpy_round_trips_top_bit():
    key = np.array([0xFFFFFFFF, 0x80000001], np.uint32)
    t = convert.key_from_numpy(key)
    assert t.dtype == torch.int64 and t.tolist() == [0xFFFFFFFF, 0x80000001]


# ---------------------------------------------------------------------------
# quantize_gradients and the integer-mode histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_hess", [True, False])
def test_quantize_gradients_matches_jax(with_hess):
    r = np.random.RandomState(3)
    grad = (r.randn(20001) * 3).astype(np.float32)
    hess = r.uniform(0.01, 0.25, 20001).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(6), 6271)
    jg, jh, jgs, jhs = jax_k.quantize_gradients(
        jnp.asarray(grad), jnp.asarray(hess) if with_hess else None, key)
    tg, th, tgs, ths = torch_k.quantize_gradients(
        torch.as_tensor(grad), torch.as_tensor(hess) if with_hess else None,
        convert.key_from_numpy(np.asarray(key)))
    _same_bits(tg, jg)
    _same_bits(tgs, jgs)
    _same_bits(ths, jhs)
    assert np.abs(tg.numpy()).max() == 127
    if with_hess:
        _same_bits(th, jh)
    else:
        assert th is None and jh is None


def _quantized_channels(d, seed):
    """Integer gradients in [-127, 127] (f32 for JAX, int8 for the port)."""
    r = np.random.RandomState(seed)
    g = r.randint(-127, 128, N).astype(np.float32)
    h = r.randint(0, 128, N).astype(np.float32)
    return g, h, torch.as_tensor(g).to(torch.int8), \
        torch.as_tensor(h).to(torch.int8), torch.as_tensor(d["cnt"])


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_quantized_build_histograms_matches_jax_bit_for_bit(const_hess):
    d = _inputs(1)
    g, h, tg, th, tc = _quantized_channels(d, 8)
    slot = np.random.RandomState(5).randint(-1, NUM_SLOTS + 3, N) \
        .astype(np.int32)
    h_j = jax_k.build_histograms_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(slot), num_slots=NUM_SLOTS,
        bmax=BMAX, quantized=True, const_hess=const_hess, interpret=True)
    h_t = torch_k.build_histograms(
        torch.as_tensor(d["bins"]), tg, th, tc, torch.as_tensor(slot),
        num_slots=NUM_SLOTS, bmax=BMAX, const_hess=const_hess,
        quantized=True)
    assert h_t.dtype == torch.float32
    _same_bits(h_t, h_j)
    assert np.abs(h_t[..., 0].numpy()).max() > 127     # real sums, not rows


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_quantized_fused_route_hist_matches_jax_bit_for_bit(const_hess):
    d = _inputs(2)
    g, h, tg, th, tc = _quantized_channels(d, 9)
    tbl, member, feat_tbl = _jax_tables(d)
    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(d["row_node"]), tbl, member,
        feat_tbl, num_slots=NUM_SLOTS, bmax=BMAX, has_cat=True,
        quantized=True, const_hess=const_hess, interpret=True)
    h_t, rn_t = torch_k.fused_route_hist(
        torch.as_tensor(d["bins"]), tg, th, tc,
        torch.as_tensor(d["row_node"]), *_torch_tables(d),
        num_slots=NUM_SLOTS, bmax=BMAX, const_hess=const_hess,
        quantized=True)
    _same_bits(rn_t, rn_j)
    _same_bits(h_t, h_j)
    assert h_t[..., 2].sum() > 0


def test_fused_fits_mirrors_fits_v2():
    from lightgbm_tpu.learner.histogram_mxu import fits_v2
    for s in (2, 24, 72, 100, 136, 263, 511):
        for f in (8, 28, 200):
            for bmax in (64, 256):
                for ch in (0.0, 1.0):
                    for quant in (False, True):
                        rb = torch_k.fused_row_block(s, f, bmax, ch, quant)
                        assert torch_k.fits_v2(s, f, bmax, quant,
                                               row_block=rb,
                                               const_hess=ch) == \
                            fits_v2(s, f, bmax, True, quant, row_block=rb,
                                    const_hess=ch), (s, f, bmax, ch, quant)
    # the slice's shapes: quantized fix-ups at 1M x 28 take the fused
    # kernel; at 200 features wide frontiers take route_rows +
    # build_histograms
    assert torch_k.fits_v2(511, 28, 256, True, row_block=torch_k
                           .fused_row_block(511, 28, 256, 0.0, True))
    assert not torch_k.fits_v2(136, 200, 256, True, row_block=torch_k
                               .fused_row_block(136, 200, 256, 0.0, True))


# ---------------------------------------------------------------------------
# node_sums
# ---------------------------------------------------------------------------

def _node_sums_both(node, g, h, c, m):
    j = np.asarray(jax_k.node_sums_mxu(
        jnp.asarray(node), jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
        num_nodes=m, interpret=True))
    t = torch_k.node_sums(torch.as_tensor(node), torch.as_tensor(g),
                          torch.as_tensor(h), torch.as_tensor(c),
                          num_nodes=m)
    assert t.shape == (m, 3) and t.dtype == torch.float32
    return t.numpy(), j


def test_node_sums_matches_jax_bit_for_bit_on_dyadic_inputs():
    r = np.random.RandomState(4)
    m = 300
    node = r.randint(-3, m + 40, 9000).astype(np.int32)   # some ignored
    g = (r.randint(-512, 513, 9000) / 256).astype(np.float32)
    h = (r.randint(1, 65, 9000) / 256).astype(np.float32)
    c = (r.rand(9000) < 0.9).astype(np.float32)
    t, j = _node_sums_both(node, g, h, c, m)
    _same_bits(t, j)
    keep = (node >= 0) & (node < m)
    assert t[:, 2].sum() == keep[c > 0].sum()


def test_node_sums_matches_jax_on_random_inputs():
    r = np.random.RandomState(5)
    m = 64
    node = r.randint(-2, m + 5, 20000).astype(np.int32)
    g = r.randn(20000).astype(np.float32)
    h = r.uniform(0.01, 0.25, 20000).astype(np.float32)
    c = np.ones(20000, np.float32)
    t, j = _node_sums_both(node, g, h, c, m)
    np.testing.assert_array_equal(t[:, 2], j[:, 2])
    # the port sums in float64 and rounds once; the JAX kernel sums hi/lo
    # bf16 halves in f32, off by f32 rounding of ~300-row sums. atol covers
    # sums that cancel to near zero (|g| ~ 1 per row)
    np.testing.assert_allclose(t[:, :2], j[:, :2], rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the quantized grower
# ---------------------------------------------------------------------------

def _dyadic_problem(n, f, seed, const_hess):
    r = np.random.RandomState(seed)
    X = r.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    ds = BinnedDataset.from_raw(X, Metadata(n, label=y), max_bin=63)
    # dyadic: every partial sum is exact in f32, so sum(grad) (folded into
    # the key) and the refit's node sums are the same bits in any order
    grad = ((r.randint(-64, 65, n) + 32 * (y - 0.5)) / 64) \
        .astype(np.float32)
    hess = np.ones(n, np.float32) if const_hess else \
        (r.randint(1, 17, n) / 64).astype(np.float32)
    return ds, grad, hess


@pytest.mark.parametrize("num_leaves,n,const_hess", [
    (15, 4000, 0.0), (15, 4000, 1.0)],
    ids=["15_leaves", "15_leaves_const_hess"])
def test_quantized_grower_matches_jax_bit_for_bit(num_leaves, n, const_hess):
    _quantized_grower_case(num_leaves, n, const_hess)


def _quantized_grower_case(num_leaves, n, const_hess):
    """test_quantized_grower_matches_jax_bit_for_bit's body (its 255-leaf
    cases run in tests/test_torch_quantized_255.py, so that --dist
    loadfile spreads the JAX interpret compiles)."""
    ds, grad, hess = _dyadic_problem(n, 8, seed=num_leaves, const_hess=bool(
        const_hess))
    key = jax.random.fold_in(jax.random.PRNGKey(6), 2)
    kw = dict(num_leaves=num_leaves, max_depth=-1, overshoot=2.0,
              tail_split_cap=8, hist_subtraction=True,
              bmax=int(ds.num_bins.max()), const_hessian=const_hess,
              quantized_grad=True)
    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(n, jnp.float32), jnp.ones(ds.num_features, jnp.float32),
        jnp.asarray(ds.num_bins), jnp.asarray(ds.missing_types == 2),
        jnp.asarray(ds.is_categorical), hp=JaxHP(), interpret=True,
        rng_key=key, **kw)
    t_torch, r_torch = torch_grower.grow_tree_mxu(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(n), torch.ones(ds.num_features),
        torch.as_tensor(ds.num_bins), torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical), hp=SplitHyperParams(),
        rng_key=convert.key_from_numpy(np.asarray(key)), **kw)
    want = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in t_jax._asdict().items()})
    nn = int(want.num_nodes)
    assert int(t_torch.num_nodes) == nn
    assert int(t_torch.num_leaves) == int(want.num_leaves) == num_leaves
    _same_bits(r_torch, r_jax)

    def field(t, name):
        return getattr(t, name)[:nn].numpy()

    for fld in ("split_feature", "left", "right", "parent", "depth",
                "is_leaf", "is_cat", "default_left", "cat_bitset", "count"):
        _same_bits(field(t_torch, fld), field(want, fld))
    leaf = field(want, "is_leaf")
    # the exact refit: leaf values and sums bit for bit, and the sums are
    # the leaf rows' own
    for fld in ("leaf_value", "sum_grad", "sum_hess"):
        _same_bits(field(t_torch, fld)[leaf], field(want, fld)[leaf])
    exact = np.zeros(nn)
    np.add.at(exact, r_torch.numpy(), grad.astype(np.float64))
    _same_bits(field(t_torch, "sum_grad")[leaf],
               exact[leaf].astype(np.float32))
    # internal nodes: split-scan prefix sums, f32 rounding apart
    for fld in ("leaf_value", "sum_grad", "sum_hess", "gain"):
        got, exp = field(t_torch, fld)[~leaf], field(want, fld)[~leaf]
        np.testing.assert_allclose(got, exp, rtol=1e-4,
                                   atol=1e-5 * np.abs(exp).max(),
                                   err_msg=fld)
    # a threshold that differs is a tie: no row of the node has a bin
    # between the two candidates
    thr_t, thr_j = field(t_torch, "threshold_bin"), field(want, "threshold_bin")
    feat, parent = field(want, "split_feature"), field(want, "parent")
    rows_leaf = r_torch.numpy()
    for node in np.nonzero(thr_t != thr_j)[0]:
        under = np.zeros(nn, bool)           # leaves in node's subtree
        for lf in np.nonzero(leaf)[0]:
            a = lf
            while a >= 0 and a != node:
                a = parent[a]
            under[lf] = a == node
        b = ds.bins[under[rows_leaf], feat[node]]
        lo, hi = sorted((thr_t[node], thr_j[node]))
        assert not ((b > lo) & (b <= hi)).any(), node


# ---------------------------------------------------------------------------
# booster
# ---------------------------------------------------------------------------

def test_quantized_booster_matches_jax_package():
    r = np.random.RandomState(21)
    n = 2048
    X = r.randn(n, 6).astype(np.float32)
    # multiples of 1/8 over 2048 rows: boost_from_average and the first
    # tree's gradients (score - label) are exact in f32
    y = (np.round((2 * X[:, 0] + X[:, 1] ** 2 + 0.5 * r.randn(n)) * 8) / 8) \
        .astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "use_quantized_grad": True}
    b_jax = _jax_booster(X, y, params, 5)
    b_torch = _torch_booster(X, y, params, 5)
    t_jax = _trees(b_jax.model_to_string())
    t_torch = _trees(b_torch.model_to_string())
    assert len(t_jax) == len(t_torch) == 5
    # tree 1: every byte of its block but the split scan's prefix-sum
    # values (see the module docstring)
    scan_keys = ("split_gain", "internal_value")
    assert {k: v for k, v in t_torch[0].items() if k not in scan_keys} == \
        {k: v for k, v in t_jax[0].items() if k not in scan_keys}
    for key in scan_keys:
        np.testing.assert_allclose(
            np.asarray(t_torch[0][key].split(" "), np.float64),
            np.asarray(t_jax[0][key].split(" "), np.float64), rtol=1e-4,
            err_msg=key)

    # later trees fold in sum(score - label), whose f32 bits depend on the
    # summation order (torch and XLA differ), so their rounding keys and
    # trees may differ; the quantization noise they see is drawn from the
    # same distribution, so their training losses agree to 1%
    def l2(b):
        return float(np.mean((b.predict(X) - y) ** 2))
    loss_jax, loss_torch = l2(b_jax), l2(b_torch)
    assert abs(loss_torch - loss_jax) <= 0.01 * loss_jax, (loss_torch,
                                                           loss_jax)
    first = float(np.mean((y - y.mean()) ** 2))
    assert loss_torch < 0.8 * first
    np.testing.assert_allclose(b_torch.gbdt.train_score.numpy(),
                               b_torch.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
