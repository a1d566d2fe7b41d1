"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
kernels run in Pallas interpret mode. Same inputs from one numpy seed:
numerical, NaN-default-left and categorical splits, node ids past 256 (the
base-256 digits of the JAX route tables), slots past the histogram's
width, const-hessian and normal channels. Routing and counts must be
identical; grad/hess sums agree to the bar tests/test_mxu_kernels.py holds
the MXU histogram to (the JAX side sums double-bf16 channels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k

N, F, BMAX = 3500, 8, 64
M1 = 600            # node ids up to 599: past the 256 of one base-256 digit
M_PAD = 640
NUM_SLOTS = 40


def _inputs(seed):
    """A random binned matrix and one pass's split tables, as numpy."""
    rng = np.random.RandomState(seed)
    num_bins = rng.randint(8, BMAX + 1, F).astype(np.int32)
    num_bins[0] = BMAX
    missing_is_nan = np.zeros(F, bool)
    missing_is_nan[[1, 3]] = True
    is_cat_feat = np.zeros(F, bool)
    is_cat_feat[[2, 5]] = True
    bins = (rng.rand(N, F) * num_bins).astype(np.uint8)
    bins[rng.rand(N) < 0.1, 1] = num_bins[1] - 1          # NaN bin rows

    split = rng.rand(M1) < 0.6
    split[M1 - 1] = False                               # scratch node
    feat = rng.randint(0, F, M1).astype(np.int32)
    feat[:16] = 1                                       # NaN feature nodes
    is_cat = is_cat_feat[feat]
    thr = (rng.rand(M1) * (num_bins[feat] - 1)).astype(np.int32)
    default_left = rng.rand(M1) < 0.5
    child_l = rng.randint(0, M1, M1).astype(np.int32)
    child_r = rng.randint(0, M1, M1).astype(np.int32)
    # slots past NUM_SLOTS are dropped by the histogram
    slot_of_node = rng.randint(-1, NUM_SLOTS + 4, M1).astype(np.int32)
    words = (BMAX + 31) // 32
    cat_bitset = rng.randint(0, 2 ** 32, (M1, words), dtype=np.uint64) \
        .astype(np.uint32)
    cat_bitset[~is_cat] = 0
    row_node = rng.randint(0, M1, N).astype(np.int32)
    grad = rng.randn(N).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, N).astype(np.float32)
    cnt = np.ones(N, np.float32)
    cnt[rng.rand(N) < 0.2] = 0.0                        # out-of-bag rows
    return dict(num_bins=num_bins, missing_is_nan=missing_is_nan,
                bins=bins, split=split, feat=feat, is_cat=is_cat, thr=thr,
                default_left=default_left, child_l=child_l, child_r=child_r,
                slot_of_node=slot_of_node, cat_bitset=cat_bitset,
                row_node=row_node, grad=grad, hess=hess, cnt=cnt)


def _jax_tables(d):
    tbl, member = jax_k.pack_route_tables(
        jnp.asarray(d["split"]), jnp.asarray(d["feat"]),
        jnp.asarray(d["thr"]), jnp.asarray(d["default_left"]),
        jnp.asarray(d["is_cat"]), jnp.asarray(d["child_l"]),
        jnp.asarray(d["child_r"]), jnp.asarray(d["slot_of_node"]),
        jnp.asarray(d["cat_bitset"]), M_PAD, BMAX)
    feat_tbl = jnp.stack([jnp.asarray(d["num_bins"], jnp.float32),
                          jnp.asarray(d["missing_is_nan"], jnp.float32)],
                         axis=1)
    return tbl, member, feat_tbl


def _torch_tables(d):
    t = {k: torch.as_tensor(v) for k, v in d.items()
         if k not in ("cat_bitset", "bins")}
    tbl, member = torch_k.pack_route_tables(
        t["split"], t["feat"], t["thr"], t["default_left"], t["is_cat"],
        t["child_l"], t["child_r"], t["slot_of_node"],
        torch.as_tensor(d["cat_bitset"].astype(np.int64)), M_PAD)
    feat_tbl = torch.stack([t["num_bins"],
                            t["missing_is_nan"].to(torch.int32)], dim=1)
    return tbl, member, feat_tbl


def _t(a):
    return torch.as_tensor(a)


def _assert_hist_close(h_torch, h_jax):
    h_torch, h_jax = h_torch.numpy(), np.asarray(h_jax)
    assert h_torch.shape == h_jax.shape
    np.testing.assert_array_equal(h_torch[..., 2], h_jax[..., 2])
    np.testing.assert_allclose(h_torch[..., :2], h_jax[..., :2],
                               rtol=1e-4, atol=1e-4)


def test_route_rows_matches_jax():
    d = _inputs(0)
    tbl, member, feat_tbl = _jax_tables(d)
    rn_j, rs_j = jax_k.route_rows_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["row_node"]), tbl, member,
        feat_tbl, interpret=True)
    rn_t, rs_t = torch_k.route_rows(_t(d["bins"]), _t(d["row_node"]),
                                    *_torch_tables(d))
    np.testing.assert_array_equal(rn_t.numpy(), np.asarray(rn_j))
    np.testing.assert_array_equal(rs_t.numpy(), np.asarray(rs_j))
    # every decision kind was exercised
    rn = d["row_node"]
    routed = d["split"][rn]
    assert (routed & d["is_cat"][rn]).any()
    assert (routed & (d["feat"][rn] == 1) &
            (d["bins"][:, 1] == d["num_bins"][1] - 1)).any()
    assert (rn > 256).any() and (rn_t.numpy() > 256).any()


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_build_histograms_matches_jax(const_hess):
    d = _inputs(1)
    slot = np.random.RandomState(5).randint(-1, NUM_SLOTS + 3, N) \
        .astype(np.int32)
    h_j = jax_k.build_histograms_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["grad"]),
        jnp.asarray(d["hess"]), jnp.asarray(d["cnt"]), jnp.asarray(slot),
        num_slots=NUM_SLOTS, bmax=BMAX, const_hess=const_hess,
        interpret=True)
    h_t = torch_k.build_histograms(
        _t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]),
        _t(slot), num_slots=NUM_SLOTS, bmax=BMAX, const_hess=const_hess)
    _assert_hist_close(h_t, h_j)


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_fused_route_hist_matches_jax(const_hess):
    d = _inputs(2)
    tbl, member, feat_tbl = _jax_tables(d)
    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["grad"]),
        jnp.asarray(d["hess"]), jnp.asarray(d["cnt"]),
        jnp.asarray(d["row_node"]), tbl, member, feat_tbl,
        num_slots=NUM_SLOTS, bmax=BMAX, has_cat=True,
        const_hess=const_hess, interpret=True)
    h_t, rn_t = torch_k.fused_route_hist(
        _t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]),
        _t(d["row_node"]), *_torch_tables(d), num_slots=NUM_SLOTS,
        bmax=BMAX, const_hess=const_hess)
    np.testing.assert_array_equal(rn_t.numpy(), np.asarray(rn_j))
    _assert_hist_close(h_t, h_j)
    assert h_t[..., 2].sum() > 0


def test_node_values_matches_jax_bit_for_bit():
    rng = np.random.RandomState(3)
    m1 = 300
    values = rng.randn(m1).astype(np.float32) * 10
    values[[3, 50, 299]] = [np.nan, np.inf, -np.inf]
    node = rng.randint(-5, m1 + 200, 4000).astype(np.int32)   # out of range
    got_j = np.asarray(jax_k.node_values_mxu(
        jnp.asarray(node), jnp.asarray(values), interpret=True))
    got_t = torch_k.node_values(_t(node), _t(values)).numpy()
    np.testing.assert_array_equal(got_t.view(np.uint32),
                                  got_j.view(np.uint32))
    assert (got_t[(node < 0) | (node >= m1)] == 0).all()
    assert np.isfinite(got_t).all()


def test_wrappers_pick_plain_version_only_on_cpu():
    d = _inputs(4)
    torch_k.reset_launch_counts()
    torch_k.route_rows(_t(d["bins"]), _t(d["row_node"]), *_torch_tables(d))
    torch_k.node_values(_t(d["row_node"]), _t(d["grad"]))
    # plain versions are not kernel launches
    assert set(torch_k.launch_counts().values()) == {0}
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        torch_k.node_values(meta, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        torch_k.node_values(_t(d["row_node"]), torch.empty(4, device="meta"))


def test_fused_branch_mirrors_reference_dispatch():
    # the slice's shape (F = 28, bmax 256): the fixup passes' 511 slots
    # take the two-kernel branch, the 263-slot bridge the fused kernel
    from lightgbm_tpu.learner.histogram_mxu import fits_v2
    for s in (2, 24, 72, 136, 263, 511):
        for ch in (0.0, 1.0):
            rb = torch_k.fused_row_block(s, 28, 256, ch)
            assert torch_k.fits_v2(s, 28, 256, row_block=rb,
                                   const_hess=ch) == \
                fits_v2(s, 28, 256, True, False, row_block=rb,
                        const_hess=ch)
    assert not torch_k.fits_v2(
        511, 28, 256, row_block=torch_k.fused_row_block(511, 28, 256, 0.0))
    assert torch_k.fits_v2(
        263, 28, 256, row_block=torch_k.fused_row_block(263, 28, 256, 0.0))


@pytest.mark.parametrize("wrapper", ["build_histograms",
                                     "build_histograms_scatter"])
def test_exact_histogram_sums_round_once(wrapper):
    # every row in one cell: f32 cells would round each add to the running
    # sum's ulp; the sums run in float64 and are rounded to f32 once
    from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
    rng = np.random.RandomState(3)
    n = 300_000
    grad = rng.randn(n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    build = getattr(torch_p if wrapper.endswith("scatter") else torch_k,
                    wrapper)
    h = build(_t(np.zeros((n, 1), np.uint8)), _t(grad), _t(hess),
              torch.ones(n), torch.zeros(n, dtype=torch.int32),
              num_slots=1, bmax=2)
    want = np.float32([grad.sum(dtype=np.float64),
                       hess.sum(dtype=np.float64), n])
    np.testing.assert_array_equal(h[0, 0, 0].numpy(), want)
    assert not h[0, 0, 1].any()
