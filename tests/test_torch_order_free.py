"""Exact-mode histogram sums are integers: order-free, the same bits from
every histogram kernel's plain version, and safe from overflow.

Every exact (f32) histogram of the port adds each value as a fixed-point
int64 under one power-of-two scale per channel (histogram_mxu.exact_scale)
and scales the integer sums back once; the card's kernels (the fused
sweep, build_histograms and the scatter kernel) compute the same integers.
These tests run the plain versions on the CPU: the scale's worst cases,
bit-equal results under a permutation of the rows and across the three
functions, non-finite inputs against the JAX package's kernels in Pallas
interpret mode, and the same trees under hist_backend mxu and pallas.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from lightgbm_tpu_torch.learner.split import (SplitHyperParams,
                                              find_best_splits)
from tests.test_torch_grower import _data
from tests.test_torch_hist_backends import strip_backend_echo
from tests.test_torch_kernels import (BMAX, N, NUM_SLOTS, _inputs,
                                      _jax_tables, _t, _torch_tables)
from tests.test_torch_one_thread import one_thread  # noqa: F401

WORD_ROWS = 4096       # rows a 32-bit word of the scatter kernel takes
LO_BITS = 20


def _bits(h):
    return h.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# the scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, WORD_ROWS, 300_000, (1 << 24) + 1])
@pytest.mark.parametrize("amax", [1.0, 0.75, 3.7e3, 1e-30, 2.0 ** -149,
                                  3.4e38])
def test_exact_scale_worst_case_cannot_overflow(n, amax):
    # every row at +-amax in one cell: the int64 sum, and the scatter
    # kernel's two 32-bit words over WORD_ROWS rows, stay in range
    v = torch.tensor([amax], dtype=torch.float32).expand(n)
    k = torch_k.exact_scale(v, v, v)
    assert k.dtype == torch.int32 and k.shape == (3,)
    assert len(set(k.tolist())) == 1
    k = int(k[0])
    bits = min(torch_k.EXACT_BITS, 62 - (n - 1).bit_length())
    q = round(float(np.float32(amax)) * 2.0 ** k)    # exact, half to even
    assert 2 ** (bits - 1) <= q <= 2 ** bits         # no bit wasted
    for sign in (1, -1):
        qs = sign * q
        assert -2 ** 63 <= n * qs < 2 ** 63
        lo, hi = qs & ((1 << LO_BITS) - 1), qs >> LO_BITS
        assert lo == 0 or WORD_ROWS * lo < 2 ** 32
        assert -2 ** 31 <= WORD_ROWS * hi < 2 ** 31
        assert hi * 2 ** LO_BITS + lo == qs


@pytest.mark.parametrize("n", [WORD_ROWS, 300_000])
@pytest.mark.parametrize("amax", [3.7e3, 2.0 ** -149, 3.4e38])
def test_every_row_in_one_cell_sums_exactly(n, amax):
    # one cell takes every row at -amax: the sum is n x amax exactly (f32
    # of it), through the per-row histogram and the scatter runs' partials
    grad = torch.full((n,), -amax, dtype=torch.float32)
    hess = torch.full((n,), amax, dtype=torch.float32)
    args = (torch.zeros((n, 1), dtype=torch.uint8), grad, hess,
            torch.ones(n), torch.zeros(n, dtype=torch.int32))
    with np.errstate(over="ignore"):          # 3.4e38 x n: +-inf in f32
        want = np.float32([-n * float(np.float32(amax)),
                           n * float(np.float32(amax)), n])
    for h in (torch_k.build_histograms_ref(*args, num_slots=1, bmax=2),
              torch_p.build_histograms_scatter_ref(*args, num_slots=1,
                                                   bmax=2)):
        np.testing.assert_array_equal(h[0, 0, 0].numpy(), want)
        assert not h[0, 0, 1].any()


def test_pow2_is_exact():
    k = torch.arange(-300, 301, dtype=torch.int32)
    got = torch_k._pow2(k).tolist()
    assert got == [math.ldexp(1.0, int(e)) for e in k]


@pytest.mark.parametrize("bad", [float("nan"), float("inf"),
                                 float("-inf")])
def test_exact_scale_marks_non_finite_channels(bad):
    g = torch.randn(100)
    h = torch.rand(100)
    h[17] = bad
    k = torch_k.exact_scale(g, h, torch.ones(100))
    assert int(k[1]) == torch_k.NONFINITE_K
    assert int(k[0]) != torch_k.NONFINITE_K and int(k[2]) == \
        torch_k.EXACT_BITS - 1


# ---------------------------------------------------------------------------
# order-free, and the same bits from every function
# ---------------------------------------------------------------------------

def _wide_range(d, seed):
    """Gradients over six decades: float sums of them depend on order."""
    r = np.random.RandomState(seed)
    d = dict(d)
    d["grad"] = (r.randn(N) * 10.0 ** r.uniform(-3, 3, N)).astype(np.float32)
    d["hess"] = (r.uniform(0.1, 1.0, N) *
                 10.0 ** r.uniform(-2, 2, N)).astype(np.float32)
    d["cnt"] = r.randint(0, 3, N).astype(np.float32)
    return d


def _three_hists(d, idx, const_hess):
    """The fused sweep's, build_histograms' and the scatter histogram's
    plain versions over rows `idx` (row_block 64: slots of several runs,
    partials summed by the reduce)."""
    rows = {k: _t(d[k][idx]) for k in ("bins", "grad", "hess", "cnt",
                                       "row_node")}
    tables = _torch_tables(d)
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX, const_hess=const_hess)
    chan = (rows["bins"], rows["grad"], rows["hess"], rows["cnt"])
    h1, _ = torch_k.fused_route_hist_ref(*chan, rows["row_node"], *tables,
                                         **kw)
    _, slot = torch_k.route_rows_ref(rows["bins"], rows["row_node"], *tables)
    h3 = torch_k.build_histograms_ref(*chan, slot, **kw)
    h7 = torch_p.build_histograms_scatter_ref(*chan, slot, row_block=64,
                                              **kw)
    return h1, h3, h7


@pytest.mark.parametrize("const_hess", [0.0, 1.0])
def test_permuted_rows_give_the_same_bits(const_hess):
    d = _wide_range(_inputs(31), 32)
    perm = np.random.RandomState(33).permutation(N)
    ident = _three_hists(d, np.arange(N), const_hess)
    permuted = _three_hists(d, perm, const_hess)
    for h in ident[1:] + permuted:
        assert torch.equal(_bits(h), _bits(ident[0]))
    assert torch.isfinite(ident[0]).all() and ident[0][..., 2].sum() > 0
    # the data is order-sensitive: f32 sums of the same cells differ
    slot = torch_k.route_rows_ref(_t(d["bins"]), _t(d["row_node"]),
                                  *_torch_tables(d))[1].numpy()

    def f32_sums(idx):
        keep = idx[(slot[idx] >= 0) & (slot[idx] < NUM_SLOTS)]
        cell = _t((slot[keep] * d["bins"].shape[1]) * BMAX +
                  d["bins"][keep, 0].astype(np.int64))
        return torch.zeros(NUM_SLOTS * 8 * BMAX).index_add_(
            0, cell, _t(d["grad"][keep]))
    assert not torch.equal(f32_sums(np.arange(N)), f32_sums(perm))


def test_wrappers_on_cpu_take_the_callers_scale():
    # a scale computed once (as the grower does per tree) gives the same
    # bits as the wrapper's own
    d = _wide_range(_inputs(34), 35)
    slot = _t(np.random.RandomState(36).randint(-1, NUM_SLOTS + 2, N)
              .astype(np.int32))
    chan = (_t(d["bins"]), _t(d["grad"]), _t(d["hess"]), _t(d["cnt"]))
    scale = torch_k.exact_scale(*chan[1:])
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX)
    for fn in (torch_k.build_histograms, torch_k.build_histograms_auto,
               torch_p.build_histograms_scatter):
        assert torch.equal(_bits(fn(*chan, slot, scale=scale, **kw)),
                           _bits(fn(*chan, slot, **kw)))
    # a coarser scale gives other bits: the scale is really used
    coarse = fn(*chan, slot, scale=scale - 20, **kw)
    assert not torch.equal(_bits(coarse), _bits(fn(*chan, slot, **kw)))


def test_scatter_rejects_runs_past_the_word_rows():
    # exact mode: a run of RUN_BLOCKS blocks may hold at most 4096 rows
    n = 64
    args = (torch.zeros((n, 2), dtype=torch.uint8), torch.zeros(n),
            torch.zeros(n), torch.ones(n), torch.zeros(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_block"):
        torch_p.scatter_histograms("build_histograms", *args, num_slots=1,
                                   bmax=4, row_block=2048)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["exact", "quantized"])
def test_slot_ranges_past_the_partition_limit(quantized, monkeypatch):
    # frontiers wider than the partition kernel's counters go in slot
    # ranges: each range's rows shifted down, the others parked, its
    # counts and output sliced. The partition and the kernel are stood in
    # for by their plain versions.
    d = _inputs(37)
    slot = np.random.RandomState(38).randint(-1, NUM_SLOTS + 2, N) \
        .astype(np.int32)
    if quantized:
        g = np.clip(np.round(d["grad"] * 40), -127, 127).astype(np.int8)
        h = np.clip(np.round(d["hess"] * 100), -127, 127).astype(np.int8)
    else:
        g, h = d["grad"], d["hess"]
    chan = (_t(d["bins"]), _t(g), _t(h), _t(d["cnt"]))
    counts = torch.bincount(_t(slot[(slot >= 0) & (slot < NUM_SLOTS)])
                            .long(), minlength=NUM_SLOTS).to(torch.int32)
    seen = []

    def partition(sl, s, nb, cts, impl, tallies, reuse):
        # slot ranges count themselves: chunk tallies serve one range only
        assert tallies is None and reuse
        block_slot, src = torch_p.partition_rows_ref(
            sl, num_slots=s, row_block=nb, counts=cts, impl=impl)
        seen.append((s, None if cts is None else cts.tolist()))
        return block_slot, src, torch_p.slot_bounds(block_slot, s)

    def kernel(stem, dev, bins, grad, hess, cnt, block_slot, src, bounds,
               scale, out, part, n, f, fh, b, s, nb, tb, runs, ch, q, sp,
               wide):
        # the rows the partition put in slots [0, s), by their slot
        pos_slot = block_slot.long().repeat_interleave(nb)
        keep = (src < n) & (pos_slot < s)
        row_slot = torch.full((n,), -1, dtype=torch.int32)
        row_slot[src[keep].long()] = pos_slot[keep].to(torch.int32)
        out.copy_(torch_k.build_histograms_ref(
            bins, grad, hess, cnt, row_slot, num_slots=s, bmax=b,
            quantized=bool(q), scale=scale, double_prec=not sp))

    monkeypatch.setattr(torch_p, "_PARTITION_MAX_SLOTS", 16)
    monkeypatch.setattr(torch_p, "_partition", partition)
    monkeypatch.setattr(torch_p._cuda, "call", kernel)
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX, quantized=quantized)
    torch_k.reset_launch_counts()
    got = torch_p.scatter_histograms("build_histograms_scatter", *chan,
                                     _t(slot), slot_counts=counts, **kw)
    want = torch_k.build_histograms_ref(*chan, _t(slot), **kw)
    assert torch.equal(_bits(got), _bits(want))
    assert [s for s, _ in seen] == [16, 16, 8]
    assert [c for _, c in seen] == [counts[:16].tolist(),
                                    counts[16:32].tolist(),
                                    counts[32:].tolist()]
    key = "build_histograms_scatter" + "_int" * quantized
    assert torch_k.launch_counts()[key] == 3


# ---------------------------------------------------------------------------
# non-finite values
# ---------------------------------------------------------------------------

def _nonfinite_case(case):
    d = _inputs(41)
    slot = np.random.RandomState(42).randint(-1, NUM_SLOTS + 2, N) \
        .astype(np.int32)
    routed = torch_k.route_rows_ref(_t(d["bins"]), _t(d["row_node"]),
                                    *_torch_tables(d))[1].numpy()
    # rows in a slot of both the given and the routed slots, and parked
    # in both
    slotted = np.nonzero((slot >= 0) & (slot < NUM_SLOTS) & (routed >= 0) &
                         (routed < NUM_SLOTS))[0]
    parked = np.nonzero(((slot < 0) | (slot >= NUM_SLOTS)) &
                        ((routed < 0) | (routed >= NUM_SLOTS)))[0]
    if case == "nan_grad":
        d["grad"][slotted[5]] = np.nan
    elif case == "inf_hess":
        d["hess"][slotted[9]] = np.inf
    else:                                       # a parked row's NaN
        d["grad"][parked[0]] = np.nan
    return d, slot


@pytest.mark.parametrize("case", ["nan_grad", "inf_hess", "nan_parked"])
def test_non_finite_values_stay_non_finite(case):
    # the port's rule: a channel with a non-finite value in any of its n
    # rows is NaN in every cell; the JAX kernels (one-hot products) spread
    # a slotted row's NaN over its slot. Wherever a JAX kernel's cell is
    # not finite, the port's is not either, and no other channel is hit.
    d, slot = _nonfinite_case(case)
    chan_j = tuple(jnp.asarray(d[k]) for k in ("bins", "grad", "hess",
                                               "cnt"))
    chan_t = tuple(_t(d[k]) for k in ("bins", "grad", "hess", "cnt"))
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX)
    bad = 1 if case == "inf_hess" else 0
    pairs = [
        (jax_k.build_histograms_mxu(*chan_j, jnp.asarray(slot),
                                    interpret=True, **kw),
         torch_k.build_histograms(*chan_t, _t(slot), **kw)),
        (jax_p.build_histograms_scatter(*chan_j, jnp.asarray(slot),
                                        interpret=True, **kw),
         torch_p.build_histograms_scatter(*chan_t, _t(slot), **kw)),
        (jax_k.fused_route_hist_mxu(*chan_j, jnp.asarray(d["row_node"]),
                                    *_jax_tables(d), has_cat=True,
                                    interpret=True, **kw)[0],
         torch_k.fused_route_hist(*chan_t, _t(d["row_node"]),
                                  *_torch_tables(d), **kw)[0])]
    for h_j, h_t in pairs:
        h_j, h_t = np.asarray(h_j), h_t.numpy()
        assert (np.isfinite(h_t) <= np.isfinite(h_j)).all()
        assert np.isnan(h_t[..., bad]).all()
        for c in {0, 1, 2} - {bad}:
            assert np.isfinite(h_t[..., c]).all()
        np.testing.assert_array_equal(h_t[..., 2], h_j[..., 2])
        if case != "nan_parked":
            assert not np.isfinite(h_j[..., bad]).all()


# ---------------------------------------------------------------------------
# the growth glue: no sum whose bits depend on the order of the additions
# (torch adds in another order on the card than on the CPU)
# ---------------------------------------------------------------------------

def _grow(ds, grad, hess, idx):
    hp = SplitHyperParams(has_categorical=True)
    return torch_grower.grow_tree_mxu(
        _t(ds.bins[idx]), _t(grad[idx]), _t(hess[idx]),
        torch.ones(len(idx)), torch.ones(ds.num_features),
        _t(ds.num_bins), _t(ds.missing_types == 2), _t(ds.is_categorical),
        num_leaves=31, max_depth=-1, bmax=int(ds.num_bins.max()),
        overshoot=2.0, hp=hp)


def test_grower_permuted_rows_give_the_same_tree():
    # exact growth on NaN and categorical data: the rows in another order
    # give the same tree bit for bit (root sums in the histograms' fixed
    # point, exact_sums; categorical scans in float64), while f32 sums of
    # the same gradients in the two orders differ
    ds, grad, hess = _data(6000, 6, seed=36, with_nan=True, with_cat=True)
    grad = (grad * 10.0 ** np.random.RandomState(37).uniform(
        -2, 2, grad.shape[0])).astype(np.float32)
    perm = np.random.RandomState(38).permutation(ds.num_data)
    ident = np.arange(ds.num_data)
    assert torch.sum(_t(grad)) != torch.sum(_t(grad[perm]))
    t1, r1 = _grow(ds, grad, hess, ident)
    t2, r2 = _grow(ds, grad, hess, perm)
    assert int(t1.num_leaves) == 31 and bool(t1.is_cat.any())
    for fld in t1._fields:
        a, b = getattr(t1, fld), getattr(t2, fld)
        if a.dtype == torch.float32:
            a, b = _bits(a), _bits(b)
        assert torch.equal(a, b), fld
    assert torch.equal(r1[perm], r2)
    scale = torch_k.exact_scale(_t(grad), _t(hess), torch.ones(len(grad)))
    root = torch_k.exact_sums(_t(grad), _t(hess), torch.ones(len(grad)),
                              scale)
    assert torch.equal(_bits(torch.stack([t1.sum_grad[0], t1.sum_hess[0],
                                          t1.count[0]])), _bits(root))


def test_categorical_left_sums_are_rounded_once(monkeypatch):
    # the sorted-by-ratio categorical scan's left sums are the exact sums
    # of the left set's bins rounded to f32 once: bins within 2^20 of each
    # other in magnitude, so their float64 sum is exact in any order. The
    # CPU's torch.cumsum accumulates f32 in double, the card's in f32: an
    # f32 cumsum that accumulates in f32 stands in for the card's
    real_cumsum = torch.cumsum

    def f32_cumsum(x, dim, **kw):
        if x.dtype != torch.float32:
            return real_cumsum(x, dim, **kw)
        parts = list(torch.unbind(x, dim))
        for i in range(1, len(parts)):
            parts[i] = parts[i - 1] + parts[i]
        return torch.stack(parts, dim)
    monkeypatch.setattr(torch, "cumsum", f32_cumsum)
    r = np.random.RandomState(39)
    s, f, b = 64, 3, 32
    cnt = r.randint(20, 200, (s, f, b)).astype(np.float64)
    g = r.randn(s, f, b) * 2.0 ** r.randint(0, 12, (s, f, b))
    h = r.uniform(0.5, 1.0, (s, f, b)) * 2.0 ** r.randint(0, 8, (s, f, b))
    hist = np.stack([g, h, cnt], -1).astype(np.float32)
    tot = hist.astype(np.float64)[:, 0].sum(1).astype(np.float32)  # [S, 3]
    best = find_best_splits(
        _t(hist), _t(tot[:, 0]), _t(tot[:, 1]), _t(tot[:, 2]),
        torch.zeros(s), torch.full((f,), b, dtype=torch.int32),
        torch.zeros(f, dtype=torch.bool), torch.ones(f, dtype=torch.bool),
        torch.ones(f), SplitHyperParams(has_categorical=True))
    feat = best.feature.numpy()
    assert (feat >= 0).sum() >= s // 2
    words = best.cat_bitset.numpy()
    sizes = []
    for k in np.nonzero(feat >= 0)[0]:
        member = np.array([(words[k, j >> 5] >> (j & 31)) & 1
                           for j in range(b)], bool)
        sizes.append(member.sum())
        want = hist[k, feat[k]][member].astype(np.float64).sum(0) \
            .astype(np.float32)
        got = np.array([best.left_grad[k], best.left_hess[k],
                        best.left_count[k]], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert sum(n >= 3 for n in sizes) >= s // 4   # sums of several bins


# ---------------------------------------------------------------------------
# the booster: the same trees under hist_backend mxu and pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_exact_model_text_byte_equal_across_backends(objective):
    r = np.random.RandomState(43)
    X = r.randn(1500, 6).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * r.randn(1500) > 0) \
        .astype(np.float32) if objective == "binary" else \
        (X[:, 0] * np.exp(X[:, 1]) + 0.3 * r.randn(1500)).astype(np.float32)
    texts = {}
    for hb in ("mxu", "pallas"):
        p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
             "verbosity": -1, "device_type": "cpu", "hist_backend": hb}
        b = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
        assert b.gbdt._hist_backend == hb
        texts[hb] = strip_backend_echo(b.model_to_string())
    assert texts["mxu"] == texts["pallas"]
    assert texts["mxu"].count("Tree=") == 3
