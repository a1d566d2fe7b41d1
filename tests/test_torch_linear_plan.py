"""The leaf-model kernels' index arithmetic, on the CPU.

On the card, kernel L1 (linear_gram, csrc/linear_leaves.cu) counts the
rows of each leaf, gives each leaf a run of fixed-width records (its
active features, h, g and a usable flag, padded to a power of two), packs
the rows in row order, runs of 2048 rows ranked by leaf in shared memory
with one reservation a leaf and run (past 8192 node ids a global counter a
row), then takes the records' maxima and sums a CTA a chunk of 1024, with
G lanes an entry that combine with shuffles before one global add a
group; L2 (linear_values) compacts each leaf's slots into its active ones,
each with the code of the run of empty slots before it. All of it is
written out here in numpy and held element for element (bit patterns; NaN
where the plain version is NaN) against linear_gram_ref and
linear_leaf_values_ref, with the runs, the rows within a run and the
chunks in shuffled orders, since the kernels' order varies and their sums
must not. No JAX here: the plain versions are held to the JAX package in
tests/test_torch_linear.py.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.learner import linear as tlin
from tests.test_torch_one_thread import one_thread  # noqa: F401

CHUNK = tlin.GRAM_CHUNK
PACK_ROWS = 2048           # linear_leaves.cu kPackRows: a reservation a
FAST_NODES = 8192          # kMaxFastNodes           node and run of rows
SUM_THREADS = 512          # kSumThreads
STAGE_FLOATS = 2048        # kStageFloats: record floats a batch stages
GRAM_BITS = tlin.GRAM_BITS
NONFINITE = tlin.NONFINITE_K


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _same(got, want):
    """Equal bits where want is not NaN, NaN where it is."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


# ---- L1: count, leaves, pack, maxima, sums, finish


def _abs_bits(x):
    return _bits(x) & 0x7FFFFFFF


def _exponent(bits):
    a = np.asarray(bits, np.int32).view(np.float32)
    e = np.frexp(a.astype(np.float64))[1]
    return np.where(np.isfinite(a), e, NONFINITE).astype(np.int64)


def _scale(lg, *exps):
    bad = any(e == NONFINITE for e in exps)
    return NONFINITE if bad else GRAM_BITS - lg - sum(int(e) for e in exps)


def _lg(c):
    return int(c - 1).bit_length() if c > 1 else 0


def _lanes(total):
    """G lanes an entry (a power of two, 512 / total at most) and the
    entries side by side."""
    per = SUM_THREADS // total
    g = 1 << (per.bit_length() - 1) if per >= 1 else 1
    return g, SUM_THREADS // g


def tri(i, j, d1):
    """linear_leaves.cu tri: the (i <= j) entry of the row-major upper
    triangle of d1 slots."""
    return i * d1 - i * (i - 1) // 2 + (j - i)


def _leaves(row_node, feat):
    """count_kernel and leaves_kernel: each node's rows, active columns
    (slot order), record width, first record float and first chunk."""
    m1, d = feat.shape
    inside = (row_node >= 0) & (row_node < m1)
    ncount = np.bincount(row_node[inside], minlength=m1)
    cols = [feat[k][feat[k] >= 0] for k in range(m1)]
    width = np.array([tlin._record_width(c.shape[0]) for c in cols])
    lbase = np.cumsum(ncount * width) - ncount * width
    chunks = -(-ncount // CHUNK)
    # the chunk table: (node, index within the node), -1 past the last
    chunk_at = [(k, c) for k in range(m1) for c in range(chunks[k])]
    bound = -(-row_node.shape[0] // CHUNK) + m1     # gram_chunks
    assert len(chunk_at) <= bound
    chunk_at += [(-1, 0)] * (bound - len(chunk_at))
    return ncount, cols, width, lbase, chunk_at


def _pack(raw, row_node, grad, hess, cnt, cols, width, lbase, rng):
    """pack_kernel: runs of PACK_ROWS rows in a shuffled order (their
    reservations land in any order), each row's rank among its run's rows
    of its node in a shuffled order too; every in-range row's record (its
    features, h, g and 1 if usable, else zeros). Past FAST_NODES a global
    counter a row: any order over all the rows."""
    n, f = raw.shape
    m1 = len(cols)
    pack = np.full(int((lbase + np.bincount(
        row_node[(row_node >= 0) & (row_node < m1)], minlength=m1) *
        width).max(initial=0)), np.nan, np.float32)
    cursor = np.zeros(m1, np.int64)
    runs = [np.arange(c0, min(c0 + PACK_ROWS, n))
            for c0 in range(0, n, PACK_ROWS)]
    if m1 > FAST_NODES:
        runs = [rng.permutation(n)]
    for run in (runs[i] for i in rng.permutation(len(runs))):
        k = row_node[run]
        keep = (k >= 0) & (k < m1)
        run, k = rng.permutation(run[keep]), None
        k = row_node[run]
        order = np.argsort(k, kind="stable")
        rank = np.empty(run.shape[0], np.int64)
        bounds = np.flatnonzero(np.diff(k[order], prepend=-1))
        for a, b in zip(bounds, list(bounds[1:]) + [run.shape[0]]):
            rank[order[a:b]] = np.arange(b - a)
        tally = np.bincount(k, minlength=m1)
        first = cursor.copy()                       # one reservation a
        cursor += tally                             # node and run
        for r, kk, q in zip(run, k, rank):
            c = cols[kk]
            x = raw[r, c]
            ok = cnt[r] > 0 and not np.isnan(x).any()
            rec = np.zeros(width[kk], np.float32)
            if ok:
                rec[:c.shape[0]] = x
                rec[c.shape[0]:c.shape[0] + 3] = hess[r], grad[r], 1.0
            at = lbase[kk] + (first[kk] + q) * width[kk]
            assert np.isnan(pack[at:at + width[kk]]).all()  # written once
            pack[at:at + width[kk]] = rec
    assert not np.isnan(pack).any()                 # every record written
    return pack


def _gram_plan(raw, row_node, grad, hess, cnt, feat, rng):
    """linear_gram's kernels in numpy; returns (xthx, xtg, count) and the
    kernels' tallies."""
    n, f = raw.shape
    m1, d = feat.shape
    d1 = d + 1
    w = d1 * (d1 + 1) // 2 + d1
    ncount, cols, width, lbase, chunk_at = _leaves(row_node, feat)
    pack = _pack(raw, row_node, grad, hess, cnt, cols, width, lbase, rng) \
        if n else np.zeros(0, np.float32)
    grid = len(chunk_at) if n else 0                # no rows: finish alone
    counts = np.zeros(m1, np.int64)
    xmax = np.zeros((m1, d1), np.int64)
    hmax = np.zeros(m1, np.int64)
    gmax = np.zeros(m1, np.int64)
    chunk = []
    for b in rng.permutation(grid):                 # maxima
        k, c = chunk_at[b]
        if k < 0:
            continue
        lo = c * CHUNK
        u = min(CHUNK, ncount[k] - lo)
        nf, wk = cols[k].shape[0], width[k]
        at = lbase[k] + lo * wk
        recs = pack[at:at + u * wk].reshape(u, wk)
        chunk.append((b, k, recs))
        mx = _abs_bits(recs).max(0)                 # plane a: thread a mod w
        slots = np.flatnonzero(feat[k] >= 0)
        xmax[k, slots] = np.maximum(xmax[k, slots], mx[:nf])
        hmax[k] = max(hmax[k], mx[nf])
        gmax[k] = max(gmax[k], mx[nf + 1])
        usable = int((recs[:, nf + 2] != 0).sum())
        if usable:
            counts[k] += usable
            xmax[k, d] = _bits(np.float32([1.0]))[0]
    sums = np.zeros((m1, w), np.int64)
    adds = 0
    for b, k, recs in chunk[::-1]:                  # sums
        u = recs.shape[0]
        slots = np.concatenate([np.flatnonzero(feat[k] >= 0), [d]])
        nact = slots.shape[0]
        nf = nact - 1
        xs = np.concatenate([recs[:, :nf].T, np.ones((1, u), np.float32),
                             recs[:, nf:nf + 2].T]).astype(np.float64)
        pairs = nact * (nact + 1) // 2
        total = pairs + nact
        g, npar = _lanes(total)
        lg = _lg(counts[k])
        nbmax = STAGE_FLOATS // recs.shape[1]       # records a batch
        lane = (np.arange(u) % nbmax) % g            # the lane of each row
        ii, jj = np.triu_indices(nact)
        for e in range(total):
            if e < pairs:
                a, b2 = ii[e], jj[e]
                p0, widx = nf + 1, tri(slots[a], slots[b2], d1)
                kk = _scale(lg, _exponent(hmax[k]),
                            _exponent(xmax[k, slots[a]]),
                            _exponent(xmax[k, slots[b2]]))
            else:
                a, b2 = e - pairs, nf
                p0, widx = nf + 2, d1 * (d1 + 1) // 2 + slots[a]
                kk = _scale(lg, _exponent(gmax[k]),
                            _exponent(xmax[k, slots[a]]), 0)
            if kk == NONFINITE:
                continue
            v = (xs[p0] * xs[a]) * xs[b2]
            q = np.rint(v * 2.0 ** kk).astype(np.int64)
            part = np.zeros(g, np.int64)
            np.add.at(part, lane, q)
            width_ = min(g, 32)                      # shuffles, then a
            for s in part.reshape(-1, width_).sum(1):  # global add a group
                if s != 0:
                    sums[k, widx] += s
                    adds += 1
    xthx = np.zeros((m1, d1, d1), np.float32)        # finish
    xtg = np.zeros((m1, d1), np.float32)
    for k in range(m1):
        lg = _lg(counts[k])
        for i in range(d1):
            for jx in range(d1):
                a, b2 = min(i, jx), max(i, jx)
                kk = _scale(lg, _exponent(hmax[k]), _exponent(xmax[k, a]),
                            _exponent(xmax[k, b2]))
                xthx[k, i, jx] = np.nan if kk == NONFINITE else np.float32(
                    np.float64(sums[k, tri(a, b2, d1)]) * 2.0 ** -kk)
            kk = _scale(lg, _exponent(gmax[k]), _exponent(xmax[k, i]), 0)
            xtg[k, i] = np.nan if kk == NONFINITE else np.float32(
                np.float64(sums[k, d1 * (d1 + 1) // 2 + i]) * 2.0 ** -kk)
    return (xthx, xtg, counts.astype(np.int32)), {
        "chunks": len(chunk), "records": int(ncount.sum()), "adds": adds,
        "floats": int((ncount * width).sum())}


def _gram_rows(n, m1, d, seed, nan_rows=0.0, bag=0.0, node_lo=0,
               node_hi=None, slots=None):
    """(raw, row_node, grad, hess, cnt, feat) made from a seed: leaf ids in
    [node_lo, node_hi), NaN in a share of rows' values, out-of-bag rows;
    each leaf's active slots ascending (slots: how many, or random)."""
    r = np.random.RandomState(seed)
    f = max(d, 4) + 2
    raw = (r.randn(n, f) * 3).astype(np.float32)
    raw[r.uniform(size=(n, f)) < nan_rows] = np.nan
    node_hi = m1 if node_hi is None else node_hi
    row_node = r.randint(node_lo, node_hi, n).astype(np.int32)
    grad = r.randn(n).astype(np.float32)
    hess = r.uniform(0.1, 2.0, n).astype(np.float32)
    cnt = (r.uniform(size=n) >= bag).astype(np.float32)
    feat = np.full((m1, d), -1, np.int32)
    for k in range(m1):
        take = r.randint(0, d + 1) if slots is None else slots
        feat[k, :take] = np.sort(r.choice(f, take, replace=False))
    return raw, row_node, grad, hess, cnt, feat


def _hold_gram(args, seed):
    want = tlin.linear_gram_ref(*[torch.as_tensor(a) for a in args])
    got, tally = _gram_plan(*args, rng=np.random.RandomState(seed))
    _same(got[0], want[0].numpy())
    _same(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    return want, tally


GRAM_CASES = {
    # n, m1, d, keywords of _gram_rows
    "empty": (0, 6, 4, {}),
    "ids_out_of_range": (3000, 9, 5, dict(node_lo=-2, node_hi=12)),
    "nan_rows": (2500, 7, 6, dict(nan_rows=0.05, bag=0.3)),
    "one_leaf_all_rows": (5 * CHUNK + 17, 4, 5, dict(node_lo=2, node_hi=3,
                                                     slots=5)),
    "nact_1": (900, 5, 3, dict(slots=0)),
    "nact_32": (700, 3, 31, dict(slots=31)),
}


@pytest.mark.parametrize("case", list(GRAM_CASES))
def test_gram_plan_is_the_plain_version(case):
    n, m1, d, kw = GRAM_CASES[case]
    args = _gram_rows(n, m1, d, seed=len(case), **kw)
    want, tally = _hold_gram(args, seed=3)
    if case == "ids_out_of_range":
        assert ((args[1] < 0) | (args[1] >= m1)).any()
        assert tally["records"] == int(((args[1] >= 0) &
                                        (args[1] < m1)).sum())
    if case == "one_leaf_all_rows":       # several chunks and runs, 8 floats
        assert int(want[2][2]) == n and tally["floats"] == n * 8
        assert tally["chunks"] == -(-n // CHUNK) and n > PACK_ROWS
    if case == "nact_1":
        assert (args[5] < 0).all()
    if case == "nact_32":     # 560 entries: 512 threads, 48 own two
        assert (args[5] >= 0).all() and _lanes(32 * 33 // 2 + 32)[0] == 1
        assert tally["floats"] == 700 * 64


def test_gram_plan_leaf_without_usable_rows():
    # leaf 1: every row out of bag; leaf 2: every row NaN in a feature of
    # its model; leaf 3: no rows at all. Each counts 0 and sums to zero.
    raw, row_node, grad, hess, cnt, feat = _gram_rows(2000, 5, 4, seed=11,
                                                      slots=2)
    cnt[row_node == 1] = 0.0
    raw[row_node == 2, feat[2, 0]] = np.nan
    row_node[row_node == 3] = 4
    want, _ = _hold_gram((raw, row_node, grad, hess, cnt, feat), seed=5)
    assert want[2][1:4].tolist() == [0, 0, 0]
    assert not want[0][1:4].any() and not want[1][1:4].any()


def test_gram_plan_past_the_fast_limit():
    # more node ids than the pack's shared-memory counters: a global
    # counter a row, records in any order within a leaf, the same bits
    m1 = FAST_NODES + 77
    args = _gram_rows(3000, m1, 2, seed=13, node_lo=-1, node_hi=m1 + 2)
    _hold_gram(args, seed=1)


def test_gram_plan_nonfinite_maxima():
    # an infinite hessian on a usable row: its leaf's X'HX is NaN, X'g not
    raw, row_node, grad, hess, cnt, feat = _gram_rows(1500, 4, 3, seed=17,
                                                      slots=2)
    r = int(np.flatnonzero((row_node == 2) & (cnt > 0))[0])
    hess[r] = np.inf
    want, _ = _hold_gram((raw, row_node, grad, hess, cnt, feat), seed=4)
    assert torch.isnan(want[0][2]).all() and not torch.isnan(want[1][2]).any()


def test_gram_lanes_keep_the_threads_live():
    # G lanes an entry: every one of the 512 threads has an entry whenever
    # the leaf's entries fit, more than half of them otherwise live; a
    # record's width divides the maxima kernel's 256 threads
    for nact in range(1, 33):
        total = nact * (nact + 1) // 2 + nact
        g, npar = _lanes(total)
        assert g & (g - 1) == 0 and npar * g == SUM_THREADS
        assert total <= 2 * npar                   # kEntries = 2
        if total <= SUM_THREADS:
            assert g * total <= SUM_THREADS < 2 * g * total
        w = tlin._record_width(nact - 1)
        assert w >= nact + 2 and 256 % w == 0 and w <= 64


def test_gram_scratch_layout_follows_the_kernel():
    # gram_scratch_bytes mirrors carve() in linear_leaves.cu: the zeroed
    # head (m1 (d + 6) int32 words, the int64 sums), then at 16 bytes the
    # leaves' tables (int64 first floats; active counts and columns), the
    # chunk table, the records (n _record_width(d) floats)
    src = (_cuda.CSRC / "linear_leaves.cu").read_text()
    for name, value in (("kChunk", CHUNK), ("kPackRows", PACK_ROWS),
                        ("kMaxFastNodes", FAST_NODES),
                        ("kSumThreads", SUM_THREADS),
                        ("kStageFloats", STAGE_FLOATS)):
        assert int(re.search(name + r" = (\d+);", src).group(1)) == value
    for n, m1, d in ((0, 1, 1), (1000, 510, 28), (12345, 1101, 31)):
        d1 = d + 1
        zeroed = -(-4 * m1 * (d1 + 5) // 8) * 8 + \
            8 * m1 * (d1 * (d1 + 1) // 2 + d1)
        head = -(-zeroed // 16) * 16
        tables = -(-(8 * m1 + 4 * m1 * (d + 1)) // 16) * 16
        chunk_at = -(-8 * (-(-n // CHUNK) + m1) // 16) * 16
        assert tlin.gram_scratch_bytes(n, m1, d) == \
            head + tables + chunk_at + 4 * n * tlin._record_width(d)
    # ~130 MB at the main path's 1M rows, 510 ids and 28 slots
    assert tlin.gram_scratch_bytes(1 << 20, 510, 28) < 140e6


# ---- L2: the compact models and the signed zeros

ZEROS = (np.float32(-0.0), np.float32(0.0), np.float32(np.nan))


def _models(feat, coeff):
    """The model kernel's ballots in numpy, 32 slots a group: per leaf its
    active (column, coeff, code of the run before it) in slot order and
    the code of the run after its last active slot."""
    m1, d = feat.shape
    out = []
    for k in range(m1):
        ents, nf = [], 0
        run_plus = run_nan = False
        for s0 in range(0, d, 32):
            lanes = range(min(32, d - s0))
            fc = [int(feat[k, s0 + i]) for i in lanes]
            c = [np.float32(coeff[k, s0 + i]) for i in lanes]
            with np.errstate(invalid="ignore"):
                z = [ci * np.float32(0.0) for ci in c]
            am = sum(1 << i for i in lanes if fc[i] >= 0)
            pm = sum(1 << i for i in lanes if fc[i] < 0 and
                     not np.isnan(z[i]) and not np.signbit(z[i]))
            nm = sum(1 << i for i in lanes if fc[i] < 0 and np.isnan(z[i]))
            for i in lanes:
                if fc[i] < 0:
                    continue
                below = (1 << i) - 1
                prev = am & below
                run = below & ~((2 << (prev.bit_length() - 1)) - 1) \
                    if prev else below
                nan = bool(nm & run) or (prev == 0 and run_nan)
                plus = bool(pm & run) or (prev == 0 and run_plus)
                ents.append((nf + bin(prev).count("1"), fc[i], c[i],
                             2 if nan else 1 if plus else 0))
            if am:
                after = ~((2 << (am.bit_length() - 1)) - 1) & 0xFFFFFFFF
                run_nan, run_plus = bool(nm & after), bool(pm & after)
            else:
                run_nan, run_plus = run_nan or nm != 0, run_plus or pm != 0
            nf += bin(am).count("1")
        ents.sort()
        assert [e[0] for e in ents] == list(range(nf))
        out.append(([e[1:] for e in ents],
                    2 if run_nan else 1 if run_plus else 0))
    return out


def _values_plan(leaf_value, const, coeff, feat, leaf, raw, seed=0):
    """The values kernel in numpy: the leaves' entries reserved in a
    shuffled order (the model kernel's warps), then a row's leaf's active
    slots only, one add of the run's zero before each and one after the
    last."""
    m1 = feat.shape[0]
    models = _models(feat, coeff)
    table, first = [], np.zeros(m1, np.int64)
    for k in np.random.RandomState(seed).permutation(m1):
        first[k] = len(table)
        table += models[k][0]
    out = np.zeros(leaf.shape[0], np.float32)
    for r, k in enumerate(leaf):
        if not 0 <= k < m1:
            continue
        nf, tail = len(models[k][0]), models[k][1]
        ents = table[first[k]:first[k] + nf]
        acc = np.float32(const[k])
        nan = False
        for col, c, code in ents:
            x = np.float32(raw[r, col])
            nan = nan or bool(np.isnan(x))
            acc = np.float32(acc + ZEROS[code])
            acc = np.float32(acc + np.float32(c * x))
        acc = np.float32(acc + ZEROS[tail])
        out[r] = np.float32(leaf_value[k]) if nan else acc
    return out


def _values_ref(leaf_value, const, coeff, feat, leaf, raw):
    lin = tlin.LinearLeaves(const=torch.as_tensor(const),
                            coeff=torch.as_tensor(coeff),
                            feat=torch.as_tensor(feat),
                            nfeat=torch.as_tensor((feat >= 0).sum(1)))
    tree = SimpleNamespace(leaf_value=torch.as_tensor(leaf_value))
    return tlin.linear_leaf_values_ref(tree, lin, torch.as_tensor(leaf),
                                       torch.as_tensor(raw)).numpy()


def _value_inputs(m1, d, n, seed, signed=False):
    r = np.random.RandomState(seed)
    f = d + 3
    feat = np.where(r.uniform(size=(m1, d)) < 0.4,
                    r.randint(0, f, (m1, d)), -1).astype(np.int32)
    if signed:     # signed zeros everywhere: coefficients and values
        coeff = r.choice(np.float32([-1.0, -0.0, 0.0, 2.5]), (m1, d))
        coeff[::2] = -np.abs(coeff[::2])          # products -0 on +0 rows
        raw = r.choice(np.float32([-0.0, 0.0, 0.0, 1.5]), (n, f))
        raw[::3] = 0.0
        const = r.choice(np.float32([-0.0, -0.0, 0.5]), m1)
    else:
        coeff = r.randn(m1, d).astype(np.float32)
        coeff[feat < 0] = 0.0             # as the fit leaves them
        raw = r.randn(n, f).astype(np.float32)
        raw[r.uniform(size=(n, f)) < 0.02] = np.nan
        const = r.randn(m1).astype(np.float32)
    leaf_value = r.randn(m1).astype(np.float32)
    leaf = r.randint(-1, m1 + 2, n).astype(np.int32)
    return (leaf_value, const.astype(np.float32), coeff.astype(np.float32),
            feat, leaf, raw.astype(np.float32))


@pytest.mark.parametrize("m1,d,signed", [
    (7, 6, False), (9, 31, False), (5, 40, False), (11, 6, True),
    (6, 35, True)], ids=["d6", "d31", "d40", "signed_zeros",
                         "signed_zeros_d35"])
def test_values_plan_is_the_plain_version(m1, d, signed):
    args = _value_inputs(m1, d, 600, seed=m1 + d, signed=signed)
    want = _values_ref(*args)
    _same(_values_plan(*args), want)
    if signed:
        assert (_bits(want) == _bits(np.float32(-0.0))).any()
        assert (_bits(want) == 0).any()


def test_values_plan_signed_zero_runs():
    # const -0.0 with empty slots in between: each run's code decides
    # whether -0 survives (every empty product -0) or turns +0, and an
    # infinite coefficient in an empty slot makes the value NaN
    d = 6
    feat = np.array([[-1, 0, -1, -1, 1, -1],    # +0 run before slot 1
                     [-1, 0, -1, -1, 1, -1],    # -0 runs only
                     [2, -1, -1, -1, -1, -1],   # a +0 run after the last
                     [-1, -1, -1, -1, -1, -1],  # no active slot
                     [-1, 0, -1, -1, -1, -1]],  # an inf in an empty slot
                    np.int32)
    coeff = np.array([[1.0, -1.0, -2.0, -3.0, -1.0, -1.0],
                      [-1.0, -1.0, -2.0, -0.0, -1.0, -5.0],
                      [-1.0, -1.0, -1.0, 3.0, -1.0, -1.0],
                      [-1.0, -1.0, -1.0, -1.0, -1.0, -1.0],
                      [-1.0, 1.0, np.inf, -1.0, -1.0, -1.0]], np.float32)
    const = np.full(5, -0.0, np.float32)
    leaf_value = np.arange(5, dtype=np.float32) + 10
    raw = np.zeros((5, 4), np.float32)          # every x +0
    leaf = np.arange(5, dtype=np.int32)
    args = (leaf_value, const, coeff, feat, leaf, raw)
    want = _values_ref(*args)
    _same(_values_plan(*args), want)
    assert _bits(want[:4]).tolist() == [0, _bits(np.float32(-0.0)), 0,
                                        _bits(np.float32(-0.0))]
    assert np.isnan(want[4])
    codes = [[e[2] for e in m[0]] + [m[1]] for m in _models(feat, coeff)]
    assert codes == [[1, 0, 0], [0, 0, 0], [0, 1], [0], [0, 2]]


def test_values_plan_ids_and_empty():
    args = _value_inputs(4, 5, 0, seed=3)
    assert _values_plan(*args).shape == (0,)
    assert _values_ref(*args).shape == (0,)
    args = _value_inputs(4, 5, 300, seed=4)
    want = _values_ref(*args)
    out = (args[4] < 0) | (args[4] >= 4)
    assert out.any() and not want[out].any()
    _same(_values_plan(*args), want)
