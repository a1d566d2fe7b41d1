#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (lightgbm_tpu_torch).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the port's eight CUDA kernel sources from lightgbm_tpu_torch/csrc,
holds each kernel against its plain PyTorch version on the card at the
shapes the training path gives it (1M rows x 28 features, 256 bins, up to
1024 tree nodes; 15 bins for the 4-bit packed modes; 511 and 263 scan
slots for the split scan; the root pass's single slot for the partition
and the scatter histogram), in every mode the paths run (f32 and the
integer mode of quantized gradients; unpacked and packed bins; route
counts; the split scan plain and monotone), times it — `ms`, one call as
the training path makes it, host launch path included, and `device_ms`,
the device alone over back-to-back calls; the same two for the PyTorch
yardstick where one call computes the function — then trains through
lightgbm_tpu_torch's entry points along six paths, each with the launch
counts reset before it and read after it:

- exact histograms: the Higgs-like binary configuration (num_leaves 255,
  max_bin 255), the same with min_data_in_leaf 1000 (which runs the
  fix-up passes) and the default regression objective;
- quantized gradients (use_quantized_grad, hist_backend pinned to mxu):
  the binary configuration, the regression objective, and a 200-feature
  binary run whose wide passes take route_rows + build_histograms in
  integer mode;
- the histogram backends on the binary configuration: quantized under
  hist_backend pallas (route counts, the partition kernel and the scatter
  kernel), scatter (the segment-sum oracle) and auto (the autotune), each
  byte-equal to the mxu run, and exact under pallas;
- the split-search options: monotone (+1 on feature 0, -1 on feature 1)
  and interaction constraints with feature_fraction and
  feature_fraction_bynode 0.8, exact and quantized (10 trees each; held
  to monotone predictions, paths within one interaction group, each
  tree's feature mask), and extra_trees (3 trees);
- the fused split scan (K8), which only a caller of the learner entry
  point grow_tree_mxu(use_scan_kernel=True) reaches: each tree of a
  booster run is grown again that way with the booster's own settings,
  gradients, mask and key, and must equal the booster's tree (the
  constrained configuration, 10 trees, and the plain one, 3 trees);
- 4-bit packed bins (max_bin 15): exact and quantized under mxu, each
  held to the same run on unpacked bins (exact: held-out AUC within
  0.005; quantized: byte-equal), and quantized under auto and pallas.

It checks what comes out, including that every leaf of every tree holds
-G/H of its rows' gradients (unconstrained runs) and that two identical
quantized runs write the same model text; K8 launches on the scan path
only, and every K7 call on a path launches exactly one partition kernel.
Every phase prints one JSON line; any failed check raises, so the exit
code is non-zero and no result line is printed.
The last three lines are the kernel table (JSON), the card's name and
power limit as nvidia-smi prints them, and the result
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 28
BMAX = 256
BMAX_PACKED = 15      # max_bin 15: every bin id fits a nibble
M_NODES = 1024        # route-table rows at num_leaves 255, overshoot 2
S_FUSED = 263         # kernel slots of the bridge pass (fused kernel)
S_HIST = 511          # kernel slots of the fix-up passes (build_histograms)
S_TUNE = 263          # the autotune's frontier: kernel cap of 511 scan slots
M_REFIT = 510         # node_sums rows: the pruned 255-leaf tree's 2 x 255
M_GROWN = 1020        # node ids of the overgrown (overshoot 2) tree
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 peak rate
LEAF_TOL = 1e-2       # a leaf value against -G/H of its rows' float64 sums
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255,
                "learning_rate": 0.1, "max_bin": 255,
                "min_data_in_leaf": 20, "verbosity": -1}
TRAIN_TREES = 10
REGRESSION_TREES = 3
# leaves of >= 1000 rows: trees stop short of the 510-leaf overshoot budget
# after the bridge pass and run the fix-up passes
FIXUP_MIN_DATA = 1000
# the quantized path pins mxu: hist_backend=auto may move it off K1/K3
QUANT_PARAMS = dict(TRAIN_PARAMS, use_quantized_grad=True, hist_backend="mxu")
BACKEND_TREES = 3     # scatter-oracle and exact-pallas runs
PACKED_PARAMS = dict(TRAIN_PARAMS, max_bin=BMAX_PACKED)
# wide data: the quantized fused kernel's working set no longer fits from
# about 100 slots up, so those passes take route_rows + build_histograms
WIDE_ROWS, WIDE_FEATURES, WIDE_TREES = 100_000, 200, 3
EXACT_PATH = ("fused_route_hist", "route_rows", "build_histograms",
              "node_values")
QUANT_PATH = ("fused_route_hist_int", "route_rows", "build_histograms_int",
              "node_values", "node_sums")
BACKEND_PATH = ("route_rows_counts", "partition_rows",
                "build_histograms_scatter_int", "build_histograms_scatter",
                "build_histograms_int")
K7_KEYS = ("build_histograms_scatter", "build_histograms_scatter_int",
           "build_histograms_scatter_packed",
           "build_histograms_scatter_int_packed")
PACKED_PATH = ("fused_route_hist_packed", "fused_route_hist_int_packed",
               "route_rows_packed", "route_rows_counts_packed",
               "build_histograms_int_packed",
               "build_histograms_scatter_int_packed")
# the split-search options: basic monotone constraints (+1 on feature 0,
# -1 on feature 1), interaction groups, per-tree and per-node sampling
CONSTRAINT_PARAMS = dict(
    TRAIN_PARAMS, monotone_constraints=[1, -1] + [0] * (N_FEATURES - 2),
    interaction_constraints=[list(range(0, 10)), list(range(10, 20)),
                             list(range(20, N_FEATURES))],
    feature_fraction=0.8, feature_fraction_bynode=0.8)
CONSTRAINT_TREES = 10
EXTRA_TREES = 3
CONSTRAINT_PATH = ("fused_route_hist", "route_rows", "node_values",
                   "fused_route_hist_int", "node_sums")
# K8 runs only where a caller asks grow_tree_mxu for it (use_scan_kernel)
SCAN_PATH = ("find_best_splits", "find_best_splits_mono")
SCAN_PLAIN_TREES = 3
MONO_ROWS = 2000      # held-out rows swept over a feature's bin bounds
# the path whose counts a kernel row reports
ROW_PATH = {**dict.fromkeys(EXACT_PATH, "exact"),
            **dict.fromkeys(("fused_route_hist_int", "build_histograms_int",
                             "node_sums"), "quantized"),
            **dict.fromkeys(BACKEND_PATH[:4], "backends"),
            **dict.fromkeys(PACKED_PATH, "packed"),
            **dict.fromkeys(SCAN_PATH, "scan")}


def make_higgs_like(n, f, seed=17):
    """The Higgs-like benchmark problem of the JAX package's bench.py."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    # nonlinear separation rule on a few "physics" features + noise dims
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3] +
             0.5 * np.abs(X[:, 4]) - 0.4 * X[:, 5] ** 2 +
             0.3 * X[:, 6] * X[:, 0] + 0.35 * rng.randn(n))
    y = (logit > np.median(logit)).astype(np.float32)
    return X, y


def check(ok, what):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + what)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def auc(score, label):
    """Tie-corrected ROC AUC (Mann-Whitney U with average ranks)."""
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    ends = np.cumsum(counts)
    avg_rank = (ends - (counts - 1) / 2.0)[inv]
    pos = label > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((avg_rank[pos].sum() - n_pos * (n_pos + 1) / 2.0) /
                 (n_pos * n_neg))


def time_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps runs, CUDA events around each
    run, after one warm-up run: what one call costs its caller, the host's
    launch path included (the device waits while the host prepares)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


_SLEEP_CYCLES_PER_MS = []


def device_ms(torch, fn, reps=20, trials=3, strict=True):
    """Device milliseconds of one fn(), host launch path excluded: reps
    calls are queued behind a torch.cuda._sleep that outlasts the host's
    enqueue of all of them (checked: the sleep is still running when the
    last call is queued), so they run back to back; CUDA events around the
    reps calls, divided by reps; median of `trials`. A fn that waits for
    the device (a host sync) cannot be queued: a check failure, or None
    (not measured) when not strict."""
    if not _SLEEP_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / a.elapsed_time(b))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS[0] * (3 * host_ms + 2)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if not strict and not queued:
            return None
        check(queued, "device_ms: the host had not queued every call when "
              "the sleep ended")
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def kernel_inputs(torch, hm, rng_mod, dev, bmax=BMAX, n_rows=N_ROWS,
                  n_features=N_FEATURES):
    """One growth pass's inputs at the slice's shapes: random bins below
    bmax, a 1024-node split table with numerical, NaN-bin and categorical
    splits, rows spread over its nodes, and the gradients quantized to
    int8."""
    rng = np.random.RandomState(7)
    num_bins = np.full(n_features, bmax, np.int32)
    num_bins[[3, 9]] = min(64, bmax)         # NaN-bin features
    num_bins[[5, 11]] = min(40, bmax)        # categorical features
    missing_is_nan = np.zeros(n_features, bool)
    missing_is_nan[[3, 9, 5, 11]] = True
    is_cat_feat = np.zeros(n_features, bool)
    is_cat_feat[[5, 11]] = True
    bins = (rng.rand(n_rows, n_features) * num_bins).astype(np.uint8)
    m1 = M_NODES - 4
    split = rng.rand(m1) < 0.6
    feat = rng.randint(0, n_features, m1)
    feat[:64] = 3
    feat[64:128] = n_features - 1            # packed: a high-nibble feature
    is_cat = is_cat_feat[feat]
    thr = (rng.rand(m1) * (num_bins[feat] - 1)).astype(np.int32)
    words = (bmax + 31) // 32
    bitset = rng.randint(0, 2 ** 32, (m1, words), dtype=np.uint64) \
        .astype(np.int64)
    bitset[~is_cat] = 0
    slot_of_node = rng.randint(-1, S_FUSED, m1)

    def t(a, dtype=None):
        return torch.as_tensor(a, device=dev) if dtype is None else \
            torch.as_tensor(a, dtype=dtype, device=dev)

    tbl, member = hm.pack_route_tables(
        t(split), t(feat, torch.int32), t(thr), t(rng.rand(m1) < 0.5),
        t(is_cat), t(rng.randint(0, m1, m1), torch.int32),
        t(rng.randint(0, m1, m1), torch.int32),
        t(slot_of_node, torch.int32), t(bitset), M_NODES)
    feat_tbl = torch.stack([t(num_bins), t(missing_is_nan, torch.int32)],
                           dim=1).contiguous()
    values = rng.randn(M_NODES).astype(np.float32)
    values[M_NODES - 1] = np.nan             # never referenced, as scratch
    grad = t(rng.randn(n_rows).astype(np.float32))
    hess = t(rng.uniform(0.1, 1.0, n_rows).astype(np.float32))
    g_q, h_q, _, _ = hm.quantize_gradients(grad, hess,
                                           rng_mod.PRNGKey(1, dev))
    return dict(
        bins=t(bins), grad=grad, hess=hess,
        g_q=g_q.to(torch.int8), h_q=h_q.to(torch.int8),
        cnt=torch.ones(n_rows, dtype=torch.float32, device=dev),
        row_node=t(rng.randint(0, m1, n_rows), torch.int32),
        row_slot=t(rng.randint(-1, S_HIST, n_rows), torch.int32),
        tbl=tbl, member=member, feat_tbl=feat_tbl, values=t(values),
        split=t(split))


def hist_err(torch, got, ref):
    """(max |grad/hess| error, count channel exact?, error bound): f32
    sums of the same rows in different orders agree to ~1e-6 of the
    largest cell; the bound is 1e-4 of it."""
    err = float((got[..., :2] - ref[..., :2]).abs().max())
    scale = float(ref[..., :2].abs().max())
    return err, bool(torch.equal(got[..., 2], ref[..., 2])), \
        1e-4 * max(scale, 1.0)


def index_add_fn(torch, bins, slot, cols, num_slots, bmax):
    """The library yardstick of a histogram kernel: one index_add_ of the
    rows' channels `cols` ([N, 3], f32 or int32) over the flattened
    (slot, feature, bin) cells of the rows whose slot is in range."""
    f = bins.shape[1]
    valid = torch.nonzero((slot >= 0) & (slot < num_slots))[:, 0]
    cells = ((slot[valid].long()[:, None] * f +
              torch.arange(f, device=bins.device)[None, :]) * bmax +
             bins[valid].long()).reshape(-1)
    vals = cols[valid][:, None].expand(-1, f, 3).reshape(-1, 3).contiguous()
    flat = torch.zeros((num_slots * f * bmax, 3), dtype=cols.dtype,
                       device=bins.device)
    return lambda: flat.index_add_(0, cells, vals)


def kernel_phase(torch, hm, hp, rng_mod, dev):
    d = kernel_inputs(torch, hm, rng_mod, dev)
    bins, grad, hess, cnt = d["bins"], d["grad"], d["hess"], d["cnt"]
    g_q, h_q = d["g_q"], d["h_q"]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    n, f = bins.shape
    rows = []

    def row(name, replaces, err, fn, plain_fn, plain_reps, nbytes, ops,
            library_fn, source=None):
        # ms: one call as the main path makes it (host launch path
        # included); device_ms: the device alone (back-to-back calls).
        # ops: one add per histogram cell update (f32 or int32), held to
        # the f32 rate outside the tensor cores; every row is bytes-bound
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"lightgbm_tpu_torch/csrc/{source or name}.cu",
            "replaces": replaces, "launches": None,  # set by the main path
            "max_abs_err": err, "ms": time_ms(torch, fn, 20),
            "device_ms": device_ms(torch, fn),
            "plain_ms": time_ms(torch, plain_fn, plain_reps),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": None if library_fn is None
            else time_ms(torch, library_fn, 20),
            "library_device_ms": None if library_fn is None
            else device_ms(torch, library_fn)})
        emit("kernel", **rows[-1])

    # rows whose node splits read one bin to route; rows landing in a slot
    # below S read all F bins and their channels, and add F x 3 values
    node_split = d["split"][d["row_node"].long()]
    n_routed = int(node_split.sum())
    table_bytes = d["tbl"].numel() * 4 + d["member"].numel() * 4

    # K2 route_rows
    rn, rs = hm.route_rows(bins, d["row_node"], *route)
    rn_ref, rs_ref = hm.route_rows_ref(bins, d["row_node"], *route)
    check(torch.equal(rn, rn_ref) and torch.equal(rs, rs_ref),
          "route_rows routing differs from its plain version")
    row("route_rows", "lightgbm_tpu/learner/histogram_mxu.py:1065", 0.0,
        lambda: hm.route_rows(bins, d["row_node"], *route),
        lambda: hm.route_rows_ref(bins, d["row_node"], *route), 5,
        12 * n + n_routed + table_bytes, 0, None)

    # K1 fused_route_hist at the bridge pass's 263 slots
    def k1():
        return hm.fused_route_hist(bins, grad, hess, cnt, d["row_node"],
                                   *route, num_slots=S_FUSED, bmax=BMAX)

    def k1_ref():
        return hm.fused_route_hist_ref(bins, grad, hess, cnt,
                                       d["row_node"], *route,
                                       num_slots=S_FUSED, bmax=BMAX)
    h, rn = k1()
    h_ref, rn_ref = k1_ref()
    check(torch.equal(rn, rn_ref), "fused_route_hist routing differs")
    err, cnt_ok, tol = hist_err(torch, h, h_ref)
    check(cnt_ok, "fused_route_hist count channel differs")
    check(err <= tol, f"fused_route_hist grad/hess error {err} > {tol}")
    n_slot = int(((rs_ref >= 0) & (rs_ref < S_FUSED)).sum())
    row("fused_route_hist", "lightgbm_tpu/learner/histogram_mxu.py:785",
        err, k1, k1_ref, 3,
        8 * n + n_routed + n_slot * (f + 12) + h.numel() * 4 + table_bytes,
        n_slot * f * 3, None)

    # K3 build_histograms at the fix-up passes' 511 slots
    rslot = d["row_slot"]

    def k3():
        return hm.build_histograms(bins, grad, hess, cnt, rslot,
                                   num_slots=S_HIST, bmax=BMAX)

    def k3_ref():
        return hm.build_histograms_ref(bins, grad, hess, cnt, rslot,
                                       num_slots=S_HIST, bmax=BMAX)
    h, h_ref = k3(), k3_ref()
    err, cnt_ok, tol = hist_err(torch, h, h_ref)
    check(cnt_ok, "build_histograms count channel differs")
    check(err <= tol, f"build_histograms grad/hess error {err} > {tol}")
    n_slot = int((rslot >= 0).sum())
    row("build_histograms", "lightgbm_tpu/learner/histogram_mxu.py:472",
        err, k3, k3_ref, 3,
        4 * n + n_slot * (f + 12) + h.numel() * 4, n_slot * f * 3,
        index_add_fn(torch, bins, rslot, torch.stack([grad, hess, cnt], 1),
                     S_HIST, BMAX))

    # K1 and K3 in integer mode (quantized int8 gradients, int32 cells):
    # order-free sums, so the kernels equal their plain versions exactly
    def k1q():
        return hm.fused_route_hist(bins, g_q, h_q, cnt, d["row_node"],
                                   *route, num_slots=S_FUSED, bmax=BMAX,
                                   quantized=True)

    def k1q_ref():
        return hm.fused_route_hist_ref(bins, g_q, h_q, cnt, d["row_node"],
                                       *route, num_slots=S_FUSED, bmax=BMAX,
                                       quantized=True)
    (h, rn), (h_ref, rn_ref) = k1q(), k1q_ref()
    check(torch.equal(rn, rn_ref) and torch.equal(h, h_ref),
          "fused_route_hist integer mode differs from its plain version")
    n_slot = int(((rs_ref >= 0) & (rs_ref < S_FUSED)).sum())
    row("fused_route_hist_int", "lightgbm_tpu/learner/histogram_mxu.py:785",
        0.0, k1q, k1q_ref, 3,
        8 * n + n_routed + n_slot * (f + 6) + h.numel() * 4 + table_bytes,
        n_slot * f * 3, None, source="fused_route_hist")

    def k3q():
        return hm.build_histograms(bins, g_q, h_q, cnt, rslot,
                                   num_slots=S_HIST, bmax=BMAX,
                                   quantized=True)

    def k3q_ref():
        return hm.build_histograms_ref(bins, g_q, h_q, cnt, rslot,
                                       num_slots=S_HIST, bmax=BMAX,
                                       quantized=True)
    h, h_ref = k3q(), k3q_ref()
    check(torch.equal(h, h_ref),
          "build_histograms integer mode differs from its plain version")
    row("build_histograms_int", "lightgbm_tpu/learner/histogram_mxu.py:472",
        0.0, k3q, k3q_ref, 3,
        4 * n + n_slot * (f + 6) + h.numel() * 4, n_slot * f * 3,
        index_add_fn(torch, bins, rslot, torch.stack(
            [g_q.int(), h_q.int(), cnt.int()], 1), S_HIST, BMAX),
        source="build_histograms")
    del h, h_ref

    backend_rows(torch, hm, hp, rng_mod, d, row, dev)
    packed_rows(torch, hm, hp, rng_mod, dev, row)
    split_rows(torch, hm, rng_mod, dev, row)

    # K6 node_values: the score update's gather over 1024 node values
    v = d["values"]
    node_values_checks(torch, hm, dev)
    out = hm.node_values(d["row_node"], v)
    out_ref = hm.node_values_ref(d["row_node"], v)
    check(torch.equal(out.view(torch.int32), out_ref.view(torch.int32)),
          "node_values differs")
    idx = d["row_node"].long()
    row("node_values", "lightgbm_tpu/learner/histogram_mxu.py:1248", 0.0,
        lambda: hm.node_values(d["row_node"], v),
        lambda: hm.node_values_ref(d["row_node"], v), 5,
        8 * n + v.numel() * 4, 0, lambda: v[idx])

    # K5 node_sums: the exact leaf refit at the pruned tree's 510 nodes
    # (and, checked only, the overgrown tree's 1020), 3% of rows parked at
    # -1 and 1% past the last node, as the kernel must ignore them
    rng = np.random.RandomState(9)

    def refit_nodes(m):
        node = rng.randint(0, m, N_ROWS)
        u = rng.rand(N_ROWS)
        node[u < 0.03] = -1
        node[(u >= 0.03) & (u < 0.04)] += m
        return torch.as_tensor(node.astype(np.int32), device=dev)

    for m in (M_GROWN, M_REFIT):
        node = refit_nodes(m)

        def k5():
            return hm.node_sums(node, grad, hess, cnt, num_nodes=m)

        def k5_ref():
            return hm.node_sums_ref(node, grad, hess, cnt, num_nodes=m)
        got, again, ref = k5(), k5(), k5_ref()
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"node_sums at {m} nodes: two launches differ")
        check(torch.equal(got[:, 2], ref[:, 2]),
              f"node_sums at {m} nodes: counts differ")
        err = float((got - ref).abs().max())
        # rtol 1e-6 of each sum, with a floor of 1 on the scale
        rel = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
        check(rel <= 1e-6, f"node_sums at {m} nodes: rel error {rel}")
    keep = torch.nonzero((node >= 0) & (node < M_REFIT))[:, 0]
    idx5 = node[keep].long()
    data5 = torch.stack([grad, hess, cnt], 1)[keep].contiguous()
    acc5 = torch.zeros((M_REFIT, 3), device=dev)
    row("node_sums", "lightgbm_tpu/learner/histogram_mxu.py:1192", err,
        k5, k5_ref, 5, 16 * n + M_REFIT * 12, 3 * int(keep.numel()),
        lambda: acc5.index_add_(0, idx5, data5))
    return rows


def backend_rows(torch, hm, hp, rng_mod, d, row, dev):
    """K2's counts mode, the partition kernel and K7 (the slot-grouped
    scatter kernel) at the hist_backend=pallas path's shapes: 1M x 28 rows
    routed into the autotune's 263 slots, the route counts handed to the
    partition. The partition is also held to its torch version at the root
    pass (1 slot), at 511 slots with 3% of rows parked, and counting for
    itself; K7 also at the root pass (one slot of ~1000 blocks: its runs
    write partials that the reduce adds) and at the wide shape (100k x 200,
    256 bins: several feature groups)."""
    bins, route, cnt = d["bins"], (d["tbl"], d["member"], d["feat_tbl"]), \
        d["cnt"]
    n, f = bins.shape
    node_split = d["split"][d["row_node"].long()]
    n_routed = int(node_split.sum())
    table_bytes = d["tbl"].numel() * 4 + d["member"].numel() * 4

    def k2c():
        return hm.route_rows(bins, d["row_node"], *route, emit_counts=True,
                             num_slots=S_TUNE)

    def k2c_ref():
        return hm.route_rows_ref(bins, d["row_node"], *route,
                                 emit_counts=True, num_slots=S_TUNE)
    got, (_, slot, counts) = k2c(), k2c_ref()
    check(all(torch.equal(a, b) for a, b in zip(got, (_, slot, counts))),
          "route_rows counts mode differs from its plain version")
    check(int(counts.sum()) == int(((slot >= 0) & (slot < S_TUNE)).sum()),
          "route counts do not add up to the slotted rows")
    row("route_rows_counts", "lightgbm_tpu/learner/histogram_mxu.py:1065",
        0.0, k2c, k2c_ref, 5,
        12 * n + n_routed + table_bytes + 4 * S_TUNE, 0, None,
        source="route_rows")

    partition_checks(torch, hp, slot, counts, dev)
    kw = dict(num_slots=S_TUNE, row_block=1024, counts=counts)
    tb = -(-n // 1024) + S_TUNE + 1

    def part():
        return hp.partition_rows(slot, **kw)

    def part_ref():
        return hp.partition_rows_ref(slot, **kw)
    # row_slot and counts read; block_slot, src and bounds written
    row("partition_rows", "lightgbm_tpu/learner/histogram_pallas.py:106",
        0.0, part, part_ref, 5,
        4 * n + 4 * S_TUNE + 4 * tb * 1025 + 4 * (S_TUNE + 2), 0, None)
    emit("kernel_detail", name="partition_rows",
         torch_partition_rows_ms=time_ms(torch, part_ref, 20),
         # None: the torch partition waits for the device
         torch_partition_rows_device_ms=device_ms(torch, part_ref,
                                                  strict=False),
         what="the torch partition that the kernel replaces "
              "(partition_rows_ref: stable radix sort, searchsorted, "
              "gathers), route counts given, 1M rows, 263 slots")

    def scatter(dd, sl, cts, quantized, num_slots=S_TUNE):
        """K7 against its plain version: (max abs error, kernel call, plain
        call)."""
        g, h = (dd["g_q"], dd["h_q"]) if quantized else \
            (dd["grad"], dd["hess"])
        kw = dict(num_slots=num_slots, bmax=BMAX, quantized=quantized,
                  slot_counts=cts)

        def k7():
            return hp.build_histograms_scatter(dd["bins"], g, h, dd["cnt"],
                                               sl, **kw)

        def k7_ref():
            return hp.build_histograms_scatter_ref(dd["bins"], g, h,
                                                   dd["cnt"], sl, **kw)
        got, want = k7(), k7_ref()
        if quantized:
            err = float((got - want).abs().max())
            check(torch.equal(got, want), "build_histograms_scatter integer "
                  "mode differs from its plain version")
        else:
            err, cnt_ok, tol = hist_err(torch, got, want)
            check(cnt_ok, "build_histograms_scatter count channel differs")
            check(err <= tol, f"build_histograms_scatter error {err} > {tol}")
        # the per-row histogram of the same rows, in the other backend
        check(torch.equal(got[..., 2], hm.build_histograms_ref(
            dd["bins"], g, h, dd["cnt"], sl, num_slots=num_slots, bmax=BMAX,
            quantized=quantized)[..., 2]), "K7 counts differ from K3's")
        return err, k7, k7_ref

    n_slot = int(((slot >= 0) & (slot < S_TUNE)).sum())
    for quantized, name, chan_bytes, cols in (
            (True, "build_histograms_scatter_int", 6,
             torch.stack([d["g_q"].int(), d["h_q"].int(), cnt.int()], 1)),
            (False, "build_histograms_scatter", 12,
             torch.stack([d["grad"], d["hess"], cnt], 1))):
        err, k7, k7_ref = scatter(d, slot, counts, quantized)
        row(name, "lightgbm_tpu/learner/histogram_pallas.py:211", err, k7,
            k7_ref, 3, 4 * n + n_slot * (f + chan_bytes) +
            S_TUNE * f * BMAX * 12, n_slot * f * 3,
            index_add_fn(torch, bins, slot, cols, S_TUNE, BMAX),
            source="build_histograms_scatter")

    # the root pass: every row in one slot (3% parked), ~1000 blocks
    root = torch.where(torch.rand(n, device=dev) < 0.03, -1, 0) \
        .to(torch.int32)
    root_counts = (root == 0).sum().reshape(1).to(torch.int32)
    for quantized in (True, False):
        err, k7, k7_ref = scatter(d, root, root_counts, quantized,
                                  num_slots=1)
        emit("kernel_check", name="build_histograms_scatter" +
             ("_int" if quantized else ""), rows=n, features=f, slots=1,
             max_abs_err=err, ms=time_ms(torch, k7, 20),
             device_ms=device_ms(torch, k7), plain_ms=time_ms(torch, k7_ref,
                                                              3))

    # the wide shape: 200 features, several feature groups
    dw = kernel_inputs(torch, hm, rng_mod, dev, n_rows=WIDE_ROWS,
                       n_features=WIDE_FEATURES)
    _, wslot, wcounts = hm.route_rows(
        dw["bins"], dw["row_node"], dw["tbl"], dw["member"], dw["feat_tbl"],
        emit_counts=True, num_slots=S_TUNE)
    for quantized in (True, False):
        err, k7, k7_ref = scatter(dw, wslot, wcounts, quantized)
        emit("kernel_check", name="build_histograms_scatter" +
             ("_int" if quantized else ""), rows=WIDE_ROWS,
             features=WIDE_FEATURES, slots=S_TUNE, max_abs_err=err,
             ms=time_ms(torch, k7, 20), device_ms=device_ms(torch, k7),
             plain_ms=time_ms(torch, k7_ref, 3))
    del dw


def partition_checks(torch, hp, slot, counts, dev):
    """The partition kernel against partition_rows_ref, element for
    element (block_slot and src; the kernel's slot bounds against
    slot_bounds of the torch layout): at 263 slots with route counts, at
    the root pass (1 slot, 3% parked), at 511 slots with 3% parked, and
    counting for itself (counts=None) at 263 slots."""
    rng = np.random.RandomState(13)
    u = rng.rand(N_ROWS)
    s511 = rng.randint(0, S_HIST, N_ROWS)
    s511[u < 0.03] = -1
    root = np.where(u < 0.03, -1, 0)

    def live_counts(sl, s):
        sl = sl[(sl >= 0) & (sl < s)].long()
        return torch.bincount(sl, minlength=s).to(torch.int32)

    cases = []
    for what, sl, s, c in (
            ("263 slots, route counts", slot, S_TUNE, counts),
            ("1 slot (root pass), 3% parked", root, 1, None),
            ("511 slots, 3% parked", s511, S_HIST, None),
            ("263 slots, counts=None", slot, S_TUNE, None)):
        sl = torch.as_tensor(sl, dtype=torch.int32, device=dev)
        if c is None and "counts=None" not in what:
            c = live_counts(sl, s)
        block_slot, src, bounds = hp._partition(sl, s, 1024, c, "auto")
        want_bs, want_src = hp.partition_rows_ref(sl, num_slots=s,
                                                  row_block=1024, counts=c)
        equal = torch.equal(block_slot, want_bs) and torch.equal(src,
                                                                 want_src)
        check(equal, f"partition kernel differs from partition_rows_ref: "
              f"{what}")
        check(torch.equal(bounds[:s + 1].long(),
                          hp.slot_bounds(want_bs, s)),
              f"partition kernel slot bounds differ: {what}")
        cases.append(what)
    emit("partition_check", cases=cases, equal=True)


def node_values_checks(torch, hm, dev):
    """K6 bit for bit against node_values_ref with ids out of range (-1
    and >= M) and +inf, -inf and NaN table entries, at M = 1024 (the table
    staged in shared memory) and M = 1500 (read through the cache), and at
    an id vector that starts 4 bytes into its storage (scalar accesses)."""
    rng = np.random.RandomState(21)
    for m in (1024, 1500):
        values = rng.randn(m).astype(np.float32)
        values[[3, 17, m - 1]] = [np.inf, -np.inf, np.nan]
        node = rng.randint(-1, m + 2, N_ROWS + 3).astype(np.int32)
        node[:3] = [3, 17, m - 1]
        v = torch.as_tensor(values, device=dev)
        t = torch.as_tensor(node, device=dev)
        for ids in (t[:N_ROWS], t[1:N_ROWS + 1]):
            got, want = hm.node_values(ids, v), hm.node_values_ref(ids, v)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"node_values differs at M = {m}")
        emit("kernel_check", name="node_values", table=m,
             out_of_range=int(((t < 0) | (t >= m)).sum()),
             non_finite_entries=3, bit_equal=True)


def packed_rows(torch, hm, hp, rng_mod, dev, row):
    """The 4-bit packed modes of K1, K2 (plain and counts), K4 (behind
    build_histograms_auto) and K7 at the max_bin 15 path's shapes: 1M rows
    x 28 features packed into 14 bytes a row, 15 bins."""
    d = kernel_inputs(torch, hm, rng_mod, dev, bmax=BMAX_PACKED)
    n, f = d["bins"].shape
    pk = torch.as_tensor(hm.pack_bins_4bit(d["bins"].cpu().numpy()),
                         device=dev)
    check(tuple(pk.shape) == (n, (f + 1) // 2), "packed width")
    fh = pk.shape[1]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    rnode, cnt = d["row_node"], d["cnt"]
    node_split = d["split"][rnode.long()]
    n_routed = int(node_split.sum())
    table_bytes = d["tbl"].numel() * 4 + d["member"].numel() * 4
    src = "lightgbm_tpu/learner/histogram_mxu.py"

    for counts_mode in (False, True):
        kw = dict(num_features=f, emit_counts=counts_mode, num_slots=S_TUNE)

        def k2p():
            return hm.route_rows(pk, rnode, *route, **kw)

        def k2p_ref():
            return hm.route_rows_ref(pk, rnode, *route, **kw)
        got, want = k2p(), k2p_ref()
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and
              all(torch.equal(a, b) for a, b in zip(want, hm.route_rows_ref(
                  d["bins"], rnode, *route, emit_counts=counts_mode,
                  num_slots=S_TUNE))),
              f"route_rows packed (counts={counts_mode}) differs")
        row("route_rows" + "_counts" * counts_mode + "_packed",
            src + ":1065", 0.0, k2p, k2p_ref, 3,
            12 * n + n_routed + table_bytes + 4 * S_TUNE * counts_mode, 0,
            None, source="route_rows")
    _, slot, counts = want

    for quantized in (False, True):
        g, h = (d["g_q"], d["h_q"]) if quantized else (d["grad"], d["hess"])
        kw = dict(num_slots=S_FUSED, bmax=BMAX_PACKED, quantized=quantized,
                  num_features=f)

        def k1p():
            return hm.fused_route_hist(pk, g, h, cnt, rnode, *route, **kw)

        def k1p_ref():
            return hm.fused_route_hist_ref(pk, g, h, cnt, rnode, *route,
                                           **kw)
        (hist, rn), (h_ref, rn_ref) = k1p(), k1p_ref()
        check(torch.equal(rn, rn_ref), "fused_route_hist packed routing")
        if quantized:
            err = 0.0
            check(torch.equal(hist, h_ref),
                  "fused_route_hist packed integer mode differs")
        else:
            err, cnt_ok, tol = hist_err(torch, hist, h_ref)
            check(cnt_ok and err <= tol,
                  f"fused_route_hist packed error {err} > {tol}")
        n_slot = int(((slot >= 0) & (slot < S_FUSED)).sum())
        chan = 6 if quantized else 12
        row("fused_route_hist" + "_int" * quantized + "_packed",
            src + ":785", err, k1p, k1p_ref, 3,
            8 * n + n_routed + n_slot * (fh + chan) + hist.numel() * 4 +
            table_bytes, n_slot * f * 3, None, source="fused_route_hist")

    # K4 (the v2 kernel's function on packed bins) and K7, integer mode,
    # at the autotune's 263 slots: what hist_backend=auto times
    n_slot = int(((slot >= 0) & (slot < S_TUNE)).sum())
    cols = torch.stack([d["g_q"].int(), d["h_q"].int(), cnt.int()], 1)
    lib = index_add_fn(torch, d["bins"], slot, cols, S_TUNE, BMAX_PACKED)
    check(hm.fits_v2(S_TUNE, f, BMAX_PACKED, True),
          "the packed K4 shape does not take the v2 kernel")
    kw = dict(num_slots=S_TUNE, bmax=BMAX_PACKED, quantized=True,
              num_features=f)
    want = hm.build_histograms_ref(d["bins"], d["g_q"], d["h_q"], cnt, slot,
                                   num_slots=S_TUNE, bmax=BMAX_PACKED,
                                   quantized=True)
    for name, fn, fn_ref, replaces in (
            ("build_histograms_int_packed", hm.build_histograms_auto,
             hm.build_histograms_ref, src + ":608"),
            ("build_histograms_scatter_int_packed",
             lambda *a, **k: hp.build_histograms_scatter(
                 *a, slot_counts=counts, **k),
             lambda *a, **k: hp.build_histograms_scatter_ref(
                 *a, slot_counts=counts, **k),
             "lightgbm_tpu/learner/histogram_pallas.py:211")):
        def k():
            return fn(pk, d["g_q"], d["h_q"], cnt, slot, **kw)

        def k_ref():
            return fn_ref(pk, d["g_q"], d["h_q"], cnt, slot, **kw)
        got = k()
        check(torch.equal(got, k_ref()) and torch.equal(got, want),
              f"{name} differs from its plain version or from unpacked bins")
        row(name, replaces, 0.0, k, k_ref, 3,
            4 * n + n_slot * (fh + 6) + got.numel() * 4, n_slot * f * 3,
            lib, source=name.replace("_int_packed", ""))

    # K7 packed at the root pass: one slot, runs through the reduce
    root = torch.where(torch.rand(n, device=dev) < 0.03, -1, 0) \
        .to(torch.int32)
    kw = dict(num_slots=1, bmax=BMAX_PACKED, quantized=True, num_features=f,
              slot_counts=(root == 0).sum().reshape(1).to(torch.int32))

    def k7p():
        return hp.build_histograms_scatter(pk, d["g_q"], d["h_q"], cnt, root,
                                           **kw)
    got = k7p()
    check(torch.equal(got, hp.build_histograms_scatter_ref(
        pk, d["g_q"], d["h_q"], cnt, root, **kw)),
        "build_histograms_scatter packed differs at the root pass")
    emit("kernel_check", name="build_histograms_scatter_int_packed", rows=n,
         features=f, slots=1, max_abs_err=0.0, ms=time_ms(torch, k7p, 20),
         device_ms=device_ms(torch, k7p))


def split_rows(torch, hm, rng_mod, dev, row):
    """K8 (find_best_splits) at the scan path's shapes: histograms of the
    1M x 28 kernel inputs (two NaN-bin and two categorical features) in
    511 slots (the fix-up passes' scan width) and 263, random per-slot
    feature masks; plain mode and monotone mode (+1 on feature 0, -1 on
    feature 1, per-slot output bounds, depth penalty); every 37th slot is
    empty. Each launch is held to the plain version on every slot: the
    selection (has_split, feature, threshold, NaN direction) equal, the
    picked sums within 1e-6 relative."""
    from lightgbm_tpu_torch.learner import split_kernel as sk
    from lightgbm_tpu_torch.learner.split import (SplitHyperParams,
                                                  find_best_splits)
    d = kernel_inputs(torch, hm, rng_mod, dev)
    f = d["bins"].shape[1]
    num_bins, missing_is_nan = d["feat_tbl"][:, 0], d["feat_tbl"][:, 1] > 0
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[[5, 11]] = True
    rng = np.random.RandomState(11)
    plain = SplitHyperParams(min_data_in_leaf=20)
    mono_hp = dataclasses.replace(plain, has_monotone=True,
                                  monotone_penalty=1.5)
    monotone = torch.zeros(f, dtype=torch.int32, device=dev)
    monotone[0], monotone[1] = 1, -1

    def t(a):
        return torch.as_tensor(a, device=dev)
    for s in (S_HIST, S_FUSED):
        hist = hm.build_histograms(d["bins"], d["grad"], d["hess"], d["cnt"],
                                   d["row_slot"], num_slots=s, bmax=BMAX)
        hist[::37] = 0.0        # empty slots: no split, the junk selection
        sums = hist[:, 0].sum(1)                                   # [S, 3]
        args = (hist, sums[:, 0], sums[:, 1], sums[:, 2],
                t(rng.randn(s).astype(np.float32) * 0.1), num_bins,
                missing_is_nan, is_cat,
                t((rng.rand(s, f) < 0.8).astype(np.float32)))
        bound = t(rng.uniform(0.05, 0.5, s).astype(np.float32))
        mono_kw = dict(monotone=monotone, cons_min=-bound, cons_max=bound,
                       depth=t(rng.randint(0, 12, s).astype(np.int32)))
        for name, hp, kw in (("find_best_splits", plain, {}),
                             ("find_best_splits_mono", mono_hp, mono_kw)):
            tables = sk.pack_inputs(*args[1:], hp, **kw)

            def k8():
                return sk._launch(hist, *tables, hp)

            def k8_ref():
                return sk.find_best_splits_kernel_ref(hist, *tables, hp)
            got, want = k8(), k8_ref()
            torch.cuda.synchronize()
            sel = slice(sk.O_HAS, sk.O_NAL + 1)
            check(torch.equal(got[:, sel], want[:, sel]),
                  f"{name} at {s} slots: the selection differs from its "
                  "plain version on slots " + str(torch.nonzero(
                      (got[:, sel] != want[:, sel]).any(1))[:8, 0].tolist()))
            sums_sel = slice(sk.O_LR, sk.O_LL + 3)
            diff = (got[:, sums_sel] - want[:, sums_sel]).abs()
            err = float(diff.max())
            rel = float((diff / want[:, sums_sel].abs().clamp(
                min=1e-30)).max())
            check(rel <= 1e-6, f"{name} at {s} slots: picked sums rel "
                  f"error {rel}")
            n_split = int(got[:, sk.O_HAS].sum())
            # every input read once: the histograms and the small tables
            nbytes = hist.numel() * 4 + sum(x.numel() * 4 for x in tables
                                            if x is not None) + \
                s * sk.N_OUT * 4
            # ~50 f32 ops a candidate (two NaN options of split.py's
            # gain forms), ~70 with the monotone clip and penalty
            ops = s * f * BMAX * (70 if kw else 50)
            whole = dict(
                wrapper_ms=time_ms(torch, lambda: sk.find_best_splits_kernel(
                    *args, hp, **kw), 20),
                find_best_splits_ms=time_ms(torch, lambda: find_best_splits(
                    *args, hp, **kw), 20))
            if s == S_HIST:
                row(name, "lightgbm_tpu/learner/split_kernel.py:249", err,
                    k8, k8_ref, 5, nbytes, ops, None,
                    source="find_best_splits")
                emit("kernel_detail", name=name, slots=s, slots_split=n_split,
                     what="the whole wrapper (kernel + [S] recompute) and "
                          "split.find_best_splits on the same inputs",
                     **whole)
            else:
                emit("kernel_check", name=name, slots=s, slots_split=n_split,
                     max_abs_err=err, ms=time_ms(torch, k8, 20),
                     device_ms=device_ms(torch, k8),
                     plain_ms=time_ms(torch, k8_ref, 5),
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, **whole)
    del d


def train_booster(name, torch, lgt, hm, ds, params, trees, metric,
                  leaf_check=True, on_grow=None):
    """Train `trees` iterations on a constructed Dataset; returns the
    booster, the training seconds, the metric after every tree and the
    kernel launches this run added. Then holds every leaf of every tree to
    -G/H of the rows it holds (float64 sums of that tree's gradients; the
    configurations here have no regularisation of leaf values), within
    LEAF_TOL, and prints the largest difference as the phase `leaf_check`
    of run `name`. Monotone constraints clip leaves to their bounds, so a
    constrained run passes leaf_check=False and is checked for
    monotonicity instead (check_constraints). on_grow(gbdt, grad, hess,
    tree, row_node) sees every tree the booster grows, before the booster
    uses it."""
    booster = lgt.Booster(params, ds)
    gbdt = booster.gbdt
    grown = []
    grow = gbdt._grow

    def kept_grow(grad, hess):
        tree, row_node = grow(grad, hess)
        if on_grow is not None:
            on_grow(gbdt, grad, hess, tree, row_node)
        grown.append((tree.leaf_value, row_node, grad, hess))
        return tree, row_node
    gbdt._grow = kept_grow
    before = hm.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = []
    for _ in range(trees):
        booster.update()
        values.append(float(metric(gbdt.train_score)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in hm.launch_counts().items()}
    del gbdt._grow
    if not leaf_check:
        return booster, seconds, values, launches
    errs, biggest = [], 0.0
    for leaf_value, row_node, grad, hess in grown:
        node = row_node.long()
        rows = torch.stack([grad, hess, torch.ones_like(grad)], 1).double()
        sums = torch.zeros((leaf_value.shape[0], 3), dtype=torch.float64,
                           device=node.device).index_add_(0, node, rows)
        leaf = sums[:, 2] > 0
        want = -sums[leaf, 0] / sums[leaf, 1]
        errs.append(float((leaf_value.double()[leaf] - want).abs().max()))
        biggest = max(biggest, float(leaf_value[leaf].abs().max()))
    emit("leaf_check", run=name, max_leaf_err=max(errs),
         max_leaf_err_per_tree=errs, max_abs_leaf_value=biggest)
    check(max(errs) <= LEAF_TOL, f"{name}: a leaf value is {max(errs)} off "
          "-G/H of its rows")
    return booster, seconds, values, launches


def logloss_of(torch, y):
    ysign = 2.0 * torch.as_tensor(y, device="cuda") - 1.0
    return lambda score: torch.nn.functional.softplus(-ysign * score).mean()


def main_path(torch, lgt, hm, X, y):
    """The exact-histogram path: training through lightgbm_tpu_torch's
    entry points at the full 1M x 28 width, three settings of the same
    model — the Higgs-like binary configuration, the same with a large
    min_data_in_leaf (trees stop short of the leaf budget after the bridge
    pass, so the full-width fix-up passes run: route_rows +
    build_histograms), and the default regression objective
    (const-hessian channels). Kernel launches are counted over all three.
    Returns the binary booster, both datasets and the counts."""
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=TRAIN_PARAMS)
    ds.construct()
    binning_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    logloss = logloss_of(torch, y)

    hm.reset_launch_counts()
    booster, train_s, losses, launches = train_booster(
        "train", torch, lgt, hm, ds, TRAIN_PARAMS, TRAIN_TREES, logloss)
    emit("train", rows=N_ROWS, features=N_FEATURES, trees=TRAIN_TREES,
         binning_s=binning_s, train_s=train_s,
         trees_per_s=TRAIN_TREES / train_s, launches=launches,
         logloss=losses,
         leaves=[int(t.num_leaves) for t in booster.gbdt.trees])
    check(all(b <= a + 1e-7 for a, b in zip(losses, losses[1:])) and
          losses[-1] < losses[0], f"training logloss did not fall: {losses}")

    fix_params = dict(TRAIN_PARAMS, min_data_in_leaf=FIXUP_MIN_DATA)
    _, fix_s, fix_losses, fix_launches = train_booster(
        "train_fixups", torch, lgt, hm, ds, fix_params, TRAIN_TREES, logloss)
    emit("train_fixups", min_data_in_leaf=FIXUP_MIN_DATA,
         trees=TRAIN_TREES, train_s=fix_s,
         trees_per_s=TRAIN_TREES / fix_s, launches=fix_launches,
         logloss=fix_losses)
    check(fix_losses[-1] < fix_losses[0], "fix-up run logloss did not fall")

    # a continuous target from the same features: the default objective,
    # whose constant hessian drops the kernels' hessian channel
    y_reg = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3] +
             0.5 * np.abs(X[:, 4])).astype(np.float32)
    reg_params = {k: v for k, v in TRAIN_PARAMS.items() if k != "objective"}
    reg_ds = lgt.Dataset(X, label=y_reg, params=reg_params)
    label = torch.as_tensor(y_reg, device=dev)
    reg, reg_s, l2, reg_launches = train_booster(
        "regression", torch, lgt, hm, reg_ds, reg_params, REGRESSION_TREES,
        lambda score: ((score - label) ** 2).mean())
    emit("regression", trees=REGRESSION_TREES, train_s=reg_s,
         trees_per_s=REGRESSION_TREES / reg_s, launches=reg_launches, l2=l2,
         const_hessian=reg.gbdt._const_hessian())
    check(reg.gbdt._const_hessian() == 1.0,
          "regression lost the const hessian")
    check(all(b < a for a, b in zip(l2, l2[1:])), f"L2 did not fall: {l2}")
    counts = hm.launch_counts()
    for name in EXACT_PATH:
        check(counts[name] > 0, f"{name} was not launched on the exact path")
    return booster, ds, reg_ds, counts


def quantized_path(torch, lgt, hm, X, y, ds, reg_ds):
    """The quantized-gradient path (use_quantized_grad): the binary
    configuration at 1M x 28 (10 trees; every pass on the fused kernel in
    integer mode), the default regression objective (constant hessian:
    2 integer channels, 3 trees) and a 200-feature binary run (3 trees)
    whose wide passes take route_rows + build_histograms in integer mode.
    Every tree ends in the node_sums refit. Launches are counted over all
    three; returns the binary booster and the counts."""
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    booster, train_s, losses, launches = train_booster(
        "train_quantized", torch, lgt, hm, ds, QUANT_PARAMS, TRAIN_TREES,
        logloss)
    emit("train_quantized", rows=N_ROWS, features=N_FEATURES,
         trees=TRAIN_TREES, train_s=train_s,
         trees_per_s=TRAIN_TREES / train_s, launches=launches,
         logloss=losses,
         leaves=[int(t.num_leaves) for t in booster.gbdt.trees])
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"quantized logloss did not fall every tree: {losses}")

    reg_params = {k: v for k, v in QUANT_PARAMS.items() if k != "objective"}
    label = torch.as_tensor(reg_ds.label, device="cuda")
    reg, reg_s, l2, reg_launches = train_booster(
        "regression_quantized", torch, lgt, hm, reg_ds, reg_params,
        REGRESSION_TREES,
        lambda score: ((score - label) ** 2).mean())
    emit("regression_quantized", trees=REGRESSION_TREES, train_s=reg_s,
         trees_per_s=REGRESSION_TREES / reg_s, launches=reg_launches, l2=l2,
         const_hessian=reg.gbdt._const_hessian())
    check(reg.gbdt._const_hessian() == 1.0,
          "quantized regression lost the const hessian")
    check(all(b < a for a, b in zip(l2, l2[1:])),
          f"quantized L2 did not fall: {l2}")

    Xw, yw = make_higgs_like(WIDE_ROWS, WIDE_FEATURES, seed=23)
    t0 = time.perf_counter()
    wide_ds = lgt.Dataset(Xw, label=yw, params=QUANT_PARAMS)
    wide_ds.construct()
    wide_binning_s = time.perf_counter() - t0
    _, wide_s, wide_losses, wide_launches = train_booster(
        "train_quantized_wide", torch, lgt, hm, wide_ds, QUANT_PARAMS,
        WIDE_TREES,
        logloss_of(torch, yw))
    emit("train_quantized_wide", rows=WIDE_ROWS, features=WIDE_FEATURES,
         trees=WIDE_TREES, binning_s=wide_binning_s, train_s=wide_s,
         trees_per_s=WIDE_TREES / wide_s, launches=wide_launches,
         logloss=wide_losses)
    check(all(b < a for a, b in zip(wide_losses, wide_losses[1:])),
          f"wide quantized logloss did not fall: {wide_losses}")
    counts = hm.launch_counts()
    for name in QUANT_PATH:
        check(counts[name] > 0,
              f"{name} was not launched on the quantized path")
    check(wide_launches["build_histograms_int"] > 0,
          "the wide run took no two-kernel pass")
    n_trees = TRAIN_TREES + REGRESSION_TREES + WIDE_TREES
    check(counts["node_sums"] == n_trees,
          f"node_sums launched {counts['node_sums']} times for {n_trees} "
          "quantized trees")
    return booster, counts


def model_trees(text):
    """Model text up to its trees' end, the hist_backend and bin_pack_4bit
    echoes dropped: the lines that differ between runs of the same trees
    under other backends or storage (the feature importances after the
    trees count every tree of the run)."""
    return "\n".join(line for line in text.split("end of trees")[0]
                     .splitlines()
                     if not line.startswith(("[hist_backend:",
                                             "[bin_pack_4bit:")))


def held_out_auc(booster, num_iteration=None):
    Xva, yva = make_higgs_like(40_000, N_FEATURES, seed=99)
    return auc(booster.predict(Xva, raw_score=True,
                               num_iteration=num_iteration), yva)


def backends_path(torch, lgt, hm, X, y, ds, mxu_q, mxu_exact):
    """The histogram backends on the binary configuration at 1M x 28:
    quantized under hist_backend pallas (10 trees: every pass routes with
    counts and builds with the scatter kernel), scatter (3 trees: the
    segment-sum oracle) and auto (10 trees: the autotune at 263 slots
    picks mxu or pallas), each byte-equal in its trees to the quantized
    mxu run `mxu_q`; exact under pallas (3 trees), whose held-out AUC must
    be within 0.005 of the exact mxu run `mxu_exact` at 3 trees. Returns
    the launch counts."""
    logloss = logloss_of(torch, y)
    want = model_trees(mxu_q.model_to_string())
    want3 = model_trees(mxu_q.model_to_string(num_iteration=BACKEND_TREES))
    hm.reset_launch_counts()
    for backend, trees, want_text in (("pallas", TRAIN_TREES, want),
                                      ("scatter", BACKEND_TREES, want3),
                                      ("auto", TRAIN_TREES, want)):
        params = dict(QUANT_PARAMS, hist_backend=backend)
        booster, train_s, losses, launches = train_booster(
            "train_quantized_" + backend, torch, lgt, hm, ds, params, trees,
            logloss)
        tune = booster.gbdt._hist_autotune
        equal = model_trees(booster.model_to_string()) == want_text
        emit("train_quantized_" + backend, trees=trees, train_s=train_s,
             trees_per_s=trees / train_s, launches=launches, logloss=losses,
             resolved=tune["choice"], autotune_ms=tune["timings_ms"],
             model_txt_byte_equal_to_mxu=equal)
        check(equal, f"hist_backend={backend} model.txt differs from mxu")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"{backend} quantized logloss did not fall: {losses}")
        if backend == "auto":
            # a backend that fails inside the autotune times as +inf
            check(tune["autotuned"] and set(tune["timings_ms"]) ==
                  {"mxu", "pallas"} and all(map(
                      math.isfinite, tune["timings_ms"].values())),
                  f"auto did not time both backends: {tune}")
            continue
        check(tune["choice"] == backend and launches["route_rows_counts"] >
              0 and launches["fused_route_hist_int"] == 0,
              f"{backend}: passes did not route with counts: {launches}")
        check((launches["build_histograms_scatter_int"] > 0) ==
              (backend == "pallas"), f"{backend}: K7 launches {launches}")

    params = dict(TRAIN_PARAMS, hist_backend="pallas")
    booster, train_s, losses, launches = train_booster(
        "train_exact_pallas", torch, lgt, hm, ds, params, BACKEND_TREES,
        logloss)
    got_auc = held_out_auc(booster)
    want_auc = held_out_auc(mxu_exact, BACKEND_TREES)
    emit("train_exact_pallas", trees=BACKEND_TREES, train_s=train_s,
         trees_per_s=BACKEND_TREES / train_s, launches=launches,
         logloss=losses, held_out_auc=got_auc, mxu_held_out_auc=want_auc)
    check(launches["build_histograms_scatter"] > 0,
          "exact pallas run launched no f32 scatter kernel")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"exact pallas logloss did not fall: {losses}")
    check(abs(got_auc - want_auc) <= 0.005,
          f"exact pallas AUC {got_auc} vs mxu {want_auc}")
    counts = hm.launch_counts()
    for name in BACKEND_PATH:
        check(counts[name] > 0, f"{name} was not launched on the backends "
              "path")
    check_partition_launches(counts, "backends")
    return counts


def check_partition_launches(counts, path):
    """Every K7 call partitions its rows through the partition kernel:
    one partition launch per K7 launch, none through torch."""
    k7 = sum(counts[k] for k in K7_KEYS)
    check(counts["partition_rows"] == k7 > 0, f"the {path} path launched "
          f"{counts['partition_rows']} partitions for {k7} K7 calls")


def packed_path(torch, lgt, hm, X, y):
    """4-bit packed bins: the binary configuration at max_bin 15 (1M x 28,
    packed into 14 bytes a row), exact and quantized under mxu (10 trees
    each), each held to the same run on unpacked bins (bin_pack_4bit
    false): the exact run's held-out AUC within 0.005, the quantized run
    byte-equal; then quantized under auto and pallas (3 trees each),
    byte-equal in their trees. Returns the launch counts of the packed
    runs."""
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=PACKED_PARAMS)
    ds.construct()
    binning_s = time.perf_counter() - t0
    logloss = logloss_of(torch, y)
    quant = dict(PACKED_PARAMS, use_quantized_grad=True, hist_backend="mxu")
    hm.reset_launch_counts()
    runs = {}
    for name, params, trees in (
            ("train_packed", PACKED_PARAMS, TRAIN_TREES),
            ("train_packed_quantized", quant, TRAIN_TREES),
            ("train_packed_quantized_auto", dict(quant, hist_backend="auto"),
             BACKEND_TREES),
            ("train_packed_quantized_pallas",
             dict(quant, hist_backend="pallas"), BACKEND_TREES)):
        booster, train_s, losses, launches = train_booster(
            name, torch, lgt, hm, ds, params, trees, logloss)
        g = booster.gbdt
        runs[name] = booster
        emit(name, trees=trees, binning_s=binning_s, train_s=train_s,
             trees_per_s=trees / train_s, launches=launches, logloss=losses,
             bin_bytes_per_row=g.bins.shape[1],
             resolved=g._hist_autotune["choice"],
             autotune_ms=g._hist_autotune["timings_ms"])
        check(g._packed4 and tuple(g.bins.shape) == (N_ROWS, 14),
              f"{name}: bins not packed: {tuple(g.bins.shape)}")
        check(all(map(math.isfinite,
                      g._hist_autotune["timings_ms"].values())),
              f"{name}: autotune timings {g._hist_autotune}")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"{name} logloss did not fall every tree: {losses}")
    counts = hm.launch_counts()

    unpacked, _, _, _ = train_booster(
        "train_packed_quantized_unpacked", torch, lgt, hm, ds,
        dict(quant, bin_pack_4bit=False), TRAIN_TREES, logloss)
    check(not unpacked.gbdt._packed4, "bin_pack_4bit=false packed the bins")
    # exact growth adds with atomics in an order that varies, so packed and
    # unpacked storage are held to each other by quality, not bytes
    exact_unpacked, _, unpacked_losses, _ = train_booster(
        "train_packed_unpacked", torch, lgt, hm, ds,
        dict(PACKED_PARAMS, bin_pack_4bit=False), TRAIN_TREES, logloss)
    check(not exact_unpacked.gbdt._packed4,
          "bin_pack_4bit=false packed the exact run's bins")
    check(all(b < a for a, b in zip(unpacked_losses, unpacked_losses[1:])),
          f"exact unpacked logloss did not fall every tree: "
          f"{unpacked_losses}")
    exact_auc = {"packed": held_out_auc(runs["train_packed"]),
                 "unpacked": held_out_auc(exact_unpacked)}
    q = runs["train_packed_quantized"]
    want3 = model_trees(q.model_to_string(num_iteration=BACKEND_TREES))
    equal = {
        "unpacked": model_trees(unpacked.model_to_string()) ==
        model_trees(q.model_to_string()),
        "auto": model_trees(runs["train_packed_quantized_auto"]
                            .model_to_string()) == want3,
        "pallas": model_trees(runs["train_packed_quantized_pallas"]
                              .model_to_string()) == want3}
    emit("packed_check", model_txt_byte_equal_to_packed_mxu=equal,
         exact_held_out_auc=exact_auc,
         exact_unpacked_logloss=unpacked_losses,
         quantized_held_out_auc=held_out_auc(q))
    for what, ok in equal.items():
        check(ok, f"packed quantized model.txt differs from {what}")
    check(abs(exact_auc["packed"] - exact_auc["unpacked"]) <= 0.005,
          f"exact packed vs unpacked held-out AUC {exact_auc}")
    for name in PACKED_PATH:
        check(counts[name] > 0, f"{name} was not launched on the packed "
              "path")
    check_partition_launches(counts, "packed")
    return counts


def tree_blocks(text):
    """The trees of a model text (its Tree= blocks)."""
    return text.split("end of trees")[0].split("Tree=", 1)[1]


def check_constraints(booster, ds, name):
    """CONSTRAINT_PARAMS on a trained booster: every split feature of tree
    i lies in the booster's feature_fraction mask of iteration i; every
    root-to-leaf path uses the features of one interaction group; held-out
    predictions are non-decreasing in feature 0 and non-increasing in
    feature 1 when each sweeps its bin upper bounds with the other features
    held (MONO_ROWS rows). Returns (held-out AUC, largest step against the
    constraint, which must be <= 0)."""
    gbdt = booster.gbdt
    groups = [set(g) for g in CONSTRAINT_PARAMS["interaction_constraints"]]
    for i, tree in enumerate(gbdt.trees):
        nn = int(tree.num_nodes)
        feat = tree.split_feature[:nn].cpu().numpy()
        parent = tree.parent[:nn].cpu().numpy()
        mask = gbdt._feature_mask_at(i).cpu().numpy()
        check(all(mask[j] > 0 for j in feat[feat >= 0]),
              f"{name}: tree {i} splits on a feature outside its "
              "feature_fraction mask")
        for leaf in np.nonzero(tree.is_leaf[:nn].cpu().numpy())[0]:
            path, a = set(), parent[leaf]
            while a >= 0:
                path.add(int(feat[a]))
                a = parent[a]
            check(any(path <= g for g in groups),
                  f"{name}: tree {i} path {sorted(path)} crosses the "
                  "interaction groups")
    Xva, yva = make_higgs_like(40_000, N_FEATURES, seed=99)
    held = auc(booster.predict(Xva, raw_score=True), yva)
    worst = -np.inf
    for j, sign in ((0, 1.0), (1, -1.0)):
        ub = np.asarray(ds.binned.mappers[j].bin_upper_bound, np.float64)
        grid = ub[np.isfinite(ub)].astype(np.float32)
        sweep = np.repeat(Xva[:MONO_ROWS], len(grid), axis=0)
        sweep[:, j] = np.tile(grid, MONO_ROWS)
        pred = booster.predict(sweep, raw_score=True).reshape(MONO_ROWS, -1)
        worst = max(worst, float(np.max(-sign * np.diff(pred, axis=1))))
    return held, worst


def constraints_path(torch, lgt, hm, y, ds, exact):
    """The split-search options through the booster at 1M x 28, exact
    histograms' launch counts and all: CONSTRAINT_PARAMS exact and quantized
    (hist_backend mxu; two identical runs must write byte-equal model
    text), 10 trees each, held to check_constraints and a held-out AUC
    above 0.75; then extra_trees (3 trees, leaf_check), AUC above 0.7 and
    trees that differ from the exact run `exact`'s first three. Returns
    the launch counts."""
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    quant = dict(CONSTRAINT_PARAMS, use_quantized_grad=True,
                 hist_backend="mxu")
    for name, params in (("train_constraints", CONSTRAINT_PARAMS),
                         ("train_constraints_quantized", quant)):
        booster, train_s, losses, launches = train_booster(
            name, torch, lgt, hm, ds, params, CONSTRAINT_TREES, logloss,
            leaf_check=False)
        held, worst = check_constraints(booster, ds, name)
        extra = {}
        if params is quant:
            again = lgt.Booster(quant, ds)
            for _ in range(CONSTRAINT_TREES):
                again.update()
            extra["model_txt_byte_equal_across_runs"] = \
                again.model_to_string() == booster.model_to_string()
        emit(name, trees=CONSTRAINT_TREES, train_s=train_s,
             trees_per_s=CONSTRAINT_TREES / train_s, launches=launches,
             logloss=losses, held_out_auc=held,
             largest_step_against_monotone=worst,
             leaves=[int(t.num_leaves) for t in booster.gbdt.trees], **extra)
        check(worst <= 0.0, f"{name}: predictions step {worst} against a "
              "monotone constraint")
        check(held > 0.75, f"{name}: held-out AUC {held} <= 0.75")
        check(losses[-1] < losses[0], f"{name}: logloss did not fall")
        check(extra.get("model_txt_byte_equal_across_runs", True),
              f"{name}: two identical runs wrote different model.txt")
    booster, train_s, losses, launches = train_booster(
        "train_extra_trees", torch, lgt, hm, ds,
        dict(TRAIN_PARAMS, extra_trees=True), EXTRA_TREES, logloss)
    held = held_out_auc(booster)
    differ = tree_blocks(booster.model_to_string()) != tree_blocks(
        exact.model_to_string(num_iteration=EXTRA_TREES))
    emit("train_extra_trees", trees=EXTRA_TREES, train_s=train_s,
         trees_per_s=EXTRA_TREES / train_s, launches=launches,
         logloss=losses, held_out_auc=held, trees_differ_from_exact=differ)
    check(held > 0.7, f"extra_trees held-out AUC {held} <= 0.7")
    check(differ, "extra_trees grew the exact run's trees")
    counts = hm.launch_counts()
    for name in CONSTRAINT_PATH:
        check(counts[name] > 0, f"{name} was not launched on the "
              "constraints path")
    return counts


def scan_path(torch, lgt, hm, grow_tree_mxu, y, ds):
    """K8 through the learner entry point: at every iteration of a booster
    run, grow_tree_mxu(..., **gbdt._mxu_grow_kwargs(), use_scan_kernel=
    True) grows the tree again on the booster's own gradients, feature mask
    and key, and once more with use_scan_kernel=False (the two timed in
    turns); the kernel's tree must have the booster's split features,
    thresholds, NaN directions and row routing, and leaves within 1e-5.
    The booster keeps its own tree, so a difference cannot carry into
    later trees. CONSTRAINT_PARAMS, 10 trees (K8's monotone mode), then
    TRAIN_PARAMS, 3 trees (its plain mode). Returns the launch counts."""
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    ms = {True: [], False: []}
    leaf_errs = []

    def regrow(gbdt, grad, hess, tree, row_node):
        kw = dict(rng_key=gbdt._tree_key(), **gbdt._mxu_grow_kwargs())
        args = (gbdt.bins, grad, hess, gbdt._cnt,
                gbdt._feature_mask_at(gbdt.iter_), gbdt.num_bins_d,
                gbdt.missing_is_nan_d, gbdt.is_cat_d)
        got = {}
        for kernel in ((True, False) if gbdt.iter_ % 2 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[kernel] = grow_tree_mxu(*args, use_scan_kernel=kernel, **kw)
            torch.cuda.synchronize()
            ms[kernel].append((time.perf_counter() - t0) * 1e3)
        again, rn = got[True]
        nn = int(tree.num_nodes)
        diff = [fld for fld in ("split_feature", "threshold_bin",
                                "default_left", "left", "right")
                if not torch.equal(getattr(again, fld)[:nn],
                                   getattr(tree, fld)[:nn])]
        if int(again.num_nodes) != nn or diff or not torch.equal(
                rn, row_node):
            bad = torch.nonzero(again.split_feature[:nn] !=
                                tree.split_feature[:nn])[:1, 0].tolist()
            node = bad[0] if bad else 0
            emit("scan_mismatch", iteration=gbdt.iter_, fields=diff,
                 node=node, gain_booster=float(tree.gain[node]),
                 gain_scan_kernel=float(again.gain[node]))
            check(False, f"the scan kernel's tree {gbdt.iter_} differs from "
                  f"the booster's: {diff or 'row_node'}")
        leaf_errs.append(float((again.leaf_value[:nn] -
                                tree.leaf_value[:nn]).abs().max()))

    runs = {}
    for name, params, trees in (
            ("train_scan_kernel", CONSTRAINT_PARAMS, CONSTRAINT_TREES),
            ("train_scan_kernel_plain", TRAIN_PARAMS, SCAN_PLAIN_TREES)):
        n0 = len(leaf_errs)
        booster, train_s, losses, launches = train_booster(
            name, torch, lgt, hm, ds, params, trees, logloss,
            leaf_check=params is TRAIN_PARAMS, on_grow=regrow)
        runs[name] = launches
        emit(name, trees=trees, launches=launches,
             grow_ms_scan_kernel=ms[True][n0:], grow_ms_find_best_splits=ms[
                 False][n0:], max_leaf_diff=max(leaf_errs[n0:]))
        check(max(leaf_errs[n0:]) <= 1e-5, f"{name}: leaves differ by "
              f"{max(leaf_errs[n0:])}")
    check(runs["train_scan_kernel"]["find_best_splits_mono"] > 0 and
          runs["train_scan_kernel_plain"]["find_best_splits"] > 0,
          f"the scan path launched no K8: {runs}")
    counts = hm.launch_counts()
    for name in SCAN_PATH:
        check(counts[name] > 0, f"{name} was not launched on the scan path")
    return counts


def check_outputs(torch, lgt, booster, ds, X, params=TRAIN_PARAMS,
                  phase="train_check"):
    """Host model against the device scores, held-out AUC, model text
    round trip, and whether a second identical run writes the same bytes
    (exact histograms: float64 atomics add in a different order from run
    to run, which rounding to f32 once usually hides). Returns (held-out
    AUC, byte-equal?)."""
    t0 = time.perf_counter()
    host = booster.predict(X, raw_score=True)
    predict_s = time.perf_counter() - t0
    score_err = float(np.abs(host - booster.gbdt.train_score.cpu().numpy())
                      .max())
    Xva, yva = make_higgs_like(40_000, N_FEATURES, seed=99)
    held_out_auc = auc(booster.predict(Xva, raw_score=True), yva)
    model = booster.model_to_string()
    again = lgt.Booster(params, ds)
    for _ in range(TRAIN_TREES):
        again.update()
    byte_equal = again.model_to_string() == model
    emit(phase, host_vs_device_max_abs=score_err,
         host_predict_s=predict_s, held_out_auc=held_out_auc,
         model_txt_byte_equal_across_runs=byte_equal)
    check(score_err <= 1e-4, f"host predict vs device score {score_err}")
    check(held_out_auc > 0.75, f"held-out AUC {held_out_auc} <= 0.75")
    check(lgt.Booster(model_str=model).model_to_string() == model,
          "model text does not round-trip")
    return held_out_auc, byte_equal


def cross_device_phase(lgt):
    """Categorical and NaN features through the whole training path on
    the card (the main path's data has neither), held against the same
    training on the CPU (the kernels' plain versions): the card's model
    must agree with its own device scores; whether its trees equal the
    CPU's is printed (the order of atomics may flip a near-tied split)."""
    rng = np.random.RandomState(5)
    n = 100_000
    X = rng.randn(n, 10).astype(np.float32)
    X[:, 2] = rng.randint(0, 30, n)
    X[rng.rand(n) < 0.1, 1] = np.nan
    logit = (X[:, 0] + np.where(np.isnan(X[:, 1]), 1.0, X[:, 1]) +
             np.isin(X[:, 2], [3, 7, 11, 19]) - 0.5)
    y = (logit + rng.randn(n) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
              "categorical_feature": "2"}
    models = {}
    for device in ("cuda", "cpu"):
        p = dict(params, device_type=device)
        booster = lgt.train(p, lgt.Dataset(X, label=y, params=p), 5)
        models[device] = booster
    card = models["cuda"]
    host = card.predict(X, raw_score=True)
    err = float(np.abs(host - card.gbdt.train_score.cpu().numpy()).max())
    text = card.model_to_string()
    emit("cross_device", rows=n, categorical_splits="num_cat=0" not in
         text.split("Tree=0")[1].split("Tree=1")[0],
         host_vs_device_max_abs=err,
         trees_equal_cpu=text == models["cpu"].model_to_string(),
         max_pred_diff_vs_cpu=float(np.abs(
             host - models["cpu"].predict(X, raw_score=True)).max()))
    check(err <= 1e-4, f"categorical/NaN model vs device score {err}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import rng
    from lightgbm_tpu_torch.learner import _cuda
    from lightgbm_tpu_torch.learner import histogram_mxu as hm
    from lightgbm_tpu_torch.learner import histogram_pallas as hp
    from lightgbm_tpu_torch.learner.grower_mxu import grow_tree_mxu

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _cuda.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(p.name for p in libs.values()))

    rows = kernel_phase(torch, hm, hp, rng, dev)
    torch.cuda.empty_cache()

    X, y = make_higgs_like(N_ROWS, N_FEATURES)
    counts = {}
    booster, ds, reg_ds, counts["exact"] = main_path(torch, lgt, hm, X, y)
    exact_auc, _ = check_outputs(torch, lgt, booster, ds, X)
    q_booster, counts["quantized"] = quantized_path(torch, lgt, hm, X, y, ds,
                                                    reg_ds)
    q_auc, q_equal = check_outputs(torch, lgt, q_booster, ds, X,
                                   QUANT_PARAMS, "train_quantized_check")
    check(abs(q_auc - exact_auc) <= 0.005,
          f"quantized held-out AUC {q_auc} vs exact {exact_auc}")
    check(q_equal, "two identical quantized runs wrote different model.txt")
    counts["backends"] = backends_path(torch, lgt, hm, X, y, ds, q_booster,
                                       booster)
    counts["constraints"] = constraints_path(torch, lgt, hm, y, ds, booster)
    counts["scan"] = scan_path(torch, lgt, hm, grow_tree_mxu, y, ds)
    del ds, reg_ds
    counts["packed"] = packed_path(torch, lgt, hm, X, y)
    for path, c in counts.items():
        check(path == "scan" or all(c[k] == 0 for k in SCAN_PATH),
              f"the {path} path launched K8: the booster never asks for it")
    for r in rows:
        r["launches"] = counts[ROW_PATH[r["name"]]][r["name"]]
    check(sorted(r["name"] for r in rows) == sorted(ROW_PATH),
          "the kernel table and the paths' kernels differ")
    cross_device_phase(lgt)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
