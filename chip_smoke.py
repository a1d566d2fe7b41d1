#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (lightgbm_tpu_torch).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the port's CUDA kernels from lightgbm_tpu_torch/csrc, holds each
against its plain PyTorch version on the card at the shapes the training
path gives it (1M rows x 28 features, 256 bins, up to 1024 tree nodes),
times it, then trains through lightgbm_tpu_torch's entry points — the
Higgs-like binary configuration (num_leaves 255, max_bin 255), the same
with min_data_in_leaf 1000 (which runs the fix-up passes) and the default
regression objective — counting kernel launches, and checks what comes
out. Every phase prints one
JSON line; any failed check raises, so the exit code is non-zero and no
result line is printed. The last three lines are the kernel table (JSON),
the card's name and power limit as nvidia-smi prints them, and the result
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 28
BMAX = 256
M_NODES = 1024        # route-table rows at num_leaves 255, overshoot 2
S_FUSED = 263         # kernel slots of the bridge pass (fused kernel)
S_HIST = 511          # kernel slots of the fix-up passes (build_histograms)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 peak rate
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255,
                "learning_rate": 0.1, "max_bin": 255,
                "min_data_in_leaf": 20, "verbosity": -1}
TRAIN_TREES = 10
REGRESSION_TREES = 3
# leaves of >= 1000 rows: trees stop short of the 510-leaf overshoot budget
# after the bridge pass and run the fix-up passes
FIXUP_MIN_DATA = 1000


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
    run, after one warm-up run."""
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


def kernel_inputs(torch, hm, dev):
    """One growth pass's inputs at the slice's shapes: random bins, a
    1024-node split table with numerical, NaN-bin and categorical splits,
    rows spread over its nodes."""
    rng = np.random.RandomState(7)
    num_bins = np.full(N_FEATURES, BMAX, np.int32)
    num_bins[[3, 9]] = 64                    # NaN-bin features
    num_bins[[5, 11]] = 40                   # categorical features
    missing_is_nan = np.zeros(N_FEATURES, bool)
    missing_is_nan[[3, 9, 5, 11]] = True
    is_cat_feat = np.zeros(N_FEATURES, bool)
    is_cat_feat[[5, 11]] = True
    bins = (rng.rand(N_ROWS, N_FEATURES) * num_bins).astype(np.uint8)
    m1 = M_NODES - 4
    split = rng.rand(m1) < 0.6
    feat = rng.randint(0, N_FEATURES, m1)
    feat[:64] = 3
    is_cat = is_cat_feat[feat]
    thr = (rng.rand(m1) * (num_bins[feat] - 1)).astype(np.int32)
    words = (BMAX + 31) // 32
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
    return dict(
        bins=t(bins), grad=t(rng.randn(N_ROWS).astype(np.float32)),
        hess=t(rng.uniform(0.1, 1.0, N_ROWS).astype(np.float32)),
        cnt=torch.ones(N_ROWS, dtype=torch.float32, device=dev),
        row_node=t(rng.randint(0, m1, N_ROWS), torch.int32),
        row_slot=t(rng.randint(-1, S_HIST, N_ROWS), torch.int32),
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


def kernel_phase(torch, hm, dev):
    d = kernel_inputs(torch, hm, dev)
    bins, grad, hess, cnt = d["bins"], d["grad"], d["hess"], d["cnt"]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    n, f = bins.shape
    rows = []

    def row(name, replaces, err, ms, plain_ms, nbytes, ops, library_ms):
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"lightgbm_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None,  # set by the main path
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": library_ms})
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
        time_ms(torch, lambda: hm.route_rows(bins, d["row_node"], *route),
                20),
        time_ms(torch, lambda: hm.route_rows_ref(bins, d["row_node"],
                                                 *route), 5),
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
        err, time_ms(torch, k1, 20), time_ms(torch, k1_ref, 3),
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
    # yardstick: one index_add_ over the same flattened cells
    valid = torch.nonzero(rslot >= 0)[:, 0]
    cells = ((rslot[valid].long()[:, None] * f +
              torch.arange(f, device=dev)[None, :]) * BMAX +
             bins[valid].long()).reshape(-1)
    vals = torch.stack([grad[valid], hess[valid], cnt[valid]], 1)[:, None] \
        .expand(-1, f, 3).reshape(-1, 3).contiguous()
    flat = torch.zeros((S_HIST * f * BMAX, 3), device=dev)
    n_slot = int(valid.numel())
    row("build_histograms", "lightgbm_tpu/learner/histogram_mxu.py:472",
        err, time_ms(torch, k3, 20), time_ms(torch, k3_ref, 3),
        4 * n + n_slot * (f + 12) + h.numel() * 4, n_slot * f * 3,
        time_ms(torch, lambda: flat.index_add_(0, cells, vals), 20))
    del cells, vals, flat

    # K6 node_values: the score update's gather over 1024 node values
    v = d["values"]
    out = hm.node_values(d["row_node"], v)
    out_ref = hm.node_values_ref(d["row_node"], v)
    check(torch.equal(out, out_ref), "node_values differs")
    idx = d["row_node"].long()
    row("node_values", "lightgbm_tpu/learner/histogram_mxu.py:1248", 0.0,
        time_ms(torch, lambda: hm.node_values(d["row_node"], v), 20),
        time_ms(torch, lambda: hm.node_values_ref(d["row_node"], v), 5),
        8 * n + v.numel() * 4, 0, time_ms(torch, lambda: v[idx], 20))
    return rows


def train_booster(torch, lgt, hm, ds, params, trees, metric):
    """Train `trees` iterations on a constructed Dataset; returns the
    booster, the training seconds, the metric after every tree and the
    kernel launches this run added."""
    booster = lgt.Booster(params, ds)
    before = hm.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = []
    for _ in range(trees):
        booster.update()
        values.append(float(metric(booster.gbdt.train_score)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in hm.launch_counts().items()}
    return booster, seconds, values, launches


def main_path(torch, lgt, hm, X, y):
    """The slice's main path: training through lightgbm_tpu_torch's entry
    points at the full 1M x 28 width, three settings of the same model —
    the Higgs-like binary configuration, the same with a large
    min_data_in_leaf (trees stop short of the leaf budget after the bridge
    pass, so the full-width fix-up passes run: route_rows +
    build_histograms), and the default regression objective
    (const-hessian channels). Kernel launches are counted over all three."""
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=TRAIN_PARAMS)
    ds.construct()
    binning_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    ysign = 2.0 * torch.as_tensor(y, device=dev) - 1.0

    def logloss(score):
        return torch.nn.functional.softplus(-ysign * score).mean()

    hm.reset_launch_counts()
    booster, train_s, losses, launches = train_booster(
        torch, lgt, hm, ds, TRAIN_PARAMS, TRAIN_TREES, logloss)
    emit("train", rows=N_ROWS, features=N_FEATURES, trees=TRAIN_TREES,
         binning_s=binning_s, train_s=train_s,
         trees_per_s=TRAIN_TREES / train_s, launches=launches,
         logloss=losses,
         leaves=[int(t.num_leaves) for t in booster.gbdt.trees])
    check(all(b <= a + 1e-7 for a, b in zip(losses, losses[1:])) and
          losses[-1] < losses[0], f"training logloss did not fall: {losses}")

    fix_params = dict(TRAIN_PARAMS, min_data_in_leaf=FIXUP_MIN_DATA)
    _, fix_s, fix_losses, fix_launches = train_booster(
        torch, lgt, hm, ds, fix_params, TRAIN_TREES, logloss)
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
        torch, lgt, hm, reg_ds, reg_params, REGRESSION_TREES,
        lambda score: ((score - label) ** 2).mean())
    emit("regression", trees=REGRESSION_TREES, train_s=reg_s,
         trees_per_s=REGRESSION_TREES / reg_s, launches=reg_launches, l2=l2,
         const_hessian=reg.gbdt._const_hessian())
    check(reg.gbdt._const_hessian() == 1.0,
          "regression lost the const hessian")
    check(all(b < a for a, b in zip(l2, l2[1:])), f"L2 did not fall: {l2}")
    counts = hm.launch_counts()
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    return booster, ds, counts


def check_outputs(torch, lgt, booster, ds, X):
    """Host model against the device scores, held-out AUC, model text
    round trip, and whether a second identical run writes the same bytes
    (f32 atomics add in a different order from run to run)."""
    t0 = time.perf_counter()
    host = booster.predict(X, raw_score=True)
    predict_s = time.perf_counter() - t0
    score_err = float(np.abs(host - booster.gbdt.train_score.cpu().numpy())
                      .max())
    Xva, yva = make_higgs_like(40_000, N_FEATURES, seed=99)
    held_out_auc = auc(booster.predict(Xva, raw_score=True), yva)
    model = booster.model_to_string()
    again = lgt.Booster(TRAIN_PARAMS, ds)
    for _ in range(TRAIN_TREES):
        again.update()
    emit("train_check", host_vs_device_max_abs=score_err,
         host_predict_s=predict_s, held_out_auc=held_out_auc,
         model_txt_byte_equal_across_runs=again.model_to_string() == model)
    check(score_err <= 1e-4, f"host predict vs device score {score_err}")
    check(held_out_auc > 0.75, f"held-out AUC {held_out_auc} <= 0.75")
    check(lgt.Booster(model_str=model).model_to_string() == model,
          "model text does not round-trip")


def cross_device_phase(lgt):
    """Categorical and NaN features through the whole training path on
    the card (the main path's data has neither), held against the same
    training on the CPU (the kernels' plain versions): the card's model
    must agree with its own device scores; whether its trees equal the
    CPU's is printed (f32 atomics may flip a near-tied split)."""
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
    from lightgbm_tpu_torch.learner import _cuda
    from lightgbm_tpu_torch.learner import histogram_mxu as hm

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

    rows = kernel_phase(torch, hm, dev)
    torch.cuda.empty_cache()

    X, y = make_higgs_like(N_ROWS, N_FEATURES)
    booster, ds, counts = main_path(torch, lgt, hm, X, y)
    for r in rows:
        r["launches"] = counts[r["name"]]
    check_outputs(torch, lgt, booster, ds, X)
    cross_device_phase(lgt)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
