#!/usr/bin/env python3
"""Where a tree's time goes in the PyTorch/CUDA port, on the card.

    python3 chip_profile.py [--trees 5] [--trace train_trace.json]
                            [--root CHECKOUT] [--fused]
                            [--efb [CARD]] [--param k=v ...]

Trains the Higgs-like 1M x 28 binary configuration of chip_smoke.py
(num_leaves 255, max_bin 255) through lightgbm_tpu_torch: two warm-up
trees, --trees timed trees, then --trees more under torch.profiler (CPU +
CUDA activity). Prints JSON lines: wall seconds per tree (unprofiled and
profiled), device time summed over kernels and the device's idle share of
the unprofiled wall time, device time per kernel name (top 15), the
device time and launches per tree of each of the port's own kernels (the
`__global__` functions of lightgbm_tpu_torch/csrc), and host time inside
the growth layers (split search, route tables, the prune replay; on the
portable grower its split search and the monotone bounds), bracketed
with record_function around the grower's functions, and the
device-to-host copies a tree (each one a host sync). --root profiles
another checkout's lightgbm_tpu_torch on this script's data. --fused
trains through Booster.update_batch instead (the fused trainer's CUDA
graphs): iteration 0 and two trees that capture the graphs as the
warm-up, then blocks of --trees trees, each replayed; the host layers
then read only what runs outside the graphs. --efb trains chip_smoke.py's
`efb` phase data instead (200,000 x 1,000 sparse, exclusive groups of 20,
as CSR; 63 leaves, 63 bins), bundled: by default on the portable grower
(per iteration only), with --param efb_use_mxu=true on the MXU grower
(--fused too); --efb 6 that data at its card=6
density (each nonzero one of 6 values). --param k=v (repeatable) adds a
training parameter, e.g. efb_segmented_scan=false, or enable_bundle=false
for the same data unbundled, max_bin=1023 (the portable grower over
uint16 bins), or monotone_constraints=1,-1 with
monotone_constraints_method=advanced (values as the port's Config parses
them).
"""

import argparse
import json
import os
import re
import sys
import time


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=5)
    ap.add_argument("--trace", default="")
    ap.add_argument("--fused", action="store_true",
                    help="train through Booster.update_batch")
    ap.add_argument("--efb", type=int, nargs="?", const=0, default=None,
                    metavar="CARD", help="chip_smoke.py's efb data (card: "
                    "0 continuous, or the values a nonzero takes)")
    ap.add_argument("--param", action="append", default=[],
                    help="k=v: an extra training parameter")
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose lightgbm_tpu_torch "
        "trains (default: this one)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.learner import _cuda, grower, grower_mxu
    if not os.path.abspath(lgt.__file__).startswith(root + os.sep):
        print(f"chip_profile: imported {lgt.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    own = set()
    for src in _cuda.CSRC.glob("*.cu"):
        own.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                              r"\([^)]*\)\s+)?(\w+)", src.read_text()))

    # bracket the grower's host-side layers (the kernels show up by name)
    for fn_name in ("find_best_splits", "pack_route_tables",
                    "_prune_to_best_first"):
        inner = getattr(grower_mxu, fn_name)

        def wrapped(*a, _inner=inner, _name=fn_name, **k):
            with record_function("grower." + _name):
                return _inner(*a, **k)
        setattr(grower_mxu, fn_name, wrapped)
    # and the portable grower's (max_bin > 256, the rescanning monotone
    # methods, use_pallas=false)
    for fn_name in ("find_best_splits", "recompute_bounds"):
        inner = getattr(grower, fn_name)

        def wrapped(*a, _inner=inner, _name=fn_name, **k):
            with record_function("portable." + _name):
                return _inner(*a, **k)
        setattr(grower, fn_name, wrapped)

    if args.efb is not None:
        X, y = chip_smoke.make_sparse(chip_smoke.EFB_ROWS, seed=11,
                                      card=args.efb)
        params = dict(chip_smoke.EFB_PARAMS)
    else:
        X, y = chip_smoke.make_higgs_like(chip_smoke.N_ROWS,
                                          chip_smoke.N_FEATURES)
        params = dict(chip_smoke.TRAIN_PARAMS)
    params.update(kv.split("=", 1) for kv in args.param)
    ds = lgt.Dataset(X, label=y, params=params)
    booster = lgt.Booster(params, ds)

    def trees(k):
        if args.fused:
            with record_function("train_many"):
                booster.update_batch(k)
            return
        for _ in range(k):
            with record_function("train_one_iter"):
                booster.update()
    trees(3 if args.fused else 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees(args.trees)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trees(args.trees)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    marks = ("train_one_iter", "train_many", "grower.", "portable.")
    kernels = {}
    host = {}
    d2h = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "DtoH" in e.name:
            d2h += 1
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith(marks):
            us, calls = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
        elif e.device_type == DeviceType.CPU and e.name.startswith(marks):
            host[e.name] = host.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / args.trees
    busy_s = sum(us for us, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    name = torch.cuda.get_device_name(0)
    # kernel durations do not change under the profiler; the host does
    # slow down, so the idle share is taken against the unprofiled wall
    print(json.dumps({"phase": "profile", "device": name,
                      "path": "fused" if args.fused else "per_iteration",
                      "trees": args.trees, "params": args.param,
                      "efb_card": args.efb, "bins_shape":
                      list(booster.gbdt.bins.shape),
                      "d2h_copies_per_tree": d2h / args.trees,
                      "wall_s_per_tree": plain_wall / args.trees,
                      "profiled_wall_s_per_tree": wall / args.trees,
                      "device_busy_s_per_tree": busy_s / args.trees,
                      "device_idle_share": 1.0 - busy_s / plain_wall}))
    print(json.dumps({"phase": "device_time_by_kernel", "top": [
        {"name": k[:90], "ms_per_tree": us / 1e3 / args.trees,
         "calls_per_tree": c / args.trees} for k, (us, c) in top]}))
    mine = {}
    for k, (us, c) in kernels.items():
        # the port's kernels sit in anonymous namespaces of csrc/*.cu;
        # torch's carry at::native (its reduce_kernel has the name of K7's)
        name = chip_smoke.kernel_name(k)
        if name in own and "(anonymous namespace)" in k and "at::" not in k:
            ms, calls = mine.get(name, (0.0, 0))
            mine[name] = (ms + us / 1e3 / args.trees, calls + c / args.trees)
    print(json.dumps({"phase": "port_kernels_per_tree", "package": root,
                      "kernels": {k: {"ms": ms, "launches": c} for k, (ms, c)
                                  in sorted(mine.items())}}))
    print(json.dumps({"phase": "host_ms_per_tree", "layers": host}))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
