#!/usr/bin/env python3
"""Where a tree's time goes in the PyTorch/CUDA port, on the card.

    python3 chip_profile.py [--trees 5] [--trace train_trace.json]

Trains the Higgs-like 1M x 28 binary configuration of chip_smoke.py
(num_leaves 255, max_bin 255) through lightgbm_tpu_torch: two warm-up
trees, --trees timed trees, then --trees more under torch.profiler (CPU +
CUDA activity). Prints JSON lines: wall seconds per tree (unprofiled and
profiled), device time summed over kernels and the device's idle share of
the unprofiled wall time, device time per kernel name (top 15), and host
time inside the growth layers (split search, route tables, the prune
replay), bracketed with record_function around the grower's functions.
"""

import argparse
import json
import sys
import time


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.learner import grower_mxu

    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=5)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    # bracket the grower's host-side layers (the kernels show up by name)
    for fn_name in ("find_best_splits", "pack_route_tables",
                    "_prune_to_best_first"):
        inner = getattr(grower_mxu, fn_name)

        def wrapped(*a, _inner=inner, _name=fn_name, **k):
            with record_function("grower." + _name):
                return _inner(*a, **k)
        setattr(grower_mxu, fn_name, wrapped)

    X, y = chip_smoke.make_higgs_like(chip_smoke.N_ROWS,
                                      chip_smoke.N_FEATURES)
    ds = lgt.Dataset(X, label=y, params=chip_smoke.TRAIN_PARAMS)
    booster = lgt.Booster(chip_smoke.TRAIN_PARAMS, ds)
    for _ in range(2):
        booster.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.trees):
        booster.update()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trees):
            with record_function("train_one_iter"):
                booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    marks = ("train_one_iter", "grower.")
    kernels = {}
    host = {}
    for e in prof.events():
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
                      "trees": args.trees,
                      "wall_s_per_tree": plain_wall / args.trees,
                      "profiled_wall_s_per_tree": wall / args.trees,
                      "device_busy_s_per_tree": busy_s / args.trees,
                      "device_idle_share": 1.0 - busy_s / plain_wall}))
    print(json.dumps({"phase": "device_time_by_kernel", "top": [
        {"name": k[:90], "ms_per_tree": us / 1e3 / args.trees,
         "calls_per_tree": c / args.trees} for k, (us, c) in top]}))
    print(json.dumps({"phase": "host_ms_per_tree", "layers": host}))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
