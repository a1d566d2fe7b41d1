#!/usr/bin/env python3
"""Model texts of the port's main training paths on the card, for holding
one checkout's trees against another's byte for byte.

    python3 chip_models.py                       # this checkout's package
    python3 chip_models.py --root ../parent      # another checkout's

Trains, on one CUDA card, the configurations of chip_smoke.py at 1M x 28
(10 trees each): exact binary, quantized binary (hist_backend mxu), exact
on 4-bit packed bins (max_bin 15), and the split-search options exact and
quantized. Prints one JSON line: per run, the sha256 of its model text
and its held-out AUC (chip_smoke.held_out_auc's rows), with the package
directory and the card; with --out DIR also writes each model text there.
Two checkouts' lines, taken in one call, say which runs' trees changed.
With --rates it also times, twice each, `train` of 30 trees on the exact
configuration at fused_block_size 10 without and with chip_smoke.py's
40,000-row valid set (VALID_PARAMS: binary_logloss and auc every
iteration): trees/s over the last 20 trees, the graphs' replays (and the
valid sets' trajectories) alone, and Booster.update()'s trees/s over
trees 2-11 of a booster, twice. Run parent, change, change, parent in
one call to compare two checkouts.
"""

import argparse
import hashlib
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose lightgbm_tpu_torch "
        "trains (default: this one)")
    ap.add_argument("--out", help="directory for the model texts")
    ap.add_argument("--rates", action="store_true",
                    help="also time train without and with a valid set")
    args = ap.parse_args()
    # the configurations and data come from this checkout's chip_smoke.py
    import chip_smoke as cs
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("chip_models: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgt
    if not os.path.abspath(lgt.__file__).startswith(root + os.sep):
        print(f"chip_models: imported {lgt.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    X, y = cs.make_higgs_like(cs.N_ROWS, cs.N_FEATURES)
    ds = lgt.Dataset(X, label=y, params=cs.TRAIN_PARAMS)
    packed = lgt.Dataset(X, label=y, params=cs.PACKED_PARAMS)
    runs = (("exact", ds, cs.TRAIN_PARAMS),
            ("quantized", ds, cs.QUANT_PARAMS),
            ("exact_packed", packed, cs.PACKED_PARAMS),
            ("constraints", ds, cs.CONSTRAINT_PARAMS),
            ("constraints_quantized", ds,
             dict(cs.CONSTRAINT_PARAMS, use_quantized_grad=True,
                  hist_backend="mxu")))
    result = {"package": os.path.dirname(os.path.abspath(lgt.__file__)),
              "device": torch.cuda.get_device_name(0)}
    for name, data, params in runs:
        booster = lgt.Booster(params, data)
        for _ in range(cs.TRAIN_TREES):
            booster.update()
        text = booster.model_to_string()
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, name + ".txt"), "w") as fh:
                fh.write(text)
        result[name] = {"sha256": hashlib.sha256(text.encode()).hexdigest(),
                        "held_out_auc": cs.held_out_auc(booster)}
    if args.rates:
        result["rates"] = rates(torch, lgt, cs, ds)
    print(json.dumps(result), flush=True)
    return 0


def rates(torch, lgt, cs, ds):
    """Trees/s of train's last 20 of 30 trees (fused_block_size 10) on the
    exact configuration without and with the valid set, twice each."""
    import time
    Xva, yva = cs.make_higgs_like(cs.VALID_ROWS, cs.N_FEATURES, seed=99)
    valid = ds.create_valid(Xva, label=yva)
    rounds, first = cs.VALID_ROUNDS, cs.VALID_TRAJ_TREES
    out = {"no_valid": [], "valid": []}
    for _ in range(2):
        for what in out:
            marks = []

            def mark(env):
                if env.iteration == first - 1:
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
            mark.block_safe = True     # keeps train on the block path
            params = cs.VALID_PARAMS if what == "valid" else cs.TRAIN_PARAMS
            lgt.train(params, ds, rounds,
                      valid_sets=[valid] if what == "valid" else None,
                      callbacks=[mark])
            torch.cuda.synchronize()
            out[what].append((rounds - first) /
                             (time.perf_counter() - marks[0]))
    # the per-iteration path: Booster.update() trees 2-11 of a booster
    # (each tree one growth dispatch through the retry wrapper)
    ups = []
    for _ in range(2):
        booster = lgt.Booster(cs.TRAIN_PARAMS, ds)
        booster.update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            booster.update()
        torch.cuda.synchronize()
        ups.append(10 / (time.perf_counter() - t0))
        del booster
    rates = {"trees_per_s_last20_" + k: v for k, v in out.items()}
    rates["update_trees_per_s"] = ups
    return rates


if __name__ == "__main__":
    sys.exit(main())
