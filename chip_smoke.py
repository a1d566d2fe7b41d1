#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (lightgbm_tpu_torch).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the port's nine CUDA kernel sources from lightgbm_tpu_torch/csrc,
holds each kernel against its plain PyTorch version on the card — every
histogram kernel and the node sums bit for bit (integer sums in every
mode) and across two calls — at the shapes the training path gives it
(1M rows x 28 features, 256 bins, up to 1024 tree nodes; 15 bins for the
4-bit packed modes; 511 and 263 scan slots for the split scan, at 256,
15, 100 and 255 bins and with inf and NaN cells; the root
pass's single slot for the partition, the scatter histogram and the fused
sweep, which on the card is route_rows with its chunk tallies, the
partition fed those tallies and the scatter kernel, timed at every width
of the exact path), in every mode the paths run (f32 and the integer mode
of quantized gradients; unpacked and packed bins; route counts and chunk
tallies; the partition given tallies, given counts and counting for
itself; the split scan plain and monotone), times it — `ms`, one call as
the training path makes it, host launch path included, and `device_ms`,
the device alone over back-to-back calls; the same two for the PyTorch
yardstick where one call computes the function; each launch of the
partition and the routing apart under torch.profiler; the best-first
prune's kernel against its plain version on overgrown trees of the main
path's 1020 node ids; the traversal kernel (valid scores) against its
plain version on 10 stacked 255-leaf trees over 40,000 rows, with
categorical and NaN nodes; K1 (f32 and integer), K3, K7 (integer) and
K5 again on sampled rows, a bagging mask and GOSS's weights and count,
bit for bit, with GOSS's sampler and threshold timed — then trains through
lightgbm_tpu_torch's entry points along twelve paths, each with the launch
counts reset before it and read after it (eighteen with the last six
below: EFB, single-precision hessians, the rescanning monotone methods,
forced splits with CEGB and the guard rails, linear trees, and wide
bins):

- exact histograms: the Higgs-like binary configuration (num_leaves 255,
  max_bin 255), the same with min_data_in_leaf 1000 (which runs the
  fix-up passes) and the default regression objective;
- quantized gradients (use_quantized_grad, hist_backend pinned to mxu):
  the binary configuration, the regression objective, and a 200-feature
  binary run whose wide passes take route_rows + build_histograms in
  integer mode (on the card: the partition kernel and the scatter
  kernel);
- K trees per dispatch (phases `fused*`): the exact and the quantized
  binary configurations, trees that run fix-up passes (min_data_in_leaf
  1000) and the split options with extra_trees, through engine.train at
  the default fused_block_size 10 (which frees its trainer when done),
  then update_batch(10) twice on the same booster (a new trainer: a
  capture, then replays of CUDA graphs of its programs: prologue, each
  pass width, bridge, fix-up, epilogue), against 30 Booster.update()
  calls in turns: the model text byte-equal (sha256) after 10, 20 and 30
  trees, every program captured, the launches the per-iteration run's
  plus the no-op fix-up passes the trainers report, and the graphs' pool
  given back when the booster is deleted with garbage collection paused;
  prints trees/s of both paths, host syncs a tree, graph memory, capture
  seconds and the memory around the deletion; then (`fused_configs`, a
  check) the quantized backends, exact pallas, packed bins and regression
  through train against update(), 5 trees each, byte-equal, and
  (`fused_scratch_check`) a small booster's graphs replayed after a
  larger booster grew the shared scratch buffers, byte-equal to update();
- validation sets (phase `valid*`): the binary configuration through
  engine.train with a held-out set (40,000 rows, binned with the
  training set's mappers) and metrics binary_logloss and auc, 30 rounds
  at fused_block_size 10 against 1: the block's valid-score trajectory
  (the traversal kernel) bit-equal to the per-iteration valid scores,
  the model text byte-equal, the recorded AUC to the host model's; an
  early stop inside the first block (permuted labels) equal to the
  per-iteration run's; feval with the training set as a valid set (one
  iteration a dispatch) giving the same model; trees/s with and without
  a valid set, host syncs a tree;
- row sampling, random forest and DART (phases `sampling*`): bagging
  (fraction 0.8, freq 5), GOSS (top_rate 0.2, other_rate 0.1) and
  bagging with quantized gradients through the fused phases' turns
  (train, update_batch(10) twice, against 30 update() calls, byte-equal
  after 10, 20 and 30 trees), each turn's host predictions within 1e-4
  of its device scores and held-out AUC above 0.75; bagging with fix-up
  passes and quantized bagging under hist_backend pallas, train against
  update(); random forest (10 trees) and DART (20 trees), one iteration
  a dispatch, engine.train with a valid set against update() twice,
  byte-equal, host predictions against the averaged or renormalized
  device scores, DART's traversal launches against its dropped trees,
  and kernel V's row at one DART tree over the 1M training rows; trees/s
  beside the unsampled fused path, host syncs a tree, DART's V device ms
  a tree (derived: V's launches a tree x its one-tree row's device ms);
- the histogram backends on the binary configuration: quantized under
  hist_backend pallas (route counts, the partition kernel and the scatter
  kernel), scatter (the segment-sum oracle) and auto (the autotune), each
  byte-equal to the mxu run, and exact under pallas, byte-equal to the
  exact mxu run's trees;
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
  byte-equal to the same run on unpacked bins, and quantized under auto
  and pallas;
- multiclass, 5 classes, 5 trees an iteration (phases `multiclass*`,
  the task of the JAX package's helpers/bench_tasks.py at 1M x 28): exact
  and quantized through the fused phases' turns (train at
  fused_block_size 10, 50 trees a dispatch, then update_batch, against
  update(), byte-equal; one set of graphs for all classes), host
  predictions within 1e-4 of the device scores in every class; a
  40,000-row held-out set on multi_logloss and multi_error at
  fused_block_size 10 against 1 (metrics, valid scores and model equal,
  the held-out loss below the class prior's), an early stop inside a
  block equal to fused_block_size 1's, multiclassova for 5 iterations;
  kernel V's class mode (`predict_binned_class`) bit-equal to its plain
  version on that run's 10 x 5 trees over the held-out rows;
- ranking (phase `ranking`): lambdarank and rank_xendcg over 50,000
  queries of 20 documents, 10 iterations through train's fused path
  against update(), byte-equal, held-out ndcg@10 above iteration 0's,
  the gradient program's device ms;
- the other objectives (phase `objectives`) on the regression task's
  data: regression_l1, huber, fair, quantile and mape per iteration with
  leaf renewal, poisson, gamma, tweedie, cross_entropy and
  cross_entropy_lambda fused against update(), 5 iterations each, host
  predictions within 1e-4 of the device scores and the training metric
  below iteration 0's;
- exclusive feature bundling and sparse input (phase `efb`): the JAX
  package's EFB shape (helpers/bench_efb.py make_sparse: 200,000 rows x
  1,000 features in exclusive groups of 20, binary, 63 leaves, 63 bins)
  built as a CSR matrix, its Dataset's bins byte-equal to the dense
  matrix's (seconds of each); four turns, exact and quantized with the
  segmented scan (bundle-range routing) and the expansion (loc-table
  routing), each through engine.train at fused_block_size 10 for 20
  trees twice and against 20 update() calls, byte-equal; DART with EFB
  (3 iterations) re-predicting its dropped trees through kernel V's
  bundled mode; K1 and K2 in both EFB modes (K1 also in integer mode)
  and V's bundled mode bit-equal to their plain versions at the phase's
  shapes, each launched on the path; host predictions from the CSR input
  within 1e-4 of the device scores and equal to the dense array's;
  replayed trees/s and held-out AUC bundled against enable_bundle=false
  on the same data;
- gpu_use_dp=false (phase `single_prec`): the binary configuration
  through the fused phases' turns (byte-equal to update()), 10 update()
  trees under leaf_check, the pallas backend (K7) through train against
  update() and the 100k x 200 data (K3), K1, K3 and K7 only in their
  single-precision mode; replayed trees/s of gpu_use_dp false against
  true, alternating in one call; K1, K3 and K7 in that mode bit-equal to
  their plain versions at the main path's shapes, the hessian cells
  apart from the full-precision mode's;
- the rescanning monotone methods (phase `monotone_methods`):
  intermediate and advanced (+1 on feature 0, -1 on feature 1) on the
  portable grower, leaf-wise (254 passes a tree, every node rescanned
  from a [510, 28, 256, 3] histogram cache), 2 trees by update() against
  engine.train, byte-equal; every leaf -G/H of its rows or clamped to
  another node's value; held-out sweeps monotone; tree 0 equal to the
  CPU's at 100,000 rows and 63 leaves;
- forced splits, CEGB and the guard rails (phase `forced_cegb`): a
  nested forced spec (a root on feature 0, both children, a grandchild)
  through engine.train at fused_block_size 10 for 20 trees against 20
  update() calls, byte-equal, exact and quantized, every tree's forced
  nodes the spec's features and threshold bins, held-out AUC above 0.75,
  replayed trees/s with and without the spec alternating in one call; a
  spec whose grandchild cannot apply ends its BFS there; the prune P
  bit-equal to its plain version on the main path's forced rank keys and
  on an overgrown tree whose top group is tied at 1e30 (row
  `prune_best_first_forced`, after the counts are read; its launches are
  the path's prunes under a forced spec); CEGB on the MXU grower (split
  and coupled penalties; the coupled one alone), 10 trees each, the
  penalised feature never split on; lazy CEGB on the portable grower, 3
  trees (K7, not K1); guard_nonfinite warn, skip_iteration, rollback and
  raise against a custom objective's NaN gradient, and a clean warn run
  equal to guard_nonfinite=off;
- linear trees (phase `linear`): the binary configuration with 1% of
  features 0 and 1 NaN in the training and held-out rows and
  linear_tree, through engine.train with the 40,000-row held-out set, one
  iteration a dispatch: 10 trees at linear_lambda 0 and 0.1 (the latter
  twice, model text byte-equal, its is_linear sections written) and a
  quantized turn of 5 trees, twice; L1 (linear_gram), L2
  (linear_values), K1, P and V launched (K5 in the quantized turn); the
  host model (native and numpy) within 1e-4 of the device training and
  valid scores, the text round trip, held-out AUC above 0.75 beside the
  constant-leaf model's on the same data, seconds a tree with and
  without linear_tree; 8 leaves of the last tree's fit against a float64
  host ridge solve; SHAP on the main constant-leaf model (1000 rows, its
  first tree: contributions summing to the raw score) and its refusal of
  linear trees; L1 bit-equal to its plain version and across two calls on
  that fit's inputs (also with out-of-bag rows, an infinite hessian, 31
  slots, 8300 node ids, one leaf holding every row and raw off 16
  bytes), L2 on its training rows, the held-out set's leaf ids from
  kernel V, signed zeros, 31 slots, 8300 leaves and raw off 16 bytes;
  the 32-byte sectors of raw that hold the rows' model features (the
  sector floor beside the byte bound);
- max_bin 1023 (phase `wide_bins`): the 1M x 28 matrix binned to uint16,
  the portable grower with K7's uint16 mode and with the segment sums
  (use_pallas=false), 10 trees by update() (leaf_check) against
  engine.train with a 40,000-row held-out set (kernel V's wide mode),
  byte-equal; K7's uint16 mode at 1 and 256 slots and V's wide mode
  bit-equal to their plain versions.

Beside the main path (`native_host`), the native host runtime
(lightgbm_tpu_torch/cext, C++ built with g++ at first use) bins the 1M x
28 matrix and predicts the 10-tree booster on the host against its numpy
plain versions: mappers repr-equal, bin matrix byte-equal, predictions
bit-equal, leaf indices equal, seconds of each.

It checks what comes out, including that every leaf of every tree holds
-G/H of its rows' gradients (unconstrained runs), that two identical
runs write the same model text (exact and quantized), and that exact
trees under hist_backend pallas and on packed bins equal the mxu and
unpacked ones; K8 launches on the scan path only, and every K1, K3/K4
and K7 call on a path launches exactly one partition kernel. Last, a
categorical and NaN run on the card and the CPU: tree 0, and tree 0
regrown on the card from the CPU run's gradients, must equal the CPU's;
whether the later trees are equal is printed, with where the two part
(upstream of the grower or in its glue).
Every phase prints one JSON line; any failed check raises, so the exit
code is non-zero and no result line is printed.
The last three lines are the kernel table (JSON), the card's name and
power limit as nvidia-smi prints them, and the result
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 28
BMAX = 256
BMAX_PACKED = 15      # max_bin 15: every bin id fits a nibble
M_NODES = 1024        # route-table rows at num_leaves 255, overshoot 2
S_FUSED = 263         # kernel slots of the bridge pass (fused kernel)
S_HIST = 511          # kernel slots of the fix-up passes (build_histograms)
S_TUNE = 263          # the autotune's frontier: kernel cap of 511 scan slots
# the exact path's K1 widths: the doubling passes' frontiers and the bridge
# pass's kernel cap (growth_plan at num_leaves 255, overshoot 2)
K1_WIDTHS = (1, 2, 4, 8, 16, 24, 40, 72, 136, 263)
M_REFIT = 510         # node_sums rows: the pruned 255-leaf tree's 2 x 255
M_GROWN = 1020        # node ids of the overgrown (overshoot 2) tree
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 peak rate
LEAF_TOL = 1e-2       # a leaf value against -G/H of its rows' float64 sums
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
# one instruction a lane a clock (128 f32 lanes a SM, 4 warp issues a
# clock): the 67 TFLOP/s count an FMA as two operations
F32_INST_PER_S = F32_OPS_PER_S / 2
# SASS instructions of one K8 threshold, by (monotone mode, NaN bin): its
# bin's share of the lane totals and the kernel's scan_bin at the main
# path's gain forms (lambda_l1 0, no max_delta_step, no path_smooth; the
# division's fast path), both NaN options where the feature has that bin;
# counted by `python3 chip_parts.py --k8` from csrc/find_best_splits.cu
# built for sm_90a (PERF.md section 6)
K8_INST = {(False, False): 69, (False, True): 113, (True, False): 98,
           (True, True): 163}
# K8 widths beside 256 and the packed 15: not multiples of 32 (5 and 9 bins
# a lane), with 16-byte and 4-byte row copies
K8_ODD_BINS = (100, 255)
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
           "build_histograms_scatter_int_packed",
           "build_histograms_scatter_sp", "build_histograms_scatter_wide",
           "build_histograms_scatter_sp_wide",
           "build_histograms_scatter_int_wide",
           "build_histograms_scatter_packed_sp")
# K1 on the card: route_rows with counts, the partition, the scatter kernel
K1_KEYS = ("fused_route_hist", "fused_route_hist_int",
           "fused_route_hist_packed", "fused_route_hist_int_packed",
           "fused_route_hist_sp", "fused_route_hist_packed_sp")
# K3/K4 on the card: the partition kernel, then the scatter kernel
K3_KEYS = ("build_histograms", "build_histograms_int",
           "build_histograms_packed", "build_histograms_int_packed",
           "build_histograms_sp", "build_histograms_packed_sp")
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
# K iterations per dispatch (engine.train at fused_block_size 10, CUDA
# graphs) against the per-iteration path (Booster.update): both main
# configurations, then trees that run fix-up passes (the fix-up graph
# reads its pass number from a buffer the host fills before each replay)
# and the split options (per-pass draws from that number, the interaction
# groups' matmul)
FUSED_RUNS = (("fused", TRAIN_PARAMS), ("fused_quantized", QUANT_PARAMS),
              ("fused_fixups", dict(TRAIN_PARAMS,
                                    min_data_in_leaf=FIXUP_MIN_DATA)),
              ("fused_constraints", dict(CONSTRAINT_PARAMS,
                                         extra_trees=True)))
FUSED_PATH = ("prune_best_first", "fused_route_hist", "fused_route_hist_int",
              "node_values", "node_sums")
# trees of each configuration fused_configs_check holds to update()
FUSED_CHECK_TREES = 5
# fused_scratch_check: a booster's graphs, replayed after a booster with
# more rows than any earlier phase grew the scratch buffers
SCRATCH_SMALL_ROWS = 200_000
SCRATCH_LARGE_ROWS = N_ROWS + N_ROWS // 4
# the prune at the main path's shapes: 255 leaves kept of an overgrown
# tree of up to 510 leaves in 1020 node ids
PRUNE_LEAVES = 255
# the valid phase: a held-out set of the Higgs-like problem (seed 99, as
# check_outputs), binned with the training set's mappers, 30 rounds at
# fused_block_size 10 against 1; the traversal kernel's row at its shapes
# (a block of 10 stacked trees)
VALID_ROWS = 40_000
VALID_ROUNDS = 30
VALID_TRAJ_TREES = 10
VALID_PARAMS = dict(TRAIN_PARAMS, metric="binary_logloss,auc")
VALID_PATH = ("predict_binned", "prune_best_first", "fused_route_hist",
              "node_values")
# the sampling phases: bagging, GOSS and quantized bagging on train's block
# dispatch against update() (30 trees in turns); bagging whose trees run
# fix-up passes (K3) and quantized bagging under hist_backend pallas (K7),
# 10 trees; random forest and DART, one iteration a dispatch
BAGGING = {"bagging_fraction": 0.8, "bagging_freq": 5}
GOSS = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}
SAMPLING_RUNS = (("sampling_bagging", dict(TRAIN_PARAMS, **BAGGING)),
                 ("sampling_goss", dict(TRAIN_PARAMS, **GOSS)),
                 ("sampling_bagging_quantized", dict(QUANT_PARAMS,
                                                     **BAGGING)))
SAMPLING_CHECKS = (
    ("sampling_bagging_fixups", dict(TRAIN_PARAMS, **BAGGING,
                                     min_data_in_leaf=FIXUP_MIN_DATA)),
    ("sampling_bagging_pallas", dict(QUANT_PARAMS, **BAGGING,
                                     hist_backend="pallas")))
RF_PARAMS = dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.7,
                 bagging_freq=1)
RF_TREES = 10
DART_PARAMS = dict(TRAIN_PARAMS, boosting="dart", drop_rate=0.1)
DART_TREES = 20
SAMPLING_PATH = ("fused_route_hist", "fused_route_hist_int", "route_rows",
                 "build_histograms", "build_histograms_scatter_int",
                 "node_sums", "node_values", "prune_best_first",
                 "predict_binned")
# the kernels held to their plain versions on sampled rows, by the key
# their launches count under
SAMPLED_REPLACES = {
    "fused_route_hist": "lightgbm_tpu/learner/histogram_mxu.py:785",
    "fused_route_hist_int": "lightgbm_tpu/learner/histogram_mxu.py:785",
    "build_histograms": "lightgbm_tpu/learner/histogram_mxu.py:472",
    "build_histograms_scatter_int":
        "lightgbm_tpu/learner/histogram_pallas.py:211",
    "node_sums": "lightgbm_tpu/learner/histogram_mxu.py:1192"}
# the task matrix's other tasks (the JAX package's helpers/bench_tasks.py,
# whose data makers are copied below): 5-class multiclass and lambdarank
# over queries of 20 documents at the headline shape (1M x 28, 255 leaves,
# 255 bins), each beside a held-out set of 40,000 rows (seed 99), and the
# objectives on the regression task's data
MC_CLASSES = 5
MC_PARAMS = dict(TRAIN_PARAMS, objective="multiclass", num_class=MC_CLASSES)
MC_QUANT_PARAMS = dict(MC_PARAMS, use_quantized_grad=True,
                       hist_backend="mxu")
MC_VALID_ROUNDS = 20
OVA_TREES = 5
HOST_ROWS = 100_000   # rows host predict is held to the device scores on
RANK_QSIZE = 20
RANK_TREES = 10
OBJ_TREES = 5
RENEW_OBJECTIVES = ("regression_l1", "huber", "fair", "quantile", "mape")
FUSED_OBJECTIVES = ("poisson", "gamma", "tweedie", "cross_entropy",
                    "cross_entropy_lambda")
MULTICLASS_PATH = ("predict_binned_class", "predict_binned",
                   "fused_route_hist", "fused_route_hist_int", "node_values",
                   "node_sums", "prune_best_first")
RANKING_PATH = ("fused_route_hist", "node_values", "prune_best_first",
                "predict_binned")
OBJECTIVES_PATH = ("fused_route_hist", "node_values", "prune_best_first")
# the launch-count key of a row named otherwise
ROW_KEY = {**{k + "_sampled": k for k in SAMPLED_REPLACES},
           "predict_binned_train": "predict_binned"}
# the paths whose counts a kernel row reports
ROW_PATH = {"prune_best_first": "fused",
            "predict_binned": ("valid", "sampling"),
            "predict_binned_class": "multiclass",
            **dict.fromkeys(ROW_KEY, "sampling"),
            **dict.fromkeys(EXACT_PATH, "exact"),
            **dict.fromkeys(("fused_route_hist_int", "build_histograms_int",
                             "node_sums"), "quantized"),
            **dict.fromkeys(BACKEND_PATH[:4], "backends"),
            **dict.fromkeys(PACKED_PATH, "packed"),
            **dict.fromkeys(SCAN_PATH, "scan"),
            **dict.fromkeys(("fused_route_hist_sp", "build_histograms_sp",
                             "build_histograms_scatter_sp"), "single_prec"),
            **dict.fromkeys(("build_histograms_scatter_wide",
                             "predict_binned_wide"), "wide_bins")}


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


def make_regression(n, seed):
    """The regression task of helpers/bench_tasks.py."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, N_FEATURES).astype(np.float32)
    y = (1.5 * X[:, 0] - 0.9 * X[:, 1] + 0.8 * X[:, 2] * X[:, 3] +
         0.6 * np.abs(X[:, 4]) - 0.5 * X[:, 5] ** 2 +
         0.4 * np.sin(2 * X[:, 6]) + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


def make_multiclass(n, seed, k=MC_CLASSES):
    """The multiclass task of helpers/bench_tasks.py: the class geometry
    does not depend on the seed, so train and held-out sets share one
    distribution."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, N_FEATURES).astype(np.float32)
    centers = np.random.RandomState(7).randn(k, 6) * 1.2
    d = ((X[:, None, :6] - centers[None]) ** 2).sum(-1)
    d += 1.5 * rng.gumbel(size=(n, k))
    y = np.argmin(d, axis=1).astype(np.float32)
    return X, y


def make_lambdarank(n, seed, qsize=RANK_QSIZE):
    """The lambdarank task of helpers/bench_tasks.py: n // qsize queries,
    5 relevance levels by global quantile."""
    rng = np.random.RandomState(seed)
    nq = n // qsize
    n = nq * qsize
    X = rng.randn(n, N_FEATURES).astype(np.float32)
    raw = (1.1 * X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] +
           0.9 * rng.randn(n))
    qs = np.quantile(raw, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(raw, qs).astype(np.float32)
    return X, y, np.full(nq, qsize, np.int32)


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
    (not measured) when not strict. When strict, a trial not queued runs
    again behind a sleep twice as long, up to 16 times the first."""
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
        # a host slowed by its neighbours may enqueue slower than it was
        # timed: the sleep doubles, up to 16x, before the trial counts as
        # not queued (a fn that syncs is never queued, however long)
        for stretch in (1, 2, 4, 8, 16) if strict else (1,):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS[0] *
                                  stretch * (3 * host_ms + 2)))
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            queued = not a.query()
            b.synchronize()
            if queued:
                break
        if not strict and not queued:
            return None
        check(queued, "device_ms: the host had not queued every call when "
              "the sleep ended")
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def graph_device_ms(torch, fn):
    """Device milliseconds of fn() captured whole in one CUDA graph (after
    a warm-up call on the capture stream) and replayed: a formulation of
    thousands of launches a call, which would fill the launch queue behind
    device_ms' sleep, is one launch so."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    try:
        return device_ms(torch, graph.replay)
    finally:
        del graph
        torch.cuda.synchronize()


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


def same_bits(torch, a, b):
    """Whether two f32 tensors hold the same bits (every histogram mode
    sums integers: the kernels equal their plain versions exactly)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def check_hist(torch, name, fn, want):
    """A histogram kernel's result against its plain version's `want`,
    bit for bit, and two calls of it against each other. Returns the max
    abs error (0)."""
    got, again = fn(), fn()
    if isinstance(got, tuple):
        got, again = got[0], again[0]
    check(same_bits(torch, got, want), f"{name} differs from its plain "
          f"version: max abs error {float((got - want).abs().max())}")
    check(same_bits(torch, got, again), f"{name}: two calls differ")
    return 0.0


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


def make_row(torch, rows):
    """row(name, replaces, err, fn, plain_fn, plain_reps, nbytes, ops,
    library_fn, ...): times a kernel and appends its line of the kernel
    table to `rows` (launches are set by the path that owns it)."""

    def row(name, replaces, err, fn, plain_fn, plain_reps, nbytes, ops,
            library_fn, source=None, ops_per_s=F32_OPS_PER_S,
            library_queues=True, library_graph=False):
        # ms: one call as the main path makes it (host launch path
        # included); device_ms: the device alone (back-to-back calls).
        # ops: one add per histogram cell update (f32 or int32), held to
        # the f32 rate outside the tensor cores (bytes-bound); K8 counts
        # its instructions at the f32 instruction rate (ops_per_s). A
        # library formulation of thousands of launches a call fills the
        # launch queue behind device_ms' sleep (library_queues=False):
        # its device ms is not measured (None), unless it is timed as one
        # CUDA graph of the whole call (library_graph)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / ops_per_s * 1e3
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
            else graph_device_ms(torch, library_fn) if library_graph
            else device_ms(torch, library_fn, strict=library_queues)})
        emit("kernel", **rows[-1])

    row.rows = rows
    return row


def kernel_phase(torch, hm, hp, rng_mod, dev):
    d = kernel_inputs(torch, hm, rng_mod, dev)
    rows = []
    row = make_row(torch, rows)

    bins, grad, hess, cnt = d["bins"], d["grad"], d["hess"], d["cnt"]
    g_q, h_q = d["g_q"], d["h_q"]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    n, f = bins.shape

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

    # K1 fused_route_hist at the bridge pass's 263 slots. Exact mode takes
    # the tree's fixed-point scale, computed once per tree by the grower
    scale = hm.exact_scale(grad, hess, cnt)

    def k1():
        return hm.fused_route_hist(bins, grad, hess, cnt, d["row_node"],
                                   *route, num_slots=S_FUSED, bmax=BMAX,
                                   scale=scale)

    def k1_ref():
        return hm.fused_route_hist_ref(bins, grad, hess, cnt,
                                       d["row_node"], *route,
                                       num_slots=S_FUSED, bmax=BMAX,
                                       scale=scale)
    h, rn = k1()
    h_ref, rn_ref = k1_ref()
    check(torch.equal(rn, rn_ref), "fused_route_hist routing differs")
    err = check_hist(torch, "fused_route_hist", k1, h_ref)
    n_slot = int(((rs_ref >= 0) & (rs_ref < S_FUSED)).sum())
    # on the card K1 is K2 with counts, the partition and K7
    row("fused_route_hist", "lightgbm_tpu/learner/histogram_mxu.py:785",
        err, k1, k1_ref, 3,
        8 * n + n_routed + n_slot * (f + 12) + h.numel() * 4 + table_bytes,
        n_slot * f * 3, None, source="build_histograms_scatter")
    k1_widths(torch, hm, hp, d, scale)

    # K3 build_histograms at the fix-up passes' 511 slots
    rslot = d["row_slot"]

    def k3():
        return hm.build_histograms(bins, grad, hess, cnt, rslot,
                                   num_slots=S_HIST, bmax=BMAX, scale=scale)

    def k3_ref():
        return hm.build_histograms_ref(bins, grad, hess, cnt, rslot,
                                       num_slots=S_HIST, bmax=BMAX,
                                       scale=scale)
    h_ref = k3_ref()
    err = check_hist(torch, "build_histograms", k3, h_ref)
    n_slot = int((rslot >= 0).sum())
    row("build_histograms", "lightgbm_tpu/learner/histogram_mxu.py:472",
        err, k3, k3_ref, 3,
        4 * n + n_slot * (f + 12) + h_ref.numel() * 4, n_slot * f * 3,
        index_add_fn(torch, bins, rslot, torch.stack([grad, hess, cnt], 1),
                     S_HIST, BMAX), source="build_histograms_scatter")

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
        n_slot * f * 3, None, source="build_histograms_scatter")

    def k3q():
        return hm.build_histograms(bins, g_q, h_q, cnt, rslot,
                                   num_slots=S_HIST, bmax=BMAX,
                                   quantized=True)

    def k3q_ref():
        return hm.build_histograms_ref(bins, g_q, h_q, cnt, rslot,
                                       num_slots=S_HIST, bmax=BMAX,
                                       quantized=True)
    h_ref = k3q_ref()
    err = check_hist(torch, "build_histograms integer mode", k3q, h_ref)
    row("build_histograms_int", "lightgbm_tpu/learner/histogram_mxu.py:472",
        err, k3q, k3q_ref, 3,
        4 * n + n_slot * (f + 6) + h_ref.numel() * 4, n_slot * f * 3,
        index_add_fn(torch, bins, rslot, torch.stack(
            [g_q.int(), h_q.int(), cnt.int()], 1), S_HIST, BMAX),
        source="build_histograms_scatter")
    del h, h_ref

    sampled_rows(torch, hm, hp, rng_mod, d, row, dev)
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
        # fixed-point integer sums: bit for bit, and across two calls
        err = check_hist(torch, f"node_sums at {m} nodes", k5, k5_ref())
    keep = torch.nonzero((node >= 0) & (node < M_REFIT))[:, 0]
    idx5 = node[keep].long()
    data5 = torch.stack([grad, hess, cnt], 1)[keep].contiguous()
    acc5 = torch.zeros((M_REFIT, 3), device=dev)
    row("node_sums", "lightgbm_tpu/learner/histogram_mxu.py:1192", err,
        k5, k5_ref, 5, 16 * n + M_REFIT * 12, 3 * int(keep.numel()),
        lambda: acc5.index_add_(0, idx5, data5))
    node_sums_checks(torch, hm, dev)
    prune_rows(torch, dev, row)
    predict_binned_rows(torch, dev, row)
    return rows


def k1_widths(torch, hm, hp, d, scale):
    """K1 f32 and integer at every kernel width of the exact path's
    doubling and bridge passes (K1_WIDTHS slots) on the kernel inputs, the
    route tables' slots folded into the width (slot mod S; parked rows stay
    parked), so that every slotted row lands in one of the S slots (at S =
    1 every run of the partition writes a partial that the reduce adds).
    Per width: the call's ms and device ms in both modes, and the device
    ms of its first two steps (K2 with chunk tallies, the partition given
    them). Holds both
    modes bit for bit to the plain version at S = 1."""
    bins, cnt = d["bins"], d["cnt"]
    tbl = d["tbl"]
    out = []
    for s in K1_WIDTHS:
        t = tbl.clone()
        slots = t[:, hm.TBL_SLOT:]
        t[:, hm.TBL_SLOT:] = torch.where(slots >= 0, slots % s, slots)
        route = (t, d["member"], d["feat_tbl"])
        entry = {"slots": s}
        for mode, g, h, kw in (("f32", d["grad"], d["hess"],
                                dict(scale=scale)),
                               ("int", d["g_q"], d["h_q"],
                                dict(quantized=True))):
            def k1():
                return hm.fused_route_hist(bins, g, h, cnt, d["row_node"],
                                           *route, num_slots=s, bmax=BMAX,
                                           **kw)
            if s == 1:
                want, want_node = hm.fused_route_hist_ref(
                    bins, g, h, cnt, d["row_node"], *route, num_slots=1,
                    bmax=BMAX, **kw)
                check(torch.equal(k1()[1], want_node),
                      "fused_route_hist routing differs at 1 slot")
                check_hist(torch, f"fused_route_hist {mode} at 1 slot", k1,
                           want)
                del want, want_node
            entry[mode] = {"ms": time_ms(torch, k1, 20),
                           "device_ms": device_ms(torch, k1)}

        def k2c():
            return hm.route_rows(bins, d["row_node"], *route,
                                 emit_counts=True, num_slots=s,
                                 chunk_tallies=True)
        _, slot, tallies = k2c()
        entry["route_counts_device_ms"] = device_ms(torch, k2c)
        entry["partition_device_ms"] = device_ms(
            torch, lambda: hp._partition(slot, s, 1024, None, "auto",
                                         tallies, True))
        entry["rows_slotted"] = int(tallies[:s].sum())
        out.append(entry)
    emit("kernel_detail", name="fused_route_hist_widths", widths=out,
         what="K1 (route_rows with tallies, the partition, K7) at the exact "
              "path's kernel widths, 1M x 28, 256 bins; the rows' slots "
              "folded into each width")


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

    # K2's counts modes: the chunk tallies K1 and the pallas backend hand
    # to the partition (the row), and the [S] counts (route_rows' own)
    def k2c():
        return hm.route_rows(bins, d["row_node"], *route, emit_counts=True,
                             num_slots=S_TUNE, chunk_tallies=True)

    def k2c_ref():
        return hm.route_rows_ref(bins, d["row_node"], *route,
                                 emit_counts=True, num_slots=S_TUNE,
                                 chunk_tallies=True)
    got, want = k2c(), k2c_ref()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "route_rows tally mode differs from its plain version")
    _, slot, tallies = want
    counts = tallies[:S_TUNE].sum(1).to(torch.int32)
    check(int(counts.sum()) == int(((slot >= 0) & (slot < S_TUNE)).sum()),
          "route tallies do not add up to the slotted rows")

    def k2s():
        return hm.route_rows(bins, d["row_node"], *route, emit_counts=True,
                             num_slots=S_TUNE)
    check(all(torch.equal(a, b) for a, b in zip(k2s(), hm.route_rows_ref(
        bins, d["row_node"], *route, emit_counts=True, num_slots=S_TUNE)))
        and torch.equal(k2s()[2], counts),
        "route_rows counts mode differs from its plain version")
    emit("kernel_check", name="route_rows_counts", mode="[S] counts",
         slots=S_TUNE, equal=True, ms=time_ms(torch, k2s, 20),
         device_ms=device_ms(torch, k2s))
    chunks = tallies.shape[1]
    row("route_rows_counts", "lightgbm_tpu/learner/histogram_mxu.py:1065",
        0.0, k2c, k2c_ref, 5,
        12 * n + n_routed + table_bytes + 4 * tallies.numel(), 0, None,
        source="route_rows")

    partition_checks(torch, hm, hp, dev)
    tb = -(-n // 1024) + S_TUNE + 1

    def part():
        # as K1 and the pallas backend call it: given the tallies, its
        # outputs in the device's scratch buffer
        return hp._partition(slot, S_TUNE, 1024, None, "auto", tallies,
                             True)[:2]

    def part_ref():
        return hp.partition_rows_ref(slot, num_slots=S_TUNE, row_block=1024,
                                     tallies=tallies)
    # the library yardstick: a stable torch.sort of the rows' slots (the
    # out-of-range ones as the trash slot) orders the rows as the
    # partition lays them out
    key = torch.where((slot >= 0) & (slot < S_TUNE), slot, S_TUNE)
    src = part_ref()[1]
    laid = src[src < n].long()
    check(torch.equal(laid, torch.sort(key, stable=True)
                      .indices[:laid.numel()]),
          "a stable sort of the slots orders the rows otherwise than the "
          "partition")
    # row_slot and the tallies read; block_slot, src and bounds written
    row("partition_rows", "lightgbm_tpu/learner/histogram_pallas.py:106",
        0.0, part, part_ref, 5,
        4 * n + 4 * tallies.numel() + 4 * tb * 1025 + 4 * (S_TUNE + 2), 0,
        lambda: torch.sort(key, stable=True))
    emit("kernel_detail", name="partition_rows",
         torch_partition_rows_ms=time_ms(torch, part_ref, 20),
         # None: the torch partition waits for the device
         torch_partition_rows_device_ms=device_ms(torch, part_ref,
                                                  strict=False),
         counting_itself_ms=time_ms(torch, lambda: hp.partition_rows(
             slot, num_slots=S_TUNE, row_block=1024), 20),
         counting_itself_device_ms=device_ms(torch, lambda: hp.partition_rows(
             slot, num_slots=S_TUNE, row_block=1024)),
         what="the torch partition that the kernel replaces "
              "(partition_rows_ref: stable radix sort, searchsorted, "
              "gathers), and the kernel counting for itself; route tallies "
              "given, 1M rows, 263 slots")
    emit("kernel_detail", name="launches_apart", slots=S_TUNE,
         chunks=chunks, launches=launch_parts(torch, {
             "partition_given_tallies": part,
             "partition_counting_itself": lambda: hp.partition_rows(
                 slot, num_slots=S_TUNE, row_block=1024),
             "route_rows_tallies": k2c, "route_rows_counts": k2s,
             "route_rows": lambda: hm.route_rows(bins, d["row_node"],
                                                 *route)}),
         what="device ms of a launch of each kernel a call launches, and "
              "its launches a call (torch.profiler, 20 calls), 1M x 28, "
              "1024 route nodes; null where the profiler recorded no "
              "device time")

    def scatter(dd, sl, cts, quantized, num_slots=S_TUNE):
        """K7 against its plain version, bit for bit, and against the
        per-row histogram of the same rows (build_histograms_ref, the
        other backend's function): (max abs error, kernel call, plain
        call). cts: route_rows' chunk tallies (2-D), as the pallas backend
        hands them over, or per-slot counts."""
        g, h = (dd["g_q"], dd["h_q"]) if quantized else \
            (dd["grad"], dd["hess"])
        kw = dict(num_slots=num_slots, bmax=BMAX, quantized=quantized)
        if not quantized:
            kw["scale"] = hm.exact_scale(dd["grad"], dd["hess"], dd["cnt"])
        k7_kw = dict(kw, **{"slot_tallies" if cts.dim() == 2
                            else "slot_counts": cts})

        def k7():
            return hp.build_histograms_scatter(dd["bins"], g, h, dd["cnt"],
                                               sl, **k7_kw)

        def k7_ref():
            return hp.build_histograms_scatter_ref(
                dd["bins"], g, h, dd["cnt"], sl, **k7_kw)
        want = k7_ref()
        err = check_hist(torch, "build_histograms_scatter" +
                         "_int" * quantized, k7, want)
        check(same_bits(torch, want, hm.build_histograms_ref(
            dd["bins"], g, h, dd["cnt"], sl, **kw)),
            "K7's plain version differs from build_histograms_ref")
        return err, k7, k7_ref

    n_slot = int(((slot >= 0) & (slot < S_TUNE)).sum())
    for quantized, name, chan_bytes, cols in (
            (True, "build_histograms_scatter_int", 6,
             torch.stack([d["g_q"].int(), d["h_q"].int(), cnt.int()], 1)),
            (False, "build_histograms_scatter", 12,
             torch.stack([d["grad"], d["hess"], cnt], 1))):
        err, k7, k7_ref = scatter(d, slot, tallies, quantized)
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
    _, wslot, wtallies = hm.route_rows(
        dw["bins"], dw["row_node"], dw["tbl"], dw["member"], dw["feat_tbl"],
        emit_counts=True, num_slots=S_TUNE, chunk_tallies=True)
    for quantized in (True, False):
        err, k7, k7_ref = scatter(dw, wslot, wtallies, quantized)
        emit("kernel_check", name="build_histograms_scatter" +
             ("_int" if quantized else ""), rows=WIDE_ROWS,
             features=WIDE_FEATURES, slots=S_TUNE, max_abs_err=err,
             ms=time_ms(torch, k7, 20), device_ms=device_ms(torch, k7),
             plain_ms=time_ms(torch, k7_ref, 3))

    # K3 at the wide quantized path's shape: 511 slots of ~200 rows each
    # (most partition positions are padding), 200 features, a 314 MB
    # output; beside one index_add_ of the same cells
    wslot = dw["row_slot"]
    for quantized in (True, False):
        g, h = (dw["g_q"], dw["h_q"]) if quantized else \
            (dw["grad"], dw["hess"])
        kw = dict(num_slots=S_HIST, bmax=BMAX, quantized=quantized)
        if not quantized:
            kw["scale"] = hm.exact_scale(g, h, dw["cnt"])

        def k3w():
            return hm.build_histograms(dw["bins"], g, h, dw["cnt"], wslot,
                                       **kw)
        err = check_hist(torch, "build_histograms" + "_int" * quantized +
                         " (wide)", k3w, hm.build_histograms_ref(
                             dw["bins"], g, h, dw["cnt"], wslot, **kw))
        cols = torch.stack([g.int(), h.int(), dw["cnt"].int()], 1) \
            if quantized else torch.stack([g, h, dw["cnt"]], 1)
        lib = index_add_fn(torch, dw["bins"], wslot, cols, S_HIST, BMAX)
        emit("kernel_check", name="build_histograms" + "_int" * quantized,
             rows=WIDE_ROWS, features=WIDE_FEATURES, slots=S_HIST,
             max_abs_err=err, ms=time_ms(torch, k3w, 20),
             device_ms=device_ms(torch, k3w),
             library_ms=time_ms(torch, lib, 20),
             library_device_ms=device_ms(torch, lib))
        del lib
    del dw


def partition_checks(torch, hm, hp, dev):
    """The partition kernel against partition_rows_ref, element for
    element (block_slot and src; the kernel's slot bounds against
    slot_bounds of the torch layout), given chunk tallies, given counts
    and counting for itself, at 1 slot (the root pass), 263 and 511, with
    3% of rows parked at -1 and 1% past the last slot, at 1M rows and at
    999,983 (not a multiple of the chunk)."""
    rng = np.random.RandomState(13)
    u = rng.rand(N_ROWS)
    cases = []
    for s in (1, S_TUNE, S_HIST):
        sl = rng.randint(0, s, N_ROWS)
        sl[u < 0.03] = -1
        sl[(u >= 0.03) & (u < 0.04)] = s + 1
        for n in (N_ROWS, 999_983):
            t = torch.as_tensor(sl[:n].astype(np.int32), device=dev)
            tallies = hm.chunk_tallies_ref(t, s)
            want_bs, want_src = hp.partition_rows_ref(t, num_slots=s,
                                                      row_block=1024)
            for what, c, tl in (
                    ("tallies", None, tallies),
                    ("counts", tallies[:s].sum(1).to(torch.int32), None),
                    ("itself", None, None)):
                # given tallies, as K1 calls it: into the scratch buffer
                block_slot, src, bounds = hp._partition(
                    t, s, 1024, c, "auto", tl, tl is not None)
                case = f"{s} slots, {n} rows, {what}"
                check(torch.equal(block_slot, want_bs) and
                      torch.equal(src, want_src),
                      f"partition kernel differs from partition_rows_ref: "
                      f"{case}")
                check(torch.equal(bounds[:s + 1].long(),
                                  hp.slot_bounds(want_bs, s)),
                      f"partition kernel slot bounds differ: {case}")
                cases.append(case)
    emit("partition_check", cases=cases, equal=True)


def kernel_name(key):
    """A device kernel's function name from the profiler's key, as
    "void (anonymous namespace)::scatter_kernel<true>(int const*, ...)"
    gives it."""
    key = key.replace("(anonymous namespace)::", "")
    name = re.search(r"(\w+)\s*(<[^(]*>)?\s*\(", key)
    return name.group(1) if name else key[:60]


def launch_parts(torch, fns):
    """{name: {kernel: {"device_ms": a launch, "launches": a call}}} for
    each fn: torch.profiler over 20 calls, the kernels by name; None where
    the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for what, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us > 0:
                parts[kernel_name(e.key)] = {"device_ms": us / 1e3 / e.count,
                                             "launches": e.count / 20}
        out[what] = parts or None
    return out


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


def node_sums_checks(torch, hm, dev):
    """K5 bit for bit against node_sums_ref (NaN where the plain version
    has NaN) beyond the refit's shape: 5000 nodes (past the kernel's
    shared-memory copy: global atomics), one row, 1000 rows, values over
    sixty decades, a NaN gradient and an infinite hessian on an ignored
    row (NaN channels), and every row in one node."""
    rng = np.random.RandomState(23)
    cases = []
    for what, n, m in (("5000 nodes", N_ROWS, 5000), ("one row", 1, 7),
                       ("1000 rows", 1000, 510),
                       ("sixty decades", N_ROWS, 510),
                       ("nan grad, inf hess", N_ROWS, 510),
                       ("one node", N_ROWS, 1)):
        node = rng.randint(-1, m + 1, n).astype(np.int32)
        g = rng.randn(n).astype(np.float32)
        h = rng.uniform(0.01, 0.3, n).astype(np.float32)
        c = np.ones(n, np.float32)
        if what == "sixty decades":
            g *= np.float32(10.0) ** rng.randint(-30, 30, n) \
                .astype(np.float32)
        elif what.startswith("nan"):
            g[n // 2] = np.nan
            node[7], h[7] = -1, np.inf
        elif what == "one node":
            node[:] = 0
        args = [torch.as_tensor(a, device=dev) for a in (node, g, h, c)]
        got = hm.node_sums(*args, num_nodes=m)
        want = hm.node_sums_ref(*args, num_nodes=m)
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
            f"node_sums differs from its plain version: {what}")
        cases.append(what)
    emit("kernel_check", name="node_sums", cases=cases, bit_equal=True)


def packed_rows(torch, hm, hp, rng_mod, dev, row):
    """The 4-bit packed modes of K1, K2 (plain, counts, tallies), K4 (behind
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

    # K2 packed: plain, [S] counts (checked) and chunk tallies (K1's mode)
    for mode, kw in (("plain", dict()),
                     ("counts", dict(emit_counts=True, num_slots=S_TUNE)),
                     ("tallies", dict(emit_counts=True, num_slots=S_TUNE,
                                      chunk_tallies=True))):
        def k2p(kw=kw):
            return hm.route_rows(pk, rnode, *route, num_features=f, **kw)

        def k2p_ref(kw=kw):
            return hm.route_rows_ref(pk, rnode, *route, num_features=f,
                                     **kw)
        got, want = k2p(), k2p_ref()
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and
              all(torch.equal(a, b) for a, b in zip(want, hm.route_rows_ref(
                  d["bins"], rnode, *route, **kw))),
              f"route_rows packed ({mode}) differs")
        if mode == "counts":
            continue
        tallies = mode == "tallies"
        row("route_rows" + "_counts" * tallies + "_packed",
            src + ":1065", 0.0, k2p, k2p_ref, 3,
            12 * n + n_routed + table_bytes +
            4 * (want[2].numel() if tallies else 0), 0, None,
            source="route_rows")
    _, slot, tallies = want

    for quantized in (False, True):
        g, h = (d["g_q"], d["h_q"]) if quantized else (d["grad"], d["hess"])
        kw = dict(num_slots=S_FUSED, bmax=BMAX_PACKED, quantized=quantized,
                  num_features=f)
        if not quantized:
            kw["scale"] = hm.exact_scale(g, h, cnt)

        def k1p():
            return hm.fused_route_hist(pk, g, h, cnt, rnode, *route, **kw)

        def k1p_ref():
            return hm.fused_route_hist_ref(pk, g, h, cnt, rnode, *route,
                                           **kw)
        (hist, rn), (h_ref, rn_ref) = k1p(), k1p_ref()
        check(torch.equal(rn, rn_ref), "fused_route_hist packed routing")
        err = check_hist(torch, "fused_route_hist packed" +
                         " integer mode" * quantized, k1p, h_ref)
        n_slot = int(((slot >= 0) & (slot < S_FUSED)).sum())
        chan = 6 if quantized else 12
        row("fused_route_hist" + "_int" * quantized + "_packed",
            src + ":785", err, k1p, k1p_ref, 3,
            8 * n + n_routed + n_slot * (fh + chan) + hist.numel() * 4 +
            table_bytes, n_slot * f * 3, None,
            source="build_histograms_scatter")

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
                 *a, slot_tallies=tallies, **k),
             lambda *a, **k: hp.build_histograms_scatter_ref(
                 *a, slot_tallies=tallies, **k),
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
            lib, source="build_histograms_scatter")

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


def split_inputs(torch, hm, sk, d, s, bmax, seed=11):
    """K8's inputs at s slots: histograms of kernel_inputs' rows `d` (two
    NaN-bin and two categorical features) at bmax bins, every 37th slot
    empty, random parent outputs and per-slot feature masks. Returns
    (hist, args, modes): args as find_best_splits_kernel takes them after
    hist, and modes {launch-count name: (hp, monotone kwargs)}, plain and
    monotone (+1 on feature 0, -1 on feature 1, per-slot output bounds,
    depth penalty)."""
    from lightgbm_tpu_torch.learner.split import SplitHyperParams
    dev = d["bins"].device
    f = d["bins"].shape[1]
    num_bins, missing_is_nan = d["feat_tbl"][:, 0], d["feat_tbl"][:, 1] > 0
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[[5, 11]] = True
    rng = np.random.RandomState(seed)
    plain = SplitHyperParams(min_data_in_leaf=20)
    mono_hp = dataclasses.replace(plain, has_monotone=True,
                                  monotone_penalty=1.5)
    monotone = torch.zeros(f, dtype=torch.int32, device=dev)
    monotone[0], monotone[1] = 1, -1

    def t(a):
        return torch.as_tensor(a, device=dev)
    hist = hm.build_histograms(d["bins"], d["grad"], d["hess"], d["cnt"],
                               d["row_slot"], num_slots=s, bmax=bmax)
    hist[::37] = 0.0        # empty slots: no split, the junk selection
    sums = hist[:, 0].sum(1)                                       # [S, 3]
    args = (sums[:, 0], sums[:, 1], sums[:, 2],
            t(rng.randn(s).astype(np.float32) * 0.1), num_bins,
            missing_is_nan, is_cat,
            t((rng.rand(s, f) < 0.8).astype(np.float32)))
    bound = t(rng.uniform(0.05, 0.5, s).astype(np.float32))
    mono_kw = dict(monotone=monotone, cons_min=-bound, cons_max=bound,
                   depth=t(rng.randint(0, 12, s).astype(np.int32)))
    return hist, args, {"find_best_splits": (plain, {}),
                        "find_best_splits_mono": (mono_hp, mono_kw)}


def k8_work(torch, sk, hist, tables):
    """(bytes, thresholds) K8 needs on these inputs: the bins a slot's
    unmasked features need (0 .. num_bins - 2: the thresholds and, with a
    NaN bin, that bin), 12 bytes each, every table read once and the
    selection written once; and the thresholds it evaluates, {NaN bin:
    count}, by whether their feature has a NaN bin."""
    parent, fmask, feat_tbl, mono = tables
    b = hist.shape[2]
    num_bins = feat_tbl[:, 0].long()
    m_nan = feat_tbl[:, 1] > 0
    t_limit = num_bins - 2 - m_nan.long()
    on = ((fmask > 0) & (t_limit >= 0)[None, :]).long()            # [S, F]
    cap = torch.full_like(num_bins, b)
    need = torch.clamp(torch.minimum(num_bins - 1, cap), min=0)
    cand = (on * torch.clamp(torch.minimum(t_limit + 1, cap), min=0)[None])
    nbytes = int((on * need[None]).sum()) * 12 + sum(
        x.numel() * 4 for x in tables if x is not None) + \
        hist.shape[0] * sk.N_OUT * 4
    return nbytes, {nan: int(cand[:, m_nan == nan].sum())
                    for nan in (False, True)}


def nonfinite_check(torch, sk, hist, tables, hp, name):
    """K8 on histograms with an inf, a -inf and a NaN cell: the selection
    equal to the plain version's."""
    bad = hist.clone()
    bad[3, 2, 10, 0] = float("inf")
    bad[7, 4, 20, 1] = float("nan")
    bad[11, 6, 0, 2] = float("-inf")
    got = sk._launch(bad, *tables, hp)
    want = sk.find_best_splits_kernel_ref(bad, *tables, hp)
    sel = slice(sk.O_HAS, sk.O_NAL + 1)
    check(torch.equal(got[:, sel], want[:, sel]),
          f"{name} with non-finite cells: the selection differs from its "
          "plain version")
    emit("kernel_check", name=name, what="inf, -inf and NaN cells",
         selection_equal=True)


def split_rows(torch, hm, rng_mod, dev, row):
    """K8 (find_best_splits) at the scan path's shapes: split_inputs at
    511 slots (the fix-up passes' scan width) and 263, at 256 bins, at the
    packed width (15 bins: two 16-lane features a warp) and at K8_ODD_BINS;
    plain and monotone mode. Each launch is held to the plain version on
    every slot: the selection (has_split, feature, threshold, NaN
    direction) equal, the picked sums within 1e-6 relative."""
    from lightgbm_tpu_torch.learner import split_kernel as sk
    from lightgbm_tpu_torch.learner.split import find_best_splits
    for bmax in (BMAX, BMAX_PACKED) + K8_ODD_BINS:
        d = kernel_inputs(torch, hm, rng_mod, dev, bmax=bmax)
        for s in (S_HIST, S_FUSED):
            hist, args, modes = split_inputs(torch, hm, sk, d, s, bmax)
            for name, (hp, kw) in modes.items():
                tables = sk.pack_inputs(*args, hp, **kw)

                def k8():
                    return sk._launch(hist, *tables, hp)

                def k8_ref():
                    return sk.find_best_splits_kernel_ref(hist, *tables, hp)
                got, want = k8(), k8_ref()
                torch.cuda.synchronize()
                at = f"{name} at {s} slots, {bmax} bins"
                sel = slice(sk.O_HAS, sk.O_NAL + 1)
                check(torch.equal(got[:, sel], want[:, sel]),
                      f"{at}: the selection differs from its plain version "
                      "on slots " + str(torch.nonzero(
                          (got[:, sel] != want[:, sel]).any(1))[:8, 0]
                          .tolist()))
                sums_sel = slice(sk.O_LR, sk.O_LL + 3)
                diff = (got[:, sums_sel] - want[:, sums_sel]).abs()
                err = float(diff.max())
                rel = float((diff / want[:, sums_sel].abs().clamp(
                    min=1e-30)).max())
                check(rel <= 1e-6, f"{at}: picked sums rel error {rel}")
                n_split = int(got[:, sk.O_HAS].sum())
                nbytes, cands = k8_work(torch, sk, hist, tables)
                inst = sum(K8_INST[(bool(kw), nan)] * n
                           for nan, n in cands.items())
                if bmax != BMAX:
                    emit("kernel_check", name=name, slots=s, bins=bmax,
                         slots_split=n_split, max_abs_err=err,
                         sums_equal=bool(torch.equal(got, want)),
                         device_ms=device_ms(torch, k8))
                    continue
                whole = dict(
                    wrapper_ms=time_ms(
                        torch, lambda: sk.find_best_splits_kernel(
                            hist, *args, hp, **kw), 20),
                    find_best_splits_ms=time_ms(
                        torch, lambda: find_best_splits(hist, *args, hp,
                                                        **kw), 20))
                if s == S_HIST:
                    row(name, "lightgbm_tpu/learner/split_kernel.py:249",
                        err, k8, k8_ref, 5, nbytes, inst, None,
                        source="find_best_splits",
                        ops_per_s=F32_INST_PER_S)
                    emit("kernel_detail", name=name, slots=s,
                         slots_split=n_split, instructions=inst,
                         sums_equal=bool(torch.equal(got, want)),
                         what="the whole wrapper (kernel + [S] recompute) "
                              "and split.find_best_splits on the same "
                              "inputs", **whole)
                    if s == S_HIST:
                        nonfinite_check(torch, sk, hist, tables, hp, name)
                else:
                    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    bound_ops = inst / F32_INST_PER_S * 1e3
                    emit("kernel_check", name=name, slots=s, bins=bmax,
                         slots_split=n_split, max_abs_err=err,
                         sums_equal=bool(torch.equal(got, want)),
                         ms=time_ms(torch, k8, 20),
                         device_ms=device_ms(torch, k8),
                         plain_ms=time_ms(torch, k8_ref, 5),
                         bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops
                         else "operations", **whole)
        del d


def overgrown_tree(rng, m1, n_splits, ties):
    """(left, right, parent [m1] i32, gain [m1] f32) of a random tree of
    n_splits splits in an m1 node space, ids given as the grower gives
    them (children after their parent, in pairs; the last id is scratch);
    gains from five values where `ties`."""
    left = np.full(m1, -1, np.int32)
    right = np.full(m1, -1, np.int32)
    parent = np.full(m1, -1, np.int32)
    leaves, nn = [0], 1
    for _ in range(n_splits):
        j = leaves.pop(rng.randint(len(leaves)))
        left[j], right[j] = nn, nn + 1
        parent[nn] = parent[nn + 1] = j
        leaves += [nn, nn + 1]
        nn += 2
    gain = (rng.randint(1, 6, m1) if ties else rng.rand(m1) * 10) \
        .astype(np.float32)
    return left, right, parent, np.where(left >= 0, gain, 0) \
        .astype(np.float32)


def prune_rows(torch, dev, row):
    """The prune kernel (prune_best_first) against its plain version,
    every output equal: at the main path's shape (an overgrown tree of
    510 leaves in 1020 ids, 255 kept; the row), with tied gains, a tree
    smaller than the leaves asked for, and 4000 ids (several nodes a
    thread, 125 a lane). Bound: the bytes of its inputs and outputs and,
    as operations, the JAX formulation's compares (every node each replay
    step) at the f32 rate; the replay is 254 dependent steps, so neither
    bounds it (PERF.md)."""
    from lightgbm_tpu_torch.learner import prune
    rng = np.random.RandomState(31)
    cases = []
    timed = {}
    for what, m1, splits, leaves, ties in (
            ("main path", M_GROWN, M_GROWN // 2 - 1, PRUNE_LEAVES, False),
            ("tied gains", M_GROWN, M_GROWN // 2 - 1, PRUNE_LEAVES, True),
            ("small tree", M_GROWN, 100, PRUNE_LEAVES, True),
            ("4000 ids", 4000, 1999, 1000, False),
            ("NaN gains", M_GROWN, M_GROWN // 2 - 1, PRUNE_LEAVES, False),
            ("integer-tied gains", M_GROWN, M_GROWN // 2 - 1, PRUNE_LEAVES,
             True),
            ("rising chain", M_GROWN, M_GROWN // 2 - 1, PRUNE_LEAVES,
             False),
            ("10240 ids", prune.PRUNE_MAX_NODES,
             prune.PRUNE_MAX_NODES // 2 - 1, 2000, False)):
        left, right, parent, gain = overgrown_tree(rng, m1, splits, ties)
        if what == "NaN gains":       # a NaN pop uses a step, selects nothing
            gain[rng.rand(m1) < 0.1] = np.nan
            gain[rng.rand(m1) < 0.05] = np.inf
        if what == "integer-tied gains":   # three values: long tie runs
            gain = np.where(left >= 0, rng.randint(1, 4, m1), 0) \
                .astype(np.float32)
        if what == "rising chain":    # one group, the whole tree: the
            # kernel replays every step (its worst case)
            left[:], right[:], parent[:] = -1, -1, -1
            for j in range(0, 2 * splits, 2):
                left[j], right[j] = j + 1, j + 2
                parent[j + 1] = parent[j + 2] = j
            gain = np.where(left >= 0, np.arange(m1), 0).astype(np.float32)
        args = [torch.as_tensor(a, device=dev)
                for a in (left, right, parent, gain)]

        def k(args=args, leaves=leaves):
            return prune.prune_best_first(*args, num_leaves=leaves)

        def k_ref(args=args, leaves=leaves):
            return prune.prune_best_first_ref(*args, num_leaves=leaves)
        got, want = k(), k_ref()
        names = ("sel", "kept", "new_id", "composed")
        bad = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
        check(not bad, f"prune_best_first differs from its plain version "
              f"({what}): {bad}")
        cases.append(what)
        if what in ("rising chain", "tied gains", "NaN gains"):
            timed[what.replace(" ", "_") + "_device_ms"] = device_ms(
                torch, k)
        if what == "main path":
            nbytes = m1 * (16 + 10)      # 4 inputs, 4 outputs of [m1]
            ops = (leaves - 1) * m1 + 2 * m1 * (m1 - 1).bit_length()
            row("prune_best_first",
                "lightgbm_tpu/learner/grower_mxu.py:57", 0.0, k, k_ref, 3,
                nbytes, ops, None)
    emit("kernel_check", name="prune_best_first", cases=cases, equal=True,
         **timed)


def random_trees(rng, k, m1, leaves, f, bmax, words, cat_share):
    """k trees in the grower's layout ([m1] node arrays, children after
    their parent, -1 beyond num_nodes), grown by splitting a random leaf
    until `leaves` leaves: random features and threshold bins, NaN
    directions, and a share of categorical nodes with random bin sets
    (int64 words of 32 bits). Returns a dict of [k, ...] numpy arrays."""
    out = {"split_feature": np.full((k, m1), -1, np.int32),
           "threshold_bin": np.zeros((k, m1), np.int32),
           "default_left": rng.rand(k, m1) < 0.5,
           "is_cat": np.zeros((k, m1), bool),
           "cat_bitset": np.zeros((k, m1, words), np.int64),
           "left": np.full((k, m1), -1, np.int32),
           "right": np.full((k, m1), -1, np.int32),
           "leaf_value": (0.1 * rng.randn(k, m1)).astype(np.float32)}
    for t in range(k):
        open_leaves, n = [0], 1
        while len(open_leaves) < leaves and n + 2 <= m1:
            j = open_leaves.pop(rng.randint(len(open_leaves)))
            out["split_feature"][t, j] = rng.randint(f)
            out["threshold_bin"][t, j] = rng.randint(bmax - 1)
            if rng.rand() < cat_share:
                out["is_cat"][t, j] = True
                for b in np.nonzero(rng.rand(32 * words) < 0.5)[0]:
                    out["cat_bitset"][t, j, b // 32] |= 1 << int(b % 32)
            out["left"][t, j], out["right"][t, j] = n, n + 1
            open_leaves += [n, n + 1]
            n += 2
    return out


def predict_binned_rows(torch, dev, row):
    """The traversal kernel (predict_binned, kernel V) against its plain
    version at the valid phase's shapes: 10 stacked trees of 255 leaves in
    510 node ids over 40,000 rows x 28 features of 256 bins (two features
    with a NaN bin), from a score (the row: bit for bit, trajectory and
    leaf ids); then categorical trees (8 words), a bitset narrower than the
    bins (2 words: bins from 64 up read the last word, as the JAX gather
    clamps) and one tree without a score (predict_binned_tree,
    leaf_index_tree). Bound: the bytes the walk needs (each row's bins on
    its paths, the trees' nodes, the score in, the trajectory out) or its
    node visits at the f32 rate; library: the PyTorch indexing walk, one
    gather a level to the tree's depth, no host sync (its device ms timed
    as one CUDA graph: its launches would fill the queue)."""
    from lightgbm_tpu_torch.learner import predict as pr
    from lightgbm_tpu_torch.learner.grower import TreeArrays
    rng = np.random.RandomState(41)
    n, f, k, leaves = VALID_ROWS, N_FEATURES, VALID_TRAJ_TREES, 255
    m1 = 2 * leaves
    bins = torch.as_tensor(rng.randint(0, BMAX, (n, f)).astype(np.uint8),
                           device=dev)
    num_bins = torch.full((f,), BMAX, dtype=torch.int32, device=dev)
    nan = np.zeros(f, bool)
    nan[[1, 5]] = True
    nan = torch.as_tensor(nan, device=dev)
    score0 = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)

    def stacked(arrays):
        z = torch.zeros(k, m1, device=dev)
        zi = torch.zeros((k, m1), dtype=torch.int32, device=dev)
        one = torch.ones((), dtype=torch.int32, device=dev)
        return TreeArrays(
            **{key: torch.as_tensor(v, device=dev)
               for key, v in arrays.items()},
            parent=zi, sum_grad=z, sum_hess=z, count=z, gain=z, depth=zi,
            is_leaf=torch.as_tensor(arrays["split_feature"] < 0,
                                    device=dev),
            num_nodes=one.expand(k), num_leaves=one.expand(k))

    cases = []
    for what, words, cat_share in (("main path", (BMAX + 31) // 32, 0.0),
                                   ("categorical", (BMAX + 31) // 32, 0.3),
                                   ("narrow bitset", 2, 0.5)):
        arrays = random_trees(rng, k, m1, leaves, f, BMAX, words, cat_share)
        trees = stacked(arrays)
        traj, leaf = pr.stacked_leaf_nodes(trees, bins, num_bins, nan,
                                           score0)
        fin, want, want_leaf = pr.stacked_score_traj_ref(
            trees, score0, bins, num_bins, nan, leaves=True)
        check(same_bits(torch, traj, want) and torch.equal(leaf, want_leaf),
              f"predict_binned differs from its plain version ({what})")
        one = TreeArrays(*[t[0] for t in trees])
        check(same_bits(torch, pr.predict_binned_tree(one, bins, num_bins,
                                                      nan),
                        pr.predict_binned_tree_ref(one, bins, num_bins,
                                                   nan)) and
              torch.equal(pr.leaf_index_tree(one, bins, num_bins, nan),
                          pr.leaf_index_tree_ref(one, bins, num_bins, nan)),
              f"predict_binned_tree/leaf_index_tree differ ({what})")
        cases.append(what)
        if what != "main path":
            continue
        # the bound: each row's bins on its paths once, the nodes present
        # (22 bytes of fields each), the score in and the trajectory out
        # (walked up from each row's leaf through the parents)
        rows_ = torch.arange(n, device=dev)
        seen = torch.zeros((n, f), dtype=torch.bool, device=dev)
        visits, depth = 0, []
        sf = trees.split_feature.long()
        parent = np.full((k, m1), -1, np.int64)
        for t in range(k):
            inner = np.nonzero(arrays["left"][t] >= 0)[0]
            parent[t, arrays["left"][t][inner]] = inner
            parent[t, arrays["right"][t][inner]] = inner
        parent = torch.as_tensor(parent, device=dev)
        for t in range(k):
            cur, d = leaf[t].long(), 0
            while True:
                up = parent[t][cur]
                active = up >= 0
                m = int(active.sum())
                if m == 0:
                    break
                up = up.clamp(min=0)
                visits += m
                seen[rows_[active], sf[t][up][active]] = True
                cur = torch.where(active, up, cur)
                d += 1
            depth.append(d)
        nodes = int((np.asarray(arrays["left"]) >= 0).sum()) * 2 + k
        nbytes = int(seen.sum()) + 22 * nodes + 4 * n + 4 * k * n

        def kern(trees=trees):
            return pr.stacked_score_traj(trees, score0, bins, num_bins, nan)

        def plain(trees=trees):
            return pr.stacked_score_traj_ref(trees, score0, bins, num_bins,
                                             nan)

        def library(trees=trees, depth=depth):
            s_ = score0
            for t in range(k):
                node = torch.zeros(n, dtype=torch.int64, device=dev)
                for _ in range(depth[t]):
                    feat = sf[t][node]
                    b = bins[rows_, feat.clamp(min=0)].int()
                    go = torch.where(nan[feat.clamp(min=0)] &
                                     (b == BMAX - 1),
                                     trees.default_left[t][node],
                                     b <= trees.threshold_bin[t][node])
                    nxt = torch.where(go, trees.left[t][node],
                                      trees.right[t][node]).long()
                    node = torch.where(feat >= 0, nxt, node)
                s_ = s_ + trees.leaf_value[t][node]
            return s_
        row("predict_binned", "lightgbm_tpu/learner/predict.py:25 "
            "(_traverse, predict_binned_tree; lightgbm_tpu/boosting/"
            "fused.py:54 stacked_score_traj; XLA, no Pallas)", 0.0, kern,
            plain, 3, nbytes, visits, library, library_graph=True)
    more, timed = predict_binned_modes(torch, dev, rng, bins, num_bins, nan)
    emit("kernel_check", name="predict_binned", cases=cases + more,
         equal=True, rows=n, trees=k, node_ids=m1, **timed)


def predict_binned_modes(torch, dev, rng, bins, num_bins, nan):
    """Kernel V beyond the main path's case, each bit for bit against its
    plain version over the valid phase's 40,000 rows: a 50-tree class
    block (10 steps of 5 classes of 255-leaf trees, which the kernel
    takes in chunks of whole steps that fit shared memory) and one tree
    into one class's column; uint16 bins at 1024 bins; 30 stacked trees,
    in chunks, with and without a score; and trees too large
    for shared memory (10,000 leaves in 20,000 node ids; 20,000 leaves in
    40,000 ids, past the records' 16-bit child ids), which walk the node
    arrays in global memory. The bundled mode is held at its shapes in
    the efb phase (efb_traversal_row). Returns (cases, device ms of the
    class block, the uint16 trees and each large tree)."""
    from lightgbm_tpu_torch.learner import predict as pr
    from lightgbm_tpu_torch.learner.grower import TreeArrays
    n, f = bins.shape

    def stack(arrays, lead):
        t0 = int(np.prod(lead))
        m1_ = arrays["left"].shape[-1]
        z = torch.zeros((t0, m1_), device=dev)
        zi = torch.zeros((t0, m1_), dtype=torch.int32, device=dev)
        one = torch.ones((t0,), dtype=torch.int32, device=dev)
        flat = TreeArrays(
            **{key: torch.as_tensor(v, device=dev)
               for key, v in arrays.items()},
            parent=zi, sum_grad=z, sum_hess=z, count=z, gain=z, depth=zi,
            is_leaf=torch.as_tensor(arrays["split_feature"] < 0,
                                    device=dev),
            num_nodes=one, num_leaves=one)
        return TreeArrays(*[t.reshape(tuple(lead) + tuple(t.shape[1:]))
                            for t in flat])

    words = (BMAX + 31) // 32
    cases = []
    k, c, m1 = VALID_TRAJ_TREES, MC_CLASSES, 510
    trees = stack(random_trees(rng, k * c, m1, 255, f, BMAX, words, 0.2),
                  (k, c))
    score0 = torch.as_tensor(rng.randn(n, c).astype(np.float32), device=dev)
    _, traj = pr.stacked_score_traj(trees, score0, bins, num_bins, nan,
                                    num_class=c)
    _, want = pr.stacked_score_traj_ref(trees, score0, bins, num_bins, nan,
                                        num_class=c)
    one = TreeArrays(*[t[4, 1] for t in trees])
    check(same_bits(torch, traj, want) and same_bits(
        torch, pr.class_score_add(one, score0, 1, bins, num_bins, nan),
        pr.class_score_add_ref(one, score0, 1, bins, num_bins, nan)),
        "predict_binned_class differs from its plain version (50-tree "
        "class block)")
    cases.append("50-tree class block")
    timed = {"class_block_device_ms": device_ms(
        torch, lambda: pr.stacked_score_traj(trees, score0, bins, num_bins,
                                             nan, num_class=c))}

    wide_bins = torch.as_tensor(rng.randint(0, 1024, (n, f))
                                .astype(np.uint16), device=dev)
    wide_nb = torch.full((f,), 1024, dtype=torch.int32, device=dev)
    trees = stack(random_trees(rng, k, m1, 255, f, 1024, 32, 0.2), (k,))
    score = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    traj, leaf = pr.stacked_leaf_nodes(trees, wide_bins, wide_nb, nan,
                                       score)
    _, want, want_leaf = pr.stacked_score_traj_ref(
        trees, score, wide_bins, wide_nb, nan, leaves=True)
    check(same_bits(torch, traj, want) and torch.equal(leaf, want_leaf),
          "predict_binned differs from its plain version (uint16 bins)")
    cases.append("uint16 bins")
    timed["uint16_device_ms"] = device_ms(
        torch, lambda: pr.stacked_score_traj(trees, score, wide_bins, wide_nb,
                                             nan))

    # 30 trees of 510 ids: more than a chunk's records (23 trees), so the
    # adds of a chunk start from the trajectory point before it, with a
    # score and without one (the first point the first leaf value)
    long = stack(random_trees(rng, 30, m1, 255, f, BMAX, words, 0.1), (30,))
    for s_ in (score, None):
        traj, leaf = pr.stacked_leaf_nodes(long, bins, num_bins, nan, s_)
        _, want, want_leaf = pr.stacked_score_traj_ref(
            long, s_, bins, num_bins, nan, leaves=True)
        check(same_bits(torch, traj, want) and torch.equal(leaf, want_leaf),
              "predict_binned differs from its plain version (30 trees in "
              f"chunks, score {'given' if s_ is not None else 'none'})")
    cases.append("30 trees in chunks")

    for leaves_ in (10_000, 20_000):
        big = stack(random_trees(rng, 1, 2 * leaves_, leaves_, f, BMAX,
                                 words, 0.1), (1,))
        traj, leaf = pr.stacked_leaf_nodes(big, bins, num_bins, nan, score)
        _, want, want_leaf = pr.stacked_score_traj_ref(
            big, score, bins, num_bins, nan, leaves=True)
        check(same_bits(torch, traj, want) and torch.equal(leaf, want_leaf),
              f"predict_binned differs from its plain version (a tree of "
              f"{leaves_} leaves)")
        cases.append(f"{leaves_}-leaf tree")
        timed[f"tree_{leaves_}_leaves_device_ms"] = device_ms(
            torch, lambda: pr.stacked_score_traj(big, score, bins, num_bins,
                                                 nan))
    return cases, timed


def native_host_phase(lgt, X, y, booster):
    """The native host runtime (lightgbm_tpu_torch/cext, C++ built with
    g++ at first use) against its numpy plain versions at 1M x 28: the
    bin mappers (repr-equal: bounds can be NaN) and the bin matrix (byte
    for byte), then the host model of the main path's 10-tree booster:
    raw predictions (bit for bit: both add each row's leaf values in tree
    order in float64) and leaf indices (equal). Prints the seconds of
    each."""
    from lightgbm_tpu_torch import cext
    from lightgbm_tpu_torch.data import BinnedDataset, Metadata
    cfg = lgt.Config(TRAIN_PARAMS)
    kw = dict(max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
              sample_cnt=cfg.bin_construct_sample_cnt,
              use_missing=cfg.use_missing,
              zero_as_missing=cfg.zero_as_missing,
              seed=cfg.data_random_seed)
    cext.build_all()
    out, timed = {}, {}
    for native in (True, False):
        t0 = time.perf_counter()
        out[native] = BinnedDataset.from_raw(X, Metadata(len(y), label=y),
                                             native=native, **kw)
        timed["binning_s_" + ("native" if native else "numpy")] = \
            time.perf_counter() - t0
    check([repr(m.to_dict()) for m in out[True].mappers] ==
          [repr(m.to_dict()) for m in out[False].mappers],
          "native bin mappers differ from numpy's")
    check(out[True].bins.dtype == out[False].bins.dtype and
          np.array_equal(out[True].bins, out[False].bins),
          "native bin matrix differs from numpy's")
    model = booster._host_model()
    pred = {}
    for what, kw in (("host_predict", {"raw_score": True}),
                     ("pred_leaf", {"pred_leaf": True})):
        for native in (True, False):
            t0 = time.perf_counter()
            pred[what, native] = model.predict(X, native=native, **kw)
            timed[f"{what}_s_" + ("native" if native else "numpy")] = \
                time.perf_counter() - t0
    check(np.array_equal(pred["host_predict", True],
                         pred["host_predict", False]),
          "native raw predictions differ from the numpy walk's")
    check(np.array_equal(pred["pred_leaf", True], pred["pred_leaf", False]),
          "native leaf indices differ from the numpy walk's")
    emit("native_host", rows=N_ROWS, features=N_FEATURES,
         trees=len(model.trees), mappers_repr_equal=True,
         bins_byte_equal=True, predictions_bit_equal=True,
         leaves_equal=True, gxx_flags=dict(cext.FLAGS_USED),
         host_cpus=os.cpu_count(), **timed)


def valid_path(torch, lgt, hm, ds, y):
    """Validation sets on train's block dispatch (binary exact, 1M x 28,
    255 leaves), against fused_block_size 1, metrics binary_logloss and
    auc on a held-out set binned with the training mappers:
    (a) 30 rounds with record_evaluation: every inner iteration's valid
    scores (the block's trajectory, from the traversal kernel) bit-equal
    to the per-iteration run's, the model text byte-equal, the recorded
    AUC of the last iteration within 1e-6 of the host model's, the host
    model's predictions within 1e-4 of the device valid scores; trees/s
    beside a run without a valid set, host syncs a tree, the kernel's
    launches; (b) the labels permuted under a fixed seed with
    early_stopping_round 3, so the stop falls inside the first block:
    best_iteration, best_score, current_iteration and model text equal to
    the per-iteration run's; (c) feval and the training set among the
    valid sets, which force one iteration a dispatch: the model of (a).
    Returns the launch counts of the three."""
    Xva, yva = make_higgs_like(VALID_ROWS, N_FEATURES, seed=99)
    yperm = yva[np.random.RandomState(7).permutation(VALID_ROWS)]

    def strip(text):
        return "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("[fused_block_size:"))

    def marker(marks):
        """A callback that notes the time, the card drained, when the first
        block's last iteration is evaluated: the trees after it are
        replays alone (no capture, no eager first tree)."""
        def mark(env):
            if env.iteration == VALID_TRAJ_TREES - 1:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
        mark.block_safe = True
        mark.order = 26
        return mark

    def run(block, label, rounds=VALID_ROUNDS, with_train=False, **kw):
        params = dict(VALID_PARAMS, fused_block_size=block,
                      **kw.pop("params", {}))
        valid = ds.create_valid(Xva, label=label)
        ev, snaps, marks = {}, [], []

        def snap(env):
            # reads only the valid scores, which the engine pins to each
            # inner iteration's trajectory point
            snaps.append(env.model.gbdt.valid_scores[-1].clone())
        snap.block_safe = True
        snap.order = 25
        before = hm.launch_counts()["predict_binned"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = lgt.train(
            params, ds, rounds,
            valid_sets=[ds, valid] if with_train else [valid],
            callbacks=[lgt.record_evaluation(ev), snap, marker(marks)],
            **kw)
        torch.cuda.synchronize()
        end = time.perf_counter()
        return {"booster": booster, "s": end - t0, "ev": ev, "snaps": snaps,
                "last20_s": end - marks[0] if marks else None,
                "v_launches": hm.launch_counts()["predict_binned"] - before}

    def syncs_per_tree(booster):
        """A fused run's host reads a tree: the fix-up loop's reads of
        `done`, the lagged stall polls and the trajectories' copies."""
        gb = booster.gbdt
        reads = sum(sum(st["fixup_reads"]) for st in gb.fused_stats)
        return (reads + gb.stall_polls + gb.valid_host_copies) / \
            booster.current_iteration()

    hm.reset_launch_counts()
    plain_marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = lgt.train(VALID_PARAMS, ds, VALID_ROUNDS,
                      callbacks=[marker(plain_marks)])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_last20_s = t0 + plain_s - plain_marks[0]
    del plain
    a10, a1 = run(10, yva), run(1, yva)
    b10 = a10["booster"]
    check(len(a10["snaps"]) == len(a1["snaps"]) == VALID_ROUNDS and all(
        same_bits(torch, p, q) for p, q in zip(a10["snaps"], a1["snaps"])),
        "valid: the block's valid-score trajectory differs from the "
        "per-iteration run's valid scores")
    model = b10.model_to_string()
    check(strip(model) == strip(a1["booster"].model_to_string()),
          "valid: model text differs between fused_block_size 10 and 1")
    host = b10.predict(Xva, raw_score=True)
    host_auc = auc(host, yva)
    rec_auc = a10["ev"]["valid_0"]["auc"][-1]
    dev_err = float(np.abs(host - b10.gbdt.valid_scores[0].cpu().numpy())
                    .max())
    check(abs(rec_auc - host_auc) <= 1e-6, f"valid: recorded AUC {rec_auc} "
          f"vs the host model's {host_auc}")
    check(dev_err <= 1e-4, f"valid: host predict vs device valid score "
          f"{dev_err}")
    emit("valid", rows=N_ROWS, valid_rows=VALID_ROWS, rounds=VALID_ROUNDS,
         fused_block_size=[10, 1], trajectory_bit_equal=True,
         model_txt_byte_equal=True, recorded_auc=rec_auc,
         host_model_auc=host_auc, host_vs_device_valid_max_abs=dev_err,
         logloss_last=a10["ev"]["valid_0"]["binary_logloss"][-1],
         train_s_no_valid=plain_s, train_s_valid=[a10["s"], a1["s"]],
         trees_per_s_no_valid=VALID_ROUNDS / plain_s,
         trees_per_s_valid=[VALID_ROUNDS / a10["s"], VALID_ROUNDS / a1["s"]],
         trees_per_s_last20_no_valid=(VALID_ROUNDS - VALID_TRAJ_TREES) /
         plain_last20_s,
         trees_per_s_last20_valid=[
             (VALID_ROUNDS - VALID_TRAJ_TREES) / r["last20_s"]
             for r in (a10, a1)],
         capture_s=[st["capture_s"] for st in b10.gbdt.fused_stats],
         host_syncs_per_tree=syncs_per_tree(b10),
         valid_host_copies=b10.gbdt.valid_host_copies,
         predict_binned_launches=[a10["v_launches"], a1["v_launches"]])
    del a1

    es = {"early_stopping_round": 3}
    b10, b1 = run(10, yperm, params=es), run(1, yperm, params=es)
    x, z = b10["booster"], b1["booster"]
    same = (x.best_iteration == z.best_iteration and
            x.current_iteration() == z.current_iteration() and
            dict(x.best_score) == dict(z.best_score) and
            strip(x.model_to_string()) == strip(z.model_to_string()))
    emit("valid_early_stop", labels="permuted (seed 7)",
         early_stopping_round=3, best_iteration=x.best_iteration,
         best_iteration_block1=z.best_iteration,
         current_iteration=x.current_iteration(),
         current_iteration_block1=z.current_iteration(),
         best_score={k: dict(v) for k, v in x.best_score.items()},
         equal_to_block1=same, seconds=[b10["s"], b1["s"]])
    check(same, "valid: an early stop at fused_block_size 10 differs from "
          "the per-iteration run's")
    check(1 < x.current_iteration() < 10, "valid: the early stop did not "
          f"fall inside the first block ({x.current_iteration()} trees)")
    del b10, b1, x, z

    def feval(score, data):
        return "score_mean", float(np.mean(score)), False
    c = run(10, yva, with_train=True, feval=feval)
    check(c["booster"].model_to_string() == model,
          "valid: the per-iteration cadence (feval, the training set as a "
          "valid set) gives another model")
    check("score_mean" in c["ev"]["training"] and
          len(c["ev"]["valid_1"]["auc"]) == VALID_ROUNDS,
          f"valid: feval/training entries missing: {list(c['ev'])}")
    emit("valid_per_iteration", rounds=VALID_ROUNDS, train_s=c["s"],
         trees_per_s=VALID_ROUNDS / c["s"], model_equal_to_fused=True,
         eval_entries={k: list(v) for k, v in c["ev"].items()},
         valid_host_copies_per_tree=c["booster"].gbdt.valid_host_copies /
         VALID_ROUNDS,
         predict_binned_launches=c["v_launches"])
    del c
    counts = hm.launch_counts()
    for key in VALID_PATH:
        check(counts[key] > 0, f"{key} was not launched on the valid path")
    return counts


def fused_path(torch, lgt, hm, ds, y):
    """K iterations per dispatch: for each of FUSED_RUNS (the exact and
    the quantized binary configurations, trees that run fix-up passes,
    the split options with extra_trees), engine.train at the default
    fused_block_size (10: iteration 0 on the per-iteration path, the other
    9 trees through the fused trainer's CUDA graphs; train frees the
    trainer when it is done), then Booster.update_batch(10) twice on the
    same booster (a new trainer: its first tree eager, a capture, 9
    replays; then 10 replays), against Booster.update() 30 times, in turns
    (per-iteration, fused, fused, per-iteration). The model text after 10,
    20 and 30 trees must be byte-equal (sha256) to the per-iteration
    run's; every program captured; the launches equal the per-iteration
    run's plus the fix-up kernels of the no-op passes the trainers report.
    Then `del booster`, with garbage collection paused, must give back
    the graphs' memory pool, and leave as many bytes allocated as the
    runs after the first. Prints trees/s of both paths (the last 10 trees:
    replays alone), the host reads of `done` a tree (with the lagged stall
    poll, the block's syncs), graph memory, capture seconds and the
    memory before and after the booster goes. Returns the launch counts
    and each configuration's trees/s (fused_turns)."""
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    rates = {name: fused_turns(torch, lgt, hm, ds, logloss, name, params)
             for name, params in FUSED_RUNS}
    counts = hm.launch_counts()
    for key in FUSED_PATH:
        check(counts[key] > 0, f"{key} was not launched on the fused path")
    return counts, rates


def fused_turns(torch, lgt, hm, ds, logloss, name, params, inspect=None,
                classes=1):
    """One configuration of the fused phases (fused_path): train, then
    update_batch(10) twice, against 30 update() calls, in turns
    (per-iteration, fused, fused, per-iteration), every check of
    fused_path, and the phase line `name`. inspect(booster) -> dict runs
    on each turn's booster after its 30 iterations (before it is deleted)
    and its results are printed as `inspected`. classes: trees an
    iteration (multiclass). Returns the trees/s of the last 10 iterations
    of each turn."""
    import hashlib
    steps = ("10", "20", "30")

    def sha(booster):
        return hashlib.sha256(booster.model_to_string().encode()) \
            .hexdigest()

    def timed(fn):
        """(seconds, launches, fn's result) of one call of fn."""
        before = hm.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, {
            k: v - before[k] for k, v in hm.launch_counts().items()}, result

    def update_loop(booster):
        for _ in range(TRAIN_TREES):
            booster.update()
        return booster

    def update_batch(booster):
        booster.update_batch(TRAIN_TREES)
        return booster

    def noops(booster):
        return sum(st["noop_fixups"] for st in booster.gbdt.fused_stats)

    runs = []
    for path in ("per_iteration", "fused", "fused", "per_iteration"):
        out = {"path": path}
        fused = path == "fused"
        booster = None
        for step in steps:
            if step == "10":
                fn = (lambda: lgt.train(params, ds, TRAIN_TREES)) \
                    if fused else \
                    (lambda: update_loop(lgt.Booster(params, ds)))
            else:
                fn = (lambda: update_batch(booster)) if fused else \
                    (lambda: update_loop(booster))
            n0 = 0 if booster is None else noops(booster)
            out["s" + step], out["l" + step], booster = timed(fn)
            out["noop" + step] = noops(booster) - n0
            out["sha" + step] = sha(booster)
        out["logloss"] = float(logloss(booster.gbdt.train_score))
        out["leaves"] = [int(t.num_leaves) for t in booster.gbdt.trees]
        if inspect is not None:
            out["inspected"] = inspect(booster)
        if fused:
            trainer = booster.gbdt._fused_run
            out["stats"] = [dict(st) for st in booster.gbdt.fused_stats]
            out["stall_polls"] = booster.gbdt.stall_polls
            out["programs"] = list(trainer.programs)
            out["fixup_tally"] = dict(trainer.graphs["fixup"][1])
            del trainer
        # the booster goes with reference counts alone: with garbage
        # collection paused, its trainer's graph pool must be given
        # back
        held = card_memory(torch)
        collecting = gc.isenabled()
        gc.disable()
        try:
            del booster
            torch.cuda.empty_cache()
            freed = card_memory(torch)
        finally:
            if collecting:
                gc.enable()
        out["memory"] = {"held": held, "after_del": freed,
                         "released_bytes": held["reserved"] -
                         freed["reserved"]}
        runs.append(out)
    eager = [r for r in runs if r["path"] == "per_iteration"]
    fused = [r for r in runs if r["path"] == "fused"]
    for r in runs:
        check(all(r["sha" + k] == eager[0]["sha" + k] for k in steps),
              f"{name}: {r['path']} model text differs from the "
              "per-iteration run's")
    for r in fused:
        st = r["stats"]
        check([s_["graphs"] for s_ in st] == [len(r["programs"])] * 2
              and [s_["trees"] for s_ in st] ==
              [(TRAIN_TREES - 1) * classes, 2 * TRAIN_TREES * classes],
              f"{name}: graphs {[s_['graphs'] for s_ in st]} of "
              f"{len(r['programs'])} programs, trees "
              f"{[s_['trees'] for s_ in st]}")
        check(min(r["leaves"]) > 1, f"{name}: a tree stalled")
        for k in steps:
            noop = r["noop" + k]
            want = {key: v + noop * r["fixup_tally"].get(key, 0)
                    for key, v in eager[0]["l" + k].items()}
            check(r["l" + k] == want, f"{name}: fused launches "
                  f"{r['l' + k]} are not the per-iteration run's "
                  f"{want} plus {noop} no-op fix-up passes")
        mem = r["memory"]
        check(mem["released_bytes"] >= st[1]["graph_pool_bytes"] > 0,
              f"{name}: del booster gave back {mem['released_bytes']} "
              f"bytes, less than its graphs' pool "
              f"{st[1]['graph_pool_bytes']}")
    # from the second run on (the first fused run may size a scratch
    # buffer for the warm-up's fix-up pass), every booster leaves the
    # same bytes behind: a trainer leaves nothing
    left = [r["memory"]["after_del"]["allocated"] for r in runs]
    check(len(set(left[1:])) == 1, f"{name}: bytes allocated after "
          f"each booster went: {left}")
    st = fused[0]["stats"]
    trees = sum(s_["trees"] for s_ in st)
    reads = sum(sum(s_["fixup_reads"]) for s_ in st)
    emit(name, params={k: v for k, v in params.items()
                       if k != "verbosity"},
         trees=3 * TRAIN_TREES * classes, fused_block_size=TRAIN_TREES,
         model_sha256_10=eager[0]["sha10"][:16],
         model_sha256_30=eager[0]["sha30"][:16], byte_equal=True,
         order=[r["path"] for r in runs],
         train_s_first10=[r["s10"] for r in runs],
         train_s_next10=[r["s20"] for r in runs],
         train_s_last10=[r["s30"] for r in runs],
         trees_per_s_first10=[TRAIN_TREES * classes / r["s10"]
                              for r in runs],
         trees_per_s_next10=[TRAIN_TREES * classes / r["s20"]
                             for r in runs],
         trees_per_s_last10=[TRAIN_TREES * classes / r["s30"]
                             for r in runs],
         graphs=st[0]["graphs"], programs=fused[0]["programs"],
         capture_s=[s_["capture_s"] for r in fused
                    for s_ in r["stats"]],
         graph_pool_bytes=[s_["graph_pool_bytes"] for r in fused
                           for s_ in r["stats"]],
         buffer_bytes=st[0]["buffer_bytes"],
         fixup_passes_per_tree=[s_["fixup_passes"] for s_ in st],
         noop_fixups=[s_["noop_fixups"] for s_ in st],
         done_reads_per_tree=reads / trees,
         stall_polls=fused[0]["stall_polls"],
         host_syncs_per_tree=(reads + fused[0]["stall_polls"]) / trees,
         fixup_tally=fused[0]["fixup_tally"],
         launches_fused_first10=fused[0]["l10"],
         launches_per_iteration_first10=eager[0]["l10"],
         memory=[r["memory"] for r in runs],
         logloss=[r["logloss"] for r in runs],
         **({"inspected": [r["inspected"] for r in runs]}
            if inspect is not None else {}))
    return [TRAIN_TREES * classes / r["s30"] for r in runs]


def card_memory(torch):
    """The card's reserved and allocated bytes, after its queued work."""
    torch.cuda.synchronize()
    return {"reserved": torch.cuda.memory_reserved(),
            "allocated": torch.cuda.memory_allocated()}


def fused_configs_check(torch, lgt, X, y, ds):
    """engine.train's fused path (CUDA graphs) beside update() in the
    configurations the fused phases do not run: the quantized backends
    (pallas, scatter, auto), exact pallas, packed bins exact and
    quantized, L2 regression exact and quantized; FUSED_CHECK_TREES trees
    each. The model text must be byte-equal and the train scores
    bit-equal, with every program captured. A check, not a path."""
    import hashlib
    y_reg = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3]) \
        .astype(np.float32)
    reg_params = {k: v for k, v in TRAIN_PARAMS.items() if k != "objective"}
    packed = lgt.Dataset(X, label=y, params=PACKED_PARAMS)
    reg = lgt.Dataset(X, label=y_reg, params=reg_params)
    runs = (("quantized_pallas", ds,
             dict(QUANT_PARAMS, hist_backend="pallas")),
            ("quantized_scatter", ds,
             dict(QUANT_PARAMS, hist_backend="scatter")),
            ("quantized_auto", ds, dict(QUANT_PARAMS, hist_backend="auto")),
            ("exact_pallas", ds, dict(TRAIN_PARAMS, hist_backend="pallas")),
            ("packed", packed, PACKED_PARAMS),
            ("packed_quantized", packed,
             dict(PACKED_PARAMS, use_quantized_grad=True)),
            ("regression", reg, reg_params),
            ("regression_quantized", reg,
             dict(reg_params, use_quantized_grad=True)))
    out = {}
    for name, data, params in runs:
        a = lgt.Booster(params, data)
        for _ in range(FUSED_CHECK_TREES):
            a.update()
        b = lgt.train(params, data, FUSED_CHECK_TREES)
        st = b.gbdt.fused_stats
        same = a.model_to_string() == b.model_to_string() and torch.equal(
            a.gbdt.train_score.view(torch.int32),
            b.gbdt.train_score.view(torch.int32))
        check(same, f"fused {name}: model text or scores differ from "
              "update()'s")
        check(len(st) == 1 and st[0]["graphs"] == st[0]["programs"] and
              b.gbdt._fused_run is None,
              f"fused {name}: trainers {st}: not one, with every program "
              "captured, freed by train")
        out[name] = hashlib.sha256(b.model_to_string().encode()) \
            .hexdigest()[:16]
        del a, b
        torch.cuda.empty_cache()
    emit("fused_configs", trees=FUSED_CHECK_TREES, byte_equal=True,
         model_sha256=out)


def fused_scratch_check(torch, lgt, hm, X, y):
    """Two boosters that share the card's scratch buffers: a small one
    (SCRATCH_SMALL_ROWS rows) captures its graphs through update_batch,
    a larger one (SCRATCH_LARGE_ROWS rows, more than any earlier phase)
    grows the scratch buffers, and the small one then trains on by
    replaying its graphs while the larger one lives. Its model text must
    be byte-equal to FUSED_CHECK_TREES x 2 update() calls: the graphs
    write the buffers their trainer holds, not memory the growth freed.
    A check, not a path."""
    import hashlib

    def sha(booster):
        return hashlib.sha256(booster.model_to_string().encode()) \
            .hexdigest()

    small = lgt.Dataset(X[:SCRATCH_SMALL_ROWS], label=y[:SCRATCH_SMALL_ROWS],
                        params=TRAIN_PARAMS)
    ref = lgt.Booster(TRAIN_PARAMS, small)
    for _ in range(2 * FUSED_CHECK_TREES):
        ref.update()
    a = lgt.Booster(TRAIN_PARAMS, small)
    a.update_batch(FUSED_CHECK_TREES)
    dev = a.gbdt.train_score.device     # the scratch buffers' key
    before = {t.data_ptr() for t in hm.scratch_buffers(dev)}
    Xl, yl = make_higgs_like(SCRATCH_LARGE_ROWS, N_FEATURES, seed=23)
    big = lgt.Booster(TRAIN_PARAMS, lgt.Dataset(Xl, label=yl,
                                                params=TRAIN_PARAMS))
    big.update_batch(FUSED_CHECK_TREES)
    after = {t.data_ptr() for t in hm.scratch_buffers(dev)}
    replaced = len(before - after)
    check(replaced > 0, "the larger booster grew no scratch buffer: the "
          "check does not test what it should")
    a.update_batch(FUSED_CHECK_TREES)
    check(sha(a) == sha(ref), "a booster's graphs replayed after another "
          "booster grew the scratch buffers give another model than "
          "update()")
    check(all(st["graphs"] == st["programs"] for st in
              a.gbdt.fused_stats + big.gbdt.fused_stats),
          "a fused trainer of the scratch check did not capture every "
          "program")
    emit("fused_scratch_check", small_rows=SCRATCH_SMALL_ROWS,
         large_rows=SCRATCH_LARGE_ROWS, trees=2 * FUSED_CHECK_TREES,
         scratch_buffers_replaced=replaced, byte_equal=True,
         model_sha256=sha(a)[:16])
    del a, big, ref
    torch.cuda.empty_cache()


def sampled_inputs(torch, hm, rng_mod, d, dev):
    """The kernel inputs' gradients under the two samplers, through the
    port's own functions: a bagging mask at fraction 0.8 (counts 0/1) and
    GOSS at top_rate 0.2, other_rate 0.1 (counts 0/1, the sampled rest's
    gradients and hessians amplified 8x); each with its int8 quantized
    gradients. [(label, grad, hess, cnt, g_q, h_q)]"""
    from lightgbm_tpu_torch.boosting import gbdt as gb
    grad, hess = d["grad"], d["hess"]
    n = grad.shape[0]
    mask = gb._bag_mask(0, n=n, seed=3, freq=BAGGING["bagging_freq"],
                        fraction=gb._f32(BAGGING["bagging_fraction"]),
                        device=dev)
    out = [("bagged", grad * mask, hess * mask, mask)]
    out.append(("goss",) + gb._goss_sample(
        grad, hess, None, rng_mod.PRNGKey(5, dev), **goss_settings(gb, n)))
    res = []
    for label, g, h, c in out:
        g_q, h_q, _, _ = hm.quantize_gradients(g, h, rng_mod.PRNGKey(1, dev))
        res.append((label, g, h, c, g_q.to(torch.int8), h_q.to(torch.int8)))
    return res


def goss_settings(gb, n):
    """_goss_sample's settings at the sampling phases' GOSS rates."""
    return gb._goss_settings(n, GOSS["top_rate"], GOSS["other_rate"])


def sampled_rows(torch, hm, hp, rng_mod, d, row, dev):
    """K1 (f32 and integer), K3, K7 (integer) and K5 on sampled rows: the
    count channel a 0/1 mask (bagging, 0.8) and GOSS's weights and count
    (rows kept at 1 and at 8x, the rest at 0), at the kernel inputs'
    shapes (1M x 28, K1 and K7 at 263 slots, K3 at 511, K5 at 510 nodes),
    each bit for bit against its plain version and across two calls. The
    rows are timed on GOSS's inputs, and their bounds count what the
    function needs there: g, h and the count of every routed row (12
    bytes, 6 with int8 gradients), but a row's F bins and its F x 3 adds
    only where its count, g or h is not zero (about 30% of rows). Also
    prints GOSS's sampling, its top-k threshold alone and bagging's mask,
    ms at 1M rows."""
    from lightgbm_tpu_torch.boosting import gbdt as gb
    bins = d["bins"]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    n, f = bins.shape
    node_split = d["split"][d["row_node"].long()]
    n_routed = int(node_split.sum())
    table_bytes = d["tbl"].numel() * 4 + d["member"].numel() * 4
    _, slot, tallies = hm.route_rows_ref(
        bins, d["row_node"], *route, emit_counts=True, num_slots=S_TUNE,
        chunk_tallies=True)
    rslot = d["row_slot"]
    rng = np.random.RandomState(9)
    node = rng.randint(0, M_REFIT, n)
    u = rng.rand(n)
    node[u < 0.03] = -1
    node[(u >= 0.03) & (u < 0.04)] += M_REFIT
    node = torch.as_tensor(node.astype(np.int32), device=dev)
    n_fused = int(((slot >= 0) & (slot < S_FUSED)).sum())
    n_tune = int(((slot >= 0) & (slot < S_TUNE)).sum())
    n_hist = int((rslot >= 0).sum())
    kept = {}
    for label, g, h, c, g_q, h_q in sampled_inputs(torch, hm, rng_mod, d,
                                                   dev):
        scale = hm.exact_scale(g, h, c)
        kern = {
            "fused_route_hist": lambda: hm.fused_route_hist(
                bins, g, h, c, d["row_node"], *route, num_slots=S_FUSED,
                bmax=BMAX, scale=scale),
            "fused_route_hist_int": lambda: hm.fused_route_hist(
                bins, g_q, h_q, c, d["row_node"], *route,
                num_slots=S_FUSED, bmax=BMAX, quantized=True),
            "build_histograms": lambda: hm.build_histograms(
                bins, g, h, c, rslot, num_slots=S_HIST, bmax=BMAX,
                scale=scale),
            "build_histograms_scatter_int": lambda: hp.build_histograms_scatter(
                bins, g_q, h_q, c, slot, slot_tallies=tallies,
                num_slots=S_TUNE, bmax=BMAX, quantized=True),
            "node_sums": lambda: hm.node_sums(node, g, h, c,
                                              num_nodes=M_REFIT)}
        plain = {
            "fused_route_hist": lambda: hm.fused_route_hist_ref(
                bins, g, h, c, d["row_node"], *route, num_slots=S_FUSED,
                bmax=BMAX, scale=scale),
            "fused_route_hist_int": lambda: hm.fused_route_hist_ref(
                bins, g_q, h_q, c, d["row_node"], *route,
                num_slots=S_FUSED, bmax=BMAX, quantized=True),
            "build_histograms": lambda: hm.build_histograms_ref(
                bins, g, h, c, rslot, num_slots=S_HIST, bmax=BMAX,
                scale=scale),
            "build_histograms_scatter_int":
                lambda: hp.build_histograms_scatter_ref(
                    bins, g_q, h_q, c, slot, slot_tallies=tallies,
                    num_slots=S_TUNE, bmax=BMAX, quantized=True),
            "node_sums": lambda: hm.node_sums_ref(node, g, h, c,
                                                  num_nodes=M_REFIT)}
        for name, fn in kern.items():
            want = plain[name]()
            if name.startswith("fused_route_hist"):
                check(torch.equal(fn()[1], want[1]),
                      f"{name} routing differs on {label} rows")
                want = want[0]
            check_hist(torch, f"{name} on {label} rows", fn, want)
        emit("kernel_check", name="sampled_rows", rows=label,
             kept=float(c.sum()),
             amplified=int(((c > 0) & (g != d["grad"])).sum()),
             kernels=sorted(kern), equal=True)
        kept[label] = (kern, plain, g, h, c, g_q, h_q)
    kern, plain, g, h, c, g_q, h_q = kept["goss"]
    idx5 = node.long()
    keep5 = (node >= 0) & (node < M_REFIT)
    acc5 = torch.zeros((M_REFIT + 1, 3), device=dev)
    data5 = torch.stack([g, h, c], 1)
    sink = torch.where(keep5, idx5, M_REFIT)
    libs = {
        "fused_route_hist": None, "fused_route_hist_int": None,
        "build_histograms": index_add_fn(
            torch, bins, rslot, torch.stack([g, h, c], 1), S_HIST, BMAX),
        "build_histograms_scatter_int": index_add_fn(
            torch, bins, slot, torch.stack([g_q.int(), h_q.int(), c.int()],
                                           1), S_TUNE, BMAX),
        "node_sums": lambda: acc5.index_add_(0, sink, data5)}
    # the rows that add to a histogram: a count, g or h not zero (GOSS
    # zeroes all three of the rows it drops), in each kernel's slots
    live = (c != 0) | (g != 0) | (h != 0)
    live_q = (c != 0) | (g_q != 0) | (h_q != 0)
    in_fused = (slot >= 0) & (slot < S_FUSED)
    in_tune = (slot >= 0) & (slot < S_TUNE)
    in_hist = rslot >= 0
    l_fused, lq_fused = int((live & in_fused).sum()), int(
        (live_q & in_fused).sum())
    l_hist, lq_tune = int((live & in_hist).sum()), int(
        (live_q & in_tune).sum())
    h_fused = S_FUSED * f * BMAX * 12
    nbytes = {
        "fused_route_hist": 8 * n + n_routed + 12 * n_fused +
        f * l_fused + h_fused + table_bytes,
        "fused_route_hist_int": 8 * n + n_routed + 6 * n_fused +
        f * lq_fused + h_fused + table_bytes,
        "build_histograms": 4 * n + 12 * n_hist + f * l_hist +
        S_HIST * f * BMAX * 12,
        "build_histograms_scatter_int": 4 * n + 6 * n_tune + f * lq_tune +
        S_TUNE * f * BMAX * 12,
        "node_sums": 16 * n + M_REFIT * 12}
    ops = {"fused_route_hist": l_fused * f * 3,
           "fused_route_hist_int": lq_fused * f * 3,
           "build_histograms": l_hist * f * 3,
           "build_histograms_scatter_int": lq_tune * f * 3,
           "node_sums": 3 * int((keep5 & live).sum())}
    emit("kernel_detail", name="sampled_bounds", rows=n,
         live_rows={"fused": l_fused, "fused_int": lq_fused,
                    "hist": l_hist, "tune_int": lq_tune},
         routed_rows={"fused": n_fused, "hist": n_hist, "tune": n_tune},
         what="rows in each sampled row's slots, and those of them with a "
              "count, g or h not zero, on GOSS's inputs: the bound reads "
              "bins and counts adds for the second only")
    for name in kern:
        source = {"node_sums": "node_sums"}.get(name,
                                                "build_histograms_scatter")
        row(name + "_sampled", SAMPLED_REPLACES[name], 0.0, kern[name],
            plain[name], 3, nbytes[name], ops[name], libs[name],
            source=source)
    # GOSS's sampling and its threshold alone, and bagging's mask, on the
    # kernel inputs' 1M gradients (the bound: GOSS reads g and h and
    # writes g, h and the count, 20 bytes a row; the mask 4). The
    # samplers' threefry draws are ~200 (GOSS) and ~350 (the mask: its key
    # too) launches a call: device ms over 4 and 2 calls (more fill the
    # launch queue behind the sleep), None where even those were not
    # queued
    kw = goss_settings(gb, n)
    key = rng_mod.PRNGKey(5, dev)
    order = (d["grad"].abs() * d["hess"]).view(torch.int32)

    def goss():
        return gb._goss_sample(d["grad"], d["hess"], None, key, **kw)

    def bag():
        return gb._bag_mask(0, n=n, seed=3, freq=BAGGING["bagging_freq"],
                            fraction=gb._f32(BAGGING["bagging_fraction"]),
                            device=dev)
    emit("kernel_detail", name="samplers", rows=n, top_k=kw["top_k"],
         goss_ms=time_ms(torch, goss, 20),
         goss_device_ms=device_ms(torch, goss, reps=4, strict=False),
         goss_threshold_device_ms=device_ms(torch, lambda: torch.topk(
             order, kw["top_k"], sorted=False).values.min()),
         goss_bound_ms=20 * n / HBM_BYTES_PER_S * 1e3,
         bag_mask_ms=time_ms(torch, bag, 20),
         bag_mask_device_ms=device_ms(torch, bag, reps=2, strict=False),
         bag_mask_bound_ms=4 * n / HBM_BYTES_PER_S * 1e3,
         what="boosting/gbdt._goss_sample (|g| x h, the top-k threshold "
              "over order-preserving int32 keys, the uniform draw, the "
              "weights), torch.topk alone, and _bag_mask (the uniform "
              "draw and the comparison); torch ops, no kernel of the "
              "port")


def train_traversal_row(torch, row, gbdt, tree):
    """Kernel V at one tree over the training bins (DART re-predicts each
    dropped tree so, and the new tree when it rescales it): a 255-leaf
    tree of the DART run over the 1M x 28 training rows against its plain
    version, bit for bit. Bound: each row's bins on its path once, the
    tree's nodes (22 bytes each), the [N] output; or its node visits at
    the f32 rate. Library: the PyTorch indexing walk to the tree's
    depth (its device ms timed as one CUDA graph)."""
    from lightgbm_tpu_torch.learner import predict as pr
    bins = gbdt._train_bins_unpacked()
    num_bins, nan = gbdt.num_bins_d, gbdt.missing_is_nan_d
    n, f = bins.shape
    got = pr.predict_binned_tree(tree, bins, num_bins, nan)
    want = pr.predict_binned_tree_ref(tree, bins, num_bins, nan)
    check(same_bits(torch, got, want), "predict_binned differs from its "
          "plain version at one tree over the training rows")
    # each row's path, walked up from its leaf (the plain version's) by
    # the parents of the children arrays: the features it reads, its node
    # visits, the tree's depth
    rows_ = torch.arange(n, device=bins.device)
    sf = tree.split_feature.long()
    left, right = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    parent = np.full(left.shape[0], -1, np.int64)
    inner = np.nonzero(left >= 0)[0]
    parent[left[inner]] = inner
    parent[right[inner]] = inner
    parent = torch.as_tensor(parent, device=bins.device)
    cur = pr._traverse_ref(tree, bins, num_bins, nan).long()
    seen = torch.zeros((n, f), dtype=torch.bool, device=bins.device)
    visits, depth = 0, 0
    while True:
        up = parent[cur]
        active = up >= 0
        m = int(active.sum())
        if m == 0:
            break
        up = up.clamp(min=0)
        visits += m
        seen[rows_[active], sf[up][active]] = True
        cur = torch.where(active, up, cur)
        depth += 1
    nodes = int(tree.num_nodes)
    nbytes = int(seen.sum()) + 22 * nodes + 4 * n

    def library():
        nd = torch.zeros(n, dtype=torch.int64, device=bins.device)
        for _ in range(depth):
            feat = sf[nd].clamp(min=0)
            b = bins[rows_, feat].int()
            go = torch.where(nan[feat] & (b == num_bins[feat] - 1),
                             tree.default_left[nd],
                             b <= tree.threshold_bin[nd])
            nxt = torch.where(go, tree.left[nd], tree.right[nd]).long()
            nd = torch.where(sf[nd] >= 0, nxt, nd)
        return tree.leaf_value[nd]
    row("predict_binned_train", "lightgbm_tpu/learner/predict.py:25 "
        "(_traverse, predict_binned_tree; XLA, no Pallas)", 0.0,
        lambda: pr.predict_binned_tree(tree, bins, num_bins, nan),
        lambda: pr.predict_binned_tree_ref(tree, bins, num_bins, nan), 3,
        nbytes, visits, library, source="predict_binned",
        library_graph=True)
    return depth


def sampling_path(torch, lgt, hm, X, y, ds, row, fused_rates):
    """Row sampling, random forest and DART at the main path's width
    (binary, 1M x 28, 255 leaves), launch counts reset before and read
    after:
    (a) bagging (fraction 0.8, freq 5), GOSS (top_rate 0.2, other_rate
    0.1), both exact, and bagging with quantized gradients, each through
    fused_turns (train at fused_block_size 10, then update_batch(10)
    twice, against 30 update() calls: sha256-equal model text after 10, 20
    and 30 trees, two identical runs of each path); every turn's host
    predictions within 1e-4 of its device scores and held-out AUC above
    0.75; (b) bagging whose trees run fix-up passes (min_data_in_leaf
    1000: K3) and quantized bagging under hist_backend pallas (K7), 10
    trees, train against update(), byte-equal; (c) random forest
    (bagging_freq 1, fraction 0.7, 10 trees) and DART (drop_rate 0.1, 20
    trees), one iteration a dispatch: engine.train with a 40,000-row valid
    set (auc) against update() twice, byte-equal; host predictions within
    1e-4 of the averaged (RF: sum / trees + init score) or renormalized
    (DART) device scores (the Higgs-like labels are balanced, so RF's
    init score is 0 here and this check does not cover its init-score
    half, which the host model drops: ROADMAP C11, held on the CPU by
    tests/test_torch_sampling.py); the recorded AUC within 1e-6 of the
    host model's; DART's kernel V launches at least its dropped trees;
    then kernel V's row at one DART tree over the training rows. Prints
    trees/s beside the unsampled fused path's (same call), host syncs a
    tree and DART's V device ms a tree, derived: its launches a tree on
    update() x the one-tree row's device ms (not timed inside the run).
    Returns the launch counts."""
    import hashlib
    logloss = logloss_of(torch, y)
    Xva, yva = make_higgs_like(VALID_ROWS, N_FEATURES, seed=99)
    hm.reset_launch_counts()

    def inspect(booster):
        host = booster.predict(X, raw_score=True)
        return {"host_vs_device_max_abs": float(np.abs(
            host - booster.gbdt.train_score.cpu().numpy()).max()),
            "held_out_auc": held_out_auc(booster)}

    def inspect_checked(booster):
        r = inspect(booster)
        check(r["host_vs_device_max_abs"] <= 1e-4, f"{name}: host predict "
              f"vs device score {r['host_vs_device_max_abs']}")
        check(r["held_out_auc"] > 0.75, f"{name}: held-out AUC "
              f"{r['held_out_auc']} <= 0.75")
        return r

    rates = {}
    for name, params in SAMPLING_RUNS:
        rates[name] = fused_turns(torch, lgt, hm, ds, logloss, name, params,
                                  inspect=inspect_checked)
    for name, params in SAMPLING_CHECKS:
        a = lgt.Booster(params, ds)
        for _ in range(TRAIN_TREES):
            a.update()
        b = lgt.train(params, ds, TRAIN_TREES)
        st = b.gbdt.fused_stats
        check(a.model_to_string() == b.model_to_string() and torch.equal(
            a.gbdt.train_score.view(torch.int32),
            b.gbdt.train_score.view(torch.int32)),
            f"{name}: train's model text or scores differ from update()'s")
        check(len(st) == 1 and st[0]["graphs"] == st[0]["programs"],
              f"{name}: trainers {st}")
        emit(name, trees=TRAIN_TREES, byte_equal=True,
             fixup_passes=sum(st[0]["fixup_passes"]),
             model_sha256=hashlib.sha256(
                 b.model_to_string().encode()).hexdigest()[:16],
             **inspect(b))
        del a, b
        torch.cuda.empty_cache()

    for name, params, trees in (("sampling_rf", RF_PARAMS, RF_TREES),
                                ("sampling_dart", DART_PARAMS, DART_TREES)):
        params = dict(params, metric="auc")
        ev = {}
        valid = ds.create_valid(Xva, label=yva)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = lgt.train(params, ds, trees, valid_sets=[valid],
                      callbacks=[lgt.record_evaluation(ev)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        runs = []
        for _ in range(2):
            v0 = hm.launch_counts()["predict_binned"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = lgt.Booster(params, ds)
            for _ in range(trees):
                b.update()
            torch.cuda.synchronize()
            runs.append((b, time.perf_counter() - t0,
                         hm.launch_counts()["predict_binned"] - v0))
        text = a.model_to_string()
        check(all(r[0].model_to_string() == text for r in runs),
              f"{name}: update() runs or train give other model text")
        gb = a.gbdt
        check(gb.fused_stats == [] and not gb._fused_eligible(),
              f"{name}: ran through the fused trainer")
        score = gb.train_score.cpu().numpy()
        if name == "sampling_rf":
            score = score / gb.iter_ + np.float32(gb._init_score)
            check("average_output" in text, "rf: model is not averaged")
        host = a.predict(X, raw_score=True)
        err = float(np.abs(host - score).max())
        host_auc = auc(a.predict(Xva, raw_score=True), yva)
        rec_auc = ev["valid_0"]["auc"][-1]
        emit(name, params={k: v for k, v in params.items()
                           if k != "verbosity"}, trees=trees,
             byte_equal=True, train_s=train_s,
             trees_per_s_train=trees / train_s,
             trees_per_s_update=[trees / r[1] for r in runs],
             host_vs_device_max_abs=err, held_out_auc=host_auc,
             recorded_auc=rec_auc,
             init_score=getattr(gb, "_init_score", None),
             dropped=getattr(gb, "num_dropped", None),
             tree_weights=getattr(gb, "tree_weights", None),
             predict_binned_launches=[r[2] for r in runs],
             model_sha256=hashlib.sha256(text.encode()).hexdigest()[:16])
        check(err <= 1e-4, f"{name}: host predict vs device score {err}")
        check(host_auc > 0.75, f"{name}: held-out AUC {host_auc} <= 0.75")
        check(abs(rec_auc - host_auc) <= 1e-6, f"{name}: recorded AUC "
              f"{rec_auc} vs the host model's {host_auc}")
        if name == "sampling_dart":
            check(gb.num_dropped > 0 and all(
                r[2] >= r[0].gbdt.num_dropped for r in runs),
                f"dart: {[r[2] for r in runs]} V launches for "
                f"{gb.num_dropped} dropped trees")
            dart = (a, runs[0][2] / trees)
        del a, gb, runs, b
        torch.cuda.empty_cache()
    counts = hm.launch_counts()
    # V's row after the counts are read: its timing launches are not the
    # path's
    a, v_per_tree = dart
    depth = train_traversal_row(torch, row, a.gbdt, a.gbdt.trees[-1])
    v_row = next(r for r in row.rows if r["name"] == "predict_binned_train")
    dart_v = {"v_launches_per_tree": v_per_tree,
              "v_device_ms_per_tree_derived":
                  v_per_tree * v_row["device_ms"],
              "tree_depth": depth}
    del a, dart
    emit("sampling", trees_per_s_last10=rates,
         unsampled_trees_per_s_last10=fused_rates, dart=dart_v,
         what="trees/s of the last 10 of 30 trees in each turn "
              "(per-iteration, fused, fused, per-iteration), beside the "
              "unsampled fused phases of this call; DART's kernel V "
              "launches a tree on update() and their device ms, derived "
              "as launches x the device ms of V's one-tree row (the last "
              "DART tree over the training rows), not timed in the run")
    for key in SAMPLING_PATH:
        check(counts[key] > 0, f"{key} was not launched on the sampling "
              "path")
    check_partition_launches(counts, "sampling")
    return counts

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
    check_partition_launches(counts, "exact")
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
    check_partition_launches(counts, "quantized")
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
    be within 0.005 of the exact mxu run `mxu_exact` at 3 trees and whose
    trees must equal that run's first three byte for byte (exact sums are
    integers on every backend). Returns the launch counts."""
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
    equal = model_trees(booster.model_to_string()) == model_trees(
        mxu_exact.model_to_string(num_iteration=BACKEND_TREES))
    emit("train_exact_pallas", trees=BACKEND_TREES, train_s=train_s,
         trees_per_s=BACKEND_TREES / train_s, launches=launches,
         logloss=losses, held_out_auc=got_auc, mxu_held_out_auc=want_auc,
         model_txt_byte_equal_to_mxu=equal)
    check(equal, "exact hist_backend=pallas trees differ from mxu's")
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
    """Every K1, K3/K4 and K7 call partitions its rows through the
    partition kernel: one partition launch per histogram launch, none
    through torch, and some on the path; every K1 call also routes with
    counts (K2's counts mode) first."""
    hist = sum(counts[k] for k in K1_KEYS + K3_KEYS + K7_KEYS)
    check(counts["partition_rows"] == hist > 0, f"the {path} path launched "
          f"{counts['partition_rows']} partitions for {hist} K1, K3/K4 and "
          "K7 calls")
    k1 = sum(counts[k] for k in K1_KEYS)
    k2c = counts["route_rows_counts"] + counts["route_rows_counts_packed"]
    check(k2c >= k1, f"the {path} path launched {k1} K1 calls but only "
          f"{k2c} routings with counts")


def packed_path(torch, lgt, hm, X, y):
    """4-bit packed bins: the binary configuration at max_bin 15 (1M x 28,
    packed into 14 bytes a row), exact and quantized under mxu (10 trees
    each), each held to the same run on unpacked bins (bin_pack_4bit
    false): byte-equal in their trees (the exact run's held-out AUC also
    within 0.005); then quantized under auto and pallas (3 trees each),
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
    # exact sums are integers too: packed and unpacked storage grow the
    # same trees
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
        "exact_unpacked": model_trees(exact_unpacked.model_to_string()) ==
        model_trees(runs["train_packed"].model_to_string()),
        "auto": model_trees(runs["train_packed_quantized_auto"]
                            .model_to_string()) == want3,
        "pallas": model_trees(runs["train_packed_quantized_pallas"]
                              .model_to_string()) == want3}
    emit("packed_check", model_txt_byte_equal_to_packed_mxu=equal,
         exact_held_out_auc=exact_auc,
         exact_unpacked_logloss=unpacked_losses,
         quantized_held_out_auc=held_out_auc(q))
    for what, ok in equal.items():
        check(ok, f"packed model.txt differs from {what}")
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
    return held, monotone_sweep(booster, ds, Xva)


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
    check_partition_launches(counts, "constraints")
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
    round trip, and a second identical run, which must write the same
    bytes (every histogram sums integers, exact ones too). Returns the
    held-out AUC."""
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
    check(byte_equal, f"{phase}: two identical runs wrote different "
          "model.txt")
    return held_out_auc


def cross_device_phase(torch, lgt, grow_tree_mxu):
    """Categorical and NaN features through the whole training path on
    the card (the main path's data has neither), held against the same
    training on the CPU (the kernels' plain versions): the card's model
    must agree with its own device scores; whether its trees equal the
    CPU's is printed, tree by tree, with the kinds of tree line that
    differ (the histograms of equal inputs are the same bits on both; the
    objective's gradients and the f32 reductions run on each device's own
    torch kernels). Then tree 0 is grown again on the card through
    grow_tree_mxu from the CPU run's own gradients, hessians, feature mask
    and key, moved to the card: if that tree equals the CPU's tree 0, the
    two runs part upstream of the grower (the phase prints whether the
    first gradients agree bit for bit, and where not, by how much); if not,
    in the growth glue (it prints which fields differ). It also prints
    which trees' gradients agree and, for the first that does not, whether
    its scores did and whether the card's objective gives the CPU's
    gradients from the CPU's scores (and in how many rows `torch.exp`
    differs). It checks that tree 0 and the regrown tree 0 equal the
    CPU's (the trees after it may part: the card's torch.exp differs in
    the last bits, ROADMAP C3)."""
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
    models, first, seen = {}, {}, {"cuda": [], "cpu": []}
    for device in ("cuda", "cpu"):
        p = dict(params, device_type=device)
        booster = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
        gbdt = booster.gbdt
        grow = gbdt._grow

        def kept_grow(grad, hess, gbdt=gbdt, grow=grow, device=device):
            # every tree's scores (those its gradients came from) and
            # gradients
            seen[device].append(dict(score=gbdt.train_score.clone(),
                                     grad=grad, hess=hess))
            if gbdt.iter_ == 0:
                first[device] = dict(
                    grad=grad, hess=hess, key=gbdt._tree_key(),
                    mask=gbdt._feature_mask_at(0),
                    kw=gbdt._mxu_grow_kwargs())
            tree, row_node = grow(grad, hess)
            if gbdt.iter_ == 0:
                first[device].update(tree=tree, row_node=row_node)
            return tree, row_node
        gbdt._grow = kept_grow
        for _ in range(5):
            booster.update()
        del gbdt._grow
        models[device] = booster
    card = models["cuda"]
    host = card.predict(X, raw_score=True)
    err = float(np.abs(host - card.gbdt.train_score.cpu().numpy()).max())
    text = card.model_to_string()
    trees = model_trees(text)
    cpu_trees = model_trees(models["cpu"].model_to_string())
    # the kinds of tree line (key before "=") that differ
    differ = sorted({a.split("=")[0] for a, b in zip(
        trees.splitlines(), cpu_trees.splitlines()) if a != b})

    # tree 0 again on the card, from the CPU run's inputs
    cpu, cuda = first["cpu"], first["cuda"]
    g_cpu = models["cpu"].gbdt
    dev = torch.device("cuda")

    def to_card(t):
        return None if t is None else t.to(dev)
    again, row_node = grow_tree_mxu(
        *(to_card(t) for t in (g_cpu.bins, cpu["grad"], cpu["hess"],
                               g_cpu._cnt, cpu["mask"], g_cpu.num_bins_d,
                               g_cpu.missing_is_nan_d, g_cpu.is_cat_d)),
        rng_key=to_card(cpu["key"]), **cpu["kw"])
    want = cpu["tree"]
    fields = [fld for fld in want._fields if not torch.equal(
        getattr(again, fld).cpu(), getattr(want, fld))]
    regrow_equal = not fields and torch.equal(row_node.cpu(),
                                              cpu["row_node"])
    grad_diff = {}
    for ch in ("grad", "hess"):
        a, b = cuda[ch].cpu(), cpu[ch]
        grad_diff[ch] = {
            "bit_equal": torch.equal(a.view(torch.int32),
                                     b.view(torch.int32)),
            "rows_differ": int((a != b).sum()),
            "max_abs_diff": float((a - b).abs().max())}

    # the first tree whose gradients differ between the devices: were its
    # scores equal, and does the card's objective give the CPU's gradients
    # from the CPU's scores (where not: how many rows of the exp differ)
    def same(a, b):
        return torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    grads_equal = [same(c["grad"], h["grad"]) and same(c["hess"], h["hess"])
                   for c, h in zip(seen["cuda"], seen["cpu"])]
    upstream = None
    if not all(grads_equal):
        i = grads_equal.index(False)
        score = seen["cpu"][i]["score"]
        g, h = card.gbdt.objective.get_gradients(score.to(dev))
        obj = models["cpu"].gbdt.objective
        arg = obj.y_signed * obj.sigmoid * score
        upstream = {
            "tree": i,
            "scores_equal": same(seen["cuda"][i]["score"], score),
            "card_objective_on_cpu_scores_equal":
                same(g, seen["cpu"][i]["grad"]) and
                same(h, seen["cpu"][i]["hess"]),
            "grad_rows_differ": int((g.cpu() != seen["cpu"][i]["grad"])
                                    .sum()),
            "exp_rows_differ": int((torch.exp(arg.to(dev)).cpu() !=
                                    torch.exp(arg)).sum())}
    emit("cross_device", rows=n, categorical_splits="num_cat=0" not in
         text.split("Tree=0")[1].split("Tree=1")[0],
         host_vs_device_max_abs=err,
         trees_equal_cpu=trees == cpu_trees,
         each_tree_equal_cpu=[a == b for a, b in zip(
             trees.split("Tree=")[1:], cpu_trees.split("Tree=")[1:])],
         lines_that_differ=differ,
         max_pred_diff_vs_cpu=float(np.abs(
             host - models["cpu"].predict(X, raw_score=True)).max()),
         regrown_tree0_equals_cpu=regrow_equal,
         regrown_tree0_fields_that_differ=fields + (
             [] if torch.equal(row_node.cpu(), cpu["row_node"])
             else ["row_node"]),
         regrown_tree0_max_leaf_diff=float(
             (again.leaf_value.cpu() - want.leaf_value).abs().max()),
         first_gradients_card_vs_cpu=grad_diff,
         gradients_equal_per_tree=grads_equal,
         first_parting_gradients=upstream,
         parted="nowhere" if trees == cpu_trees else
         "upstream of the grower" if regrow_equal else "in the growth glue")
    check(err <= 1e-4, f"categorical/NaN model vs device score {err}")
    # tree 0 and everything the grower computes from equal gradients are
    # the same bits on both devices (the root sums and categorical scans)
    check(regrow_equal, "cross_device: tree 0 regrown on the card from the "
          f"CPU run's gradients differs from the CPU's: {fields}")
    check(trees.split("Tree=")[1] == cpu_trees.split("Tree=")[1],
          "cross_device: tree 0 on the card differs from the CPU's")


def _strip_block(text):
    """Model text without its [fused_block_size: ...] echo line."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[fused_block_size:"))


def _sha(text):
    import hashlib
    return hashlib.sha256(_strip_block(text).encode()).hexdigest()


def host_vs_device(booster, X):
    """The host model's raw predictions on the first HOST_ROWS rows
    against the booster's device training scores ([N] or [N, k]): the
    largest absolute difference."""
    raw = booster.predict(X[:HOST_ROWS], raw_score=True)
    dev_ = booster.gbdt.train_score_host()[:HOST_ROWS]
    return float(np.abs(raw - dev_).max())


def class_traj_row(torch, dev, row, booster, Xv):
    """Kernel V's class mode (predict_binned_class) against its plain
    version at the multiclass valid phase's shapes: the booster's trees of
    iterations 1-10 (10 x 5 stacked 255-leaf trees) over the 40,000
    held-out rows' bins, from a random [N, 5] score, bit for bit, and one
    tree into one class's column (class_score_add). Bound: every input
    read once (the bins, the node fields the walk reads, the score) and
    the trajectory written once, or one f32 add a row a tree; library: the
    PyTorch indexing walk, one gather a level to each tree's depth, into
    the class's column (device ms timed as one CUDA graph)."""
    from lightgbm_tpu_torch.learner import predict as pr
    from lightgbm_tpu_torch.learner.grower import TreeArrays
    gb = booster.gbdt
    c, k = MC_CLASSES, VALID_TRAJ_TREES
    trees = gb.trees[c:c * (k + 1)]
    stacked = TreeArrays(*[torch.stack(ts).reshape(
        (k, c) + tuple(ts[0].shape)) for ts in zip(*trees)])
    bins = gb.valid_bins[0]
    n, f = bins.shape
    nb, nan = gb.num_bins_d, gb.missing_is_nan_d
    score0 = torch.as_tensor(np.random.RandomState(43).randn(n, c)
                             .astype(np.float32), device=dev)
    fin, traj = pr.stacked_score_traj(stacked, score0, bins, nb, nan,
                                      num_class=c)
    _, want = pr.stacked_score_traj_ref(stacked, score0, bins, nb, nan,
                                        num_class=c)
    check(same_bits(torch, traj, want), "predict_binned_class differs "
          "from its plain version")
    one = TreeArrays(*[t[3, 2] for t in stacked])
    check(same_bits(torch, pr.class_score_add(one, score0, 2, bins, nb, nan),
                    pr.class_score_add_ref(one, score0, 2, bins, nb, nan)),
          "class_score_add differs from its plain version")
    depth = []
    left = stacked.left.reshape(k * c, -1).cpu().numpy()
    right = stacked.right.reshape(k * c, -1).cpu().numpy()
    for t in range(k * c):
        d_ = np.zeros(left.shape[1], np.int64)
        for j in range(left.shape[1]):       # children after their parent
            for ch in (left[t, j], right[t, j]):
                if ch >= 0:
                    d_[ch] = d_[j] + 1
        depth.append(int(d_.max()))
    sf = stacked.split_feature.reshape(k * c, -1).long()
    thr = stacked.threshold_bin.reshape(k * c, -1)
    dl = stacked.default_left.reshape(k * c, -1)
    lt = stacked.left.reshape(k * c, -1)
    rt = stacked.right.reshape(k * c, -1)
    lv = stacked.leaf_value.reshape(k * c, -1)
    rows_ = torch.arange(n, device=dev)
    nbins = nb.long()

    def library():
        s_ = score0
        for t in range(k * c):
            node = torch.zeros(n, dtype=torch.int64, device=dev)
            for _ in range(depth[t]):
                feat = sf[t][node]
                fc = feat.clamp(min=0)
                b = bins[rows_, fc].long()
                go = torch.where(nan[fc] & (b == nbins[fc] - 1),
                                 dl[t][node], b <= thr[t][node])
                nxt = torch.where(go, lt[t][node], rt[t][node]).long()
                node = torch.where(feat >= 0, nxt, node)
            if t % c == 0:
                s_ = s_.clone()
            s_[:, t % c] += lv[t][node]
        return s_
    check(same_bits(torch, library(), fin), "the indexing walk differs "
          "from predict_binned_class")
    nodes = int(sum(int(t.num_nodes) for t in trees))
    nbytes = n * f + 22 * nodes + 4 * n * c + 4 * k * n * c
    row("predict_binned_class", "lightgbm_tpu/boosting/fused.py:53 "
        "(stacked_score_traj num_class; lightgbm_tpu/learner/predict.py:25 "
        "_traverse; XLA, no Pallas)", 0.0,
        lambda: pr.stacked_score_traj(stacked, score0, bins, nb, nan,
                                      num_class=c),
        lambda: pr.stacked_score_traj_ref(stacked, score0, bins, nb, nan,
                                          num_class=c),
        3, nbytes, k * c * n, library, source="predict_binned",
        library_graph=True)
    emit("kernel_check", name="predict_binned_class", rows=n, classes=c,
         iterations=k, equal=True, class_score_add_equal=True,
         tree_depths=depth)


def multiclass_path(torch, lgt, hm, dev, row):
    """5-class multiclass (helpers/bench_tasks.py's task at 1M x 28, 255
    leaves, 255 bins, learning rate 0.1), k = 5 trees an iteration:
    (a) exact and quantized through fused_turns (train at
    fused_block_size 10, 50 trees a dispatch, then update_batch(10) twice,
    against update() in turns: sha256-equal model text, every program
    captured once for all classes, launches, the graph pool given back;
    trees/s, host syncs a tree, pool bytes and capture s), each turn's
    host predictions within 1e-4 of its device scores in every class on
    the first 100,000 rows; (b) a held-out set (40,000 rows, seed 99)
    with multi_logloss and multi_error, 20 rounds at fused_block_size 10
    against 1: the recorded metrics equal, the model and valid scores
    equal, the host model's held-out predictions within 1e-4 of the
    device valid scores, the held-out multi_logloss below the class
    prior's (iteration 0's, printed); permuted held-out labels with
    early_stopping_round 2: best iteration, best score and trees equal;
    (c) multiclassova for 5 iterations through train, against update().
    Returns the launch counts; then holds kernel V's class mode to its
    plain version on the valid run's trees (class_traj_row)."""
    X, y = make_multiclass(N_ROWS, seed=21)
    Xv, yv = make_multiclass(VALID_ROWS, seed=99)
    ds = lgt.Dataset(X, label=y, params=MC_PARAMS)
    ds.construct()
    yd = torch.as_tensor(y, device=dev).long()

    def logloss(score):      # class-major [k, N]
        return -torch.log_softmax(score.double(), 0).gather(
            0, yd[None])[0].mean()

    def inspect(booster):
        diff = host_vs_device(booster, X)
        check(diff <= 1e-4, f"multiclass host predict {diff} off the "
              "device scores")
        return {"host_vs_device_max_abs": diff}

    hm.reset_launch_counts()
    rates = {}
    for name, params in (("multiclass", MC_PARAMS),
                         ("multiclass_quantized", MC_QUANT_PARAMS)):
        rates[name] = fused_turns(torch, lgt, hm, ds, logloss, name, params,
                                  inspect=inspect, classes=MC_CLASSES)

    def run(block, label, **extra):
        params = dict(MC_PARAMS, metric="multi_logloss,multi_error",
                      fused_block_size=block, **extra)
        ev = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lgt.train(params, ds, MC_VALID_ROUNDS,
                      valid_sets=[ds.create_valid(Xv, label=label)],
                      callbacks=[lgt.record_evaluation(ev)])
        torch.cuda.synchronize()
        return b, ev, time.perf_counter() - t0

    (b10, ev10, s10), (b1, ev1, s1) = run(10, yv), run(1, yv)
    check(ev10 == ev1, "multiclass: the block's recorded metrics differ "
          "from fused_block_size 1's")
    check(_sha(b10.model_to_string()) == _sha(b1.model_to_string()),
          "multiclass valid: model text differs between block sizes")
    check(same_bits(torch, b10.gbdt.valid_scores[0], b1.gbdt.valid_scores[0]),
          "multiclass valid scores differ between block sizes")
    host = b10.predict(Xv, raw_score=True)
    vdiff = float(np.abs(host - b10.gbdt.valid_scores[0].cpu().numpy())
                  .max())
    check(vdiff <= 1e-4, f"multiclass held-out host predict {vdiff} off "
          "the device valid scores")
    obj = b10.gbdt.objective
    prior = np.array([obj.boost_from_score(c) for c in range(MC_CLASSES)])
    p0 = np.exp(prior - prior.max())
    p0 /= p0.sum()
    prior_loss = float(-np.log(p0[yv.astype(int)]).mean())
    losses = ev10["valid_0"]["multi_logloss"]
    check(losses[-1] < prior_loss, f"held-out multi_logloss {losses[-1]} "
          f"not below the class prior's {prior_loss}")
    yp = yv[np.random.RandomState(7).permutation(VALID_ROWS)]
    (e10, _, _), (e1, _, _) = run(10, yp, early_stopping_round=2), \
        run(1, yp, early_stopping_round=2)
    check(e10.best_iteration == e1.best_iteration and
          e10.best_score == e1.best_score and
          e10.num_trees() == e1.num_trees(),
          f"multiclass early stop: block 10 best {e10.best_iteration}, "
          f"block 1 best {e1.best_iteration}")
    ova = dict(MC_PARAMS, objective="multiclassova")
    b_ova = lgt.train(ova, ds, OVA_TREES)
    b_upd = lgt.Booster(ova, ds)
    for _ in range(OVA_TREES):
        b_upd.update()
    check(_sha(b_ova.model_to_string()) == _sha(b_upd.model_to_string()),
          "multiclassova: train differs from update()")
    ova_diff = host_vs_device(b_ova, X)
    check(ova_diff <= 1e-4, f"multiclassova host predict {ova_diff} off")
    counts = hm.launch_counts()
    for key in MULTICLASS_PATH:
        check(counts[key] > 0, f"{key} was not launched on the multiclass "
              "path")
    emit("multiclass_valid", rows=N_ROWS, valid_rows=VALID_ROWS,
         classes=MC_CLASSES, rounds=MC_VALID_ROUNDS,
         trajectory_equal=True, model_equal=True,
         host_vs_device_valid_max_abs=vdiff,
         multi_logloss_prior=prior_loss, multi_logloss=losses,
         multi_error=ev10["valid_0"]["multi_error"],
         train_s_block10=s10, train_s_block1=s1,
         trees_per_s_block10=MC_VALID_ROUNDS * MC_CLASSES / s10,
         trees_per_s_block1=MC_VALID_ROUNDS * MC_CLASSES / s1,
         early_stop_best_iteration=e10.best_iteration,
         ova_trees=b_ova.num_trees(), ova_host_vs_device_max_abs=ova_diff,
         ova_byte_equal=True, replay_trees_per_s=rates,
         predict_binned_class_launches=counts["predict_binned_class"])
    class_traj_row(torch, dev, row, b10, Xv)
    return counts


def ranking_path(torch, lgt, hm, dev):
    """lambdarank over 50,000 queries of 20 documents (helpers/
    bench_tasks.py's task at 1M x 28, 255 leaves) and rank_xendcg, each
    through train at fused_block_size 10 (iteration 0, then 9 through the
    fused trainer, the pairwise gradients inside its prologue graph) with
    a held-out set of 2,000 queries (40,000 rows, seed 99) on ndcg@10 and
    map@10, against 10 update() calls: model text sha256-equal, the
    held-out ndcg@10 above that of a zero score (iteration 0's), host
    predictions within 1e-4 of the device scores; prints the gradient
    program's device ms an iteration (as one CUDA graph). Returns the
    launch counts."""
    X, y, group = make_lambdarank(N_ROWS, seed=21)
    Xv, yv, gv = make_lambdarank(VALID_ROWS, seed=99)
    ds = lgt.Dataset(X, label=y, group=group, params=TRAIN_PARAMS)
    ds.construct()
    hm.reset_launch_counts()
    out = {}
    for name in ("lambdarank", "rank_xendcg"):
        params = dict(TRAIN_PARAMS, objective=name, metric="ndcg,map",
                      eval_at=[10])
        ev = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = lgt.train(params, ds, RANK_TREES,
                          valid_sets=[ds.create_valid(Xv, label=yv,
                                                      group=gv)],
                          callbacks=[lgt.record_evaluation(ev)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per = lgt.Booster(params, ds)
        for _ in range(RANK_TREES):
            per.update()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(_sha(fused.model_to_string()) == _sha(per.model_to_string()),
              f"{name}: train's fused path differs from update()")
        stats = fused.gbdt.fused_stats
        check(len(stats) == 1 and stats[0]["trees"] == RANK_TREES - 1 and
              stats[0]["graphs"] == stats[0]["programs"],
              f"{name}: fused trainer stats {stats}")
        from lightgbm_tpu_torch import metrics as mt
        m0 = mt.create_metric("ndcg", lgt.Config(params))
        m0.init(fused._valid_data[0].binned.metadata, VALID_ROWS)
        ndcg0 = m0.evaluate_multi(np.zeros(VALID_ROWS, np.float32))[
            "ndcg@10"]
        ndcg = ev["valid_0"]["ndcg@10"]
        check(ndcg[-1] > ndcg0, f"{name}: held-out ndcg@10 {ndcg[-1]} not "
              f"above iteration 0's {ndcg0}")
        diff = host_vs_device(fused, X)
        check(diff <= 1e-4, f"{name}: host predict {diff} off the device")
        gb = per.gbdt
        # one graph of the program, as the fused prologue replays it
        grad_ms = graph_device_ms(torch,
                                  lambda: gb._gradients(gb.train_score))
        out[name] = dict(train_s=t1 - t0, update_s=t2 - t1,
                         trees_per_s_train=RANK_TREES / (t1 - t0),
                         trees_per_s_update=RANK_TREES / (t2 - t1),
                         ndcg_at_10_iteration0=ndcg0, ndcg_at_10=ndcg,
                         map_at_10=ev["valid_0"]["map@10"],
                         host_vs_device_max_abs=diff,
                         gradient_device_ms=grad_ms,
                         query_batch=gb.objective.query_batch,
                         graph_pool_bytes=stats[0]["graph_pool_bytes"],
                         capture_s=stats[0]["capture_s"],
                         byte_equal=True)
        del fused, per, gb
    counts = hm.launch_counts()
    for key in RANKING_PATH:
        check(counts[key] > 0, f"{key} was not launched on the ranking "
              "path")
    emit("ranking", rows=N_ROWS, queries=N_ROWS // RANK_QSIZE,
         valid_queries=VALID_ROWS // RANK_QSIZE, trees=RANK_TREES, **out)
    return counts


def objectives_path(torch, lgt, hm):
    """The other objectives on the regression task's data (1M x 28, 255
    leaves): regression_l1, huber, fair, quantile and mape on its label,
    per iteration with leaf renewal (5 iterations through train, which
    runs them one a dispatch); poisson, gamma and tweedie on the positive
    label exp(0.5 z), cross_entropy and cross_entropy_lambda on the label
    1 / (1 + exp(-z)) in (0, 1), z the label standardized, through train's
    fused path at fused_block_size 5, against 5 update() calls (model text
    sha256-equal). Each: host predictions within 1e-4 of the device
    scores, the training metric after the 5 iterations below its value at
    the boost-from-average score (iteration 0's). Returns the launch
    counts."""
    X, yreg = make_regression(N_ROWS, seed=21)
    z = (yreg - yreg.mean()) / yreg.std()
    labels = {"regression": yreg,
              "positive": np.exp(0.5 * z).astype(np.float32),
              "unit": (1.0 / (1.0 + np.exp(-z))).astype(np.float32)}
    datasets = {}
    for key, lab in labels.items():
        datasets[key] = lgt.Dataset(X, label=lab, params=TRAIN_PARAMS)
        datasets[key].construct()
    hm.reset_launch_counts()
    out = {}
    for name in RENEW_OBJECTIVES + FUSED_OBJECTIVES:
        key = "regression" if name in RENEW_OBJECTIVES else \
            "positive" if name in ("poisson", "gamma", "tweedie") else "unit"
        ds = datasets[key]
        params = dict(TRAIN_PARAMS, objective=name, metric=name,
                      fused_block_size=OBJ_TREES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lgt.train(params, ds, OBJ_TREES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fused = bool(b.gbdt.fused_stats)
        check(fused == (name in FUSED_OBJECTIVES), f"{name}: fused path "
              f"{fused}")
        if fused:
            per = lgt.Booster(params, ds)
            for _ in range(OBJ_TREES):
                per.update()
            check(_sha(b.model_to_string()) == _sha(per.model_to_string()),
                  f"{name}: train's fused path differs from update()")
            del per
        gb = b.gbdt
        m = gb.train_metrics[0]
        init = gb.objective.boost_from_score(0)
        loss0 = m.evaluate(np.full(N_ROWS, init, np.float32),
                           gb.objective.convert_output)
        loss = b.eval_train()[0][2]
        check(loss < loss0, f"{name}: training {m.name} {loss} not below "
              f"iteration 0's {loss0}")
        diff = host_vs_device(b, X)
        check(diff <= 1e-4, f"{name}: host predict {diff} off the device")
        out[name] = dict(label=key, fused=fused, train_s=seconds,
                         trees_per_s=OBJ_TREES / seconds, metric=m.name,
                         metric_iteration0=loss0, metric_last=loss,
                         host_vs_device_max_abs=diff,
                         leaves=[int(t.num_leaves) for t in gb.trees])
        del b, gb
    counts = hm.launch_counts()
    for key in OBJECTIVES_PATH:
        check(counts[key] > 0, f"{key} was not launched on the objectives "
              "path")
    emit("objectives", rows=N_ROWS, trees=OBJ_TREES, **out)
    return counts


# ---------------------------------------------------------------------------
# EFB and sparse input (phase `efb`): the JAX package's own EFB shape
# (helpers/bench_efb.py make_sparse, copied below), 200,000 rows x 1,000
# features in exclusive groups of 20 (~95% sparse), binary, 63 leaves,
# 63 bins; its plan bundles them into about 250 columns of up to 256 bins
EFB_ROWS = 200_000
EFB_FEATURES = 1000
EFB_GROUP = 20
EFB_VALID_ROWS = 50_000
EFB_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
# two blocks: the smoke stays near half its time limit
EFB_TREES = 20
EFB_BLOCK = 10
# bundled data takes the MXU grower and the fused trainer only under
# efb_use_mxu=true (the JAX package's _mxu_exclusions); the turns run it
EFB_MXU = {"efb_use_mxu": True}
EFB_TURNS = (("efb_exact", EFB_MXU),
             ("efb_exact_expansion", dict(EFB_MXU, efb_segmented_scan=False)),
             ("efb_quantized", dict(EFB_MXU, use_quantized_grad=True)),
             ("efb_quantized_expansion", dict(EFB_MXU, use_quantized_grad=True,
                                              efb_segmented_scan=False)))
# the default (the portable grower, one iteration a dispatch): trees timed
# after one warm-up tree
EFB_DEFAULT_TREES = 4
EFB_DART = dict(EFB_PARAMS, boosting="dart", drop_rate=0.5, skip_drop=0.0)
EFB_DART_TREES = 3
# K1's widest kernel width in both modes (the grower's fit at row block
# 1024: the loc-table mode's route side is as wide as the 1,000 features)
S_EFB = 24
M_EFB = 256           # route-table rows at 63 leaves, overshoot 2
EFB_KERNELS = {
    "route_rows_efbr": "lightgbm_tpu/learner/histogram_mxu.py:1065 "
                       "(route_rows_mxu, efb_range)",
    "route_rows_efb": "lightgbm_tpu/learner/histogram_mxu.py:1065 "
                      "(route_rows_mxu, loc_table)",
    "fused_route_hist_efbr": "lightgbm_tpu/learner/histogram_mxu.py:785 "
                             "(fused_route_hist_mxu, efb_range)",
    "fused_route_hist_efb": "lightgbm_tpu/learner/histogram_mxu.py:785 "
                            "(fused_route_hist_mxu, loc_table)",
    "predict_binned_efb": "lightgbm_tpu/learner/predict.py:25 (_traverse"
                          "(efb=), predict_binned_tree; XLA, no Pallas)"}
ROW_PATH.update(dict.fromkeys(EFB_KERNELS, "efb"))
EFB_PATH = tuple(EFB_KERNELS) + ("fused_route_hist_efbr_int",
                                 "fused_route_hist_efb_int",
                                 "route_rows_efbr_counts",
                                 "route_rows_efb_counts")


def make_sparse(n, seed, f=EFB_FEATURES, group=EFB_GROUP, card=0):
    """The JAX package's helpers/bench_efb.py make_sparse (the same draws,
    the same values), built as a scipy CSR matrix: in each group of
    `group` features one nonzero a row, rand + 0.5 (card=0) or one of
    `card` values; the label from feature 0 and feature 500."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    cols, vals = [], []
    logit = np.zeros(n, np.float32)
    for g in range(0, f, group):
        which = rng.randint(g, g + group, size=n)
        if card:
            v = (rng.randint(1, card + 1, size=n) /
                 np.float32(card) + 0.5).astype(np.float32)
        else:
            v = rng.rand(n).astype(np.float32) + 0.5
        cols.append(which)
        vals.append(v)
        if g == 0:
            logit += np.where(which == 0, v * 2.0, 0.0)
    g500 = 500 // group
    x500 = np.where(cols[g500] == 500, vals[g500], np.float32(0.0))
    logit += 0.5 * x500 + 0.3 * rng.randn(n).astype(np.float32)
    y = (logit > np.median(logit)).astype(np.float32)
    k = len(cols)
    csr = sp.csr_matrix((np.stack(vals, 1).ravel(),
                         np.stack(cols, 1).ravel(),
                         np.arange(0, n * k + 1, k)), shape=(n, f))
    return csr, y


def efb_tables(torch, hm, gbdt, seed):
    """A random pass's node tables over the booster's original features
    (bundled, identity and every threshold of each), packed with the
    plan's EFB columns, and rows spread over the nodes."""
    rng = np.random.RandomState(seed)
    dev = gbdt.bins.device
    nb = gbdt.num_bins_d.cpu().numpy()
    f = nb.shape[0]
    m1 = M_EFB - 2
    split = rng.rand(m1) < 0.7
    feat = rng.randint(0, f, m1).astype(np.int32)
    thr = (rng.rand(m1) * np.maximum(nb[feat] - 1, 1)).astype(np.int32)
    words = (gbdt.bmax + 31) // 32

    def t(a):
        return torch.as_tensor(a, device=dev)
    efb = gbdt._efb
    tbl, member = hm.pack_route_tables(
        t(split), t(feat), t(thr), t(rng.rand(m1) < 0.5),
        t(np.zeros(m1, bool)), t(rng.randint(0, m1, m1).astype(np.int32)),
        t(rng.randint(0, m1, m1).astype(np.int32)),
        t(rng.randint(-1, S_EFB + 4, m1).astype(np.int32)),
        torch.zeros((m1, words), dtype=torch.int64, device=dev), M_EFB,
        bcol=efb.col_of_feat[t(feat).long()], efb=efb)
    feat_tbl = torch.stack([gbdt.num_bins_d,
                            gbdt.missing_is_nan_d.to(torch.int32)],
                           1).contiguous()
    row_node = t(rng.randint(0, m1, gbdt.num_data).astype(np.int32))
    return (tbl, member, feat_tbl), row_node, t(split)


def efb_rows(torch, hm, row, boosters):
    """K2 and K1 in both EFB modes at the phase's shapes, on the bundled
    training matrix and random node tables (efb_tables), bit for bit
    against their plain versions and across two calls; K1 also in its
    integer mode. Bound: as the unbundled rows' (route: 12 bytes a row,
    a bin a routed row, the node tables, and in loc mode 4 bytes for each
    distinct (split feature, bundle bin) pair a routed row decodes
    through the [F, Bb] loc table; K1: its routing, then the bundle
    columns and channels of every slotted row and the histogram out)."""
    for mode, gbdt in boosters.items():
        suffix = "_efbr" if mode == "range" else "_efb"
        kw = {"efb_range": True} if mode == "range" else \
            {"loc_table": gbdt._efb.loc_table}
        bins = gbdt.bins
        n, fb = bins.shape
        bb = gbdt._efb.bundle_bmax
        route, row_node, split = efb_tables(torch, hm, gbdt, 23)
        routed = split[row_node.long()]
        n_routed = int(routed.sum())
        table_bytes = sum(x.numel() * 4 for x in route)
        if mode == "loc":
            feat = route[0][row_node.long(), hm.TBL_FEAT].long()[routed]
            pos = bins[routed, gbdt._efb.col_of_feat.long()[feat]].long()
            table_bytes += 4 * int(torch.unique(feat * bb + pos).numel())
        rn, rs = hm.route_rows(bins, row_node, *route, **kw)
        rn_ref, rs_ref = hm.route_rows_ref(bins, row_node, *route, **kw)
        check(torch.equal(rn, rn_ref) and torch.equal(rs, rs_ref),
              f"route_rows{suffix} differs from its plain version")
        row("route_rows" + suffix, EFB_KERNELS["route_rows" + suffix], 0.0,
            lambda: hm.route_rows(bins, row_node, *route, **kw),
            lambda: hm.route_rows_ref(bins, row_node, *route, **kw), 5,
            12 * n + n_routed + table_bytes, 0, None, source="route_rows")
        rng = np.random.RandomState(5)
        grad = torch.as_tensor(rng.randn(n).astype(np.float32),
                               device=bins.device)
        hess = torch.as_tensor(rng.uniform(0.1, 1.0, n).astype(np.float32),
                               device=bins.device)
        cnt = torch.ones(n, device=bins.device)
        scale = hm.exact_scale(grad, hess, cnt)

        def k1(g=grad, h=hess, quantized=False):
            return hm.fused_route_hist(
                bins, g, h, cnt, row_node, *route, num_slots=S_EFB,
                bmax=bb, quantized=quantized,
                scale=None if quantized else scale, **kw)

        def k1_ref(g=grad, h=hess, quantized=False):
            return hm.fused_route_hist_ref(
                bins, g, h, cnt, row_node, *route, num_slots=S_EFB,
                bmax=bb, quantized=quantized,
                scale=None if quantized else scale, **kw)
        h_ref, rn_ref = k1_ref()
        check(torch.equal(k1()[1], rn_ref),
              f"fused_route_hist{suffix} routing differs")
        err = check_hist(torch, "fused_route_hist" + suffix, k1, h_ref)
        g_q = torch.round(grad * 40).clamp(-127, 127).to(torch.int8)
        h_q = torch.round(hess * 100).to(torch.int8)
        hq, rq = k1(g_q, h_q, True)
        hq_ref, rq_ref = k1_ref(g_q, h_q, True)
        check(torch.equal(rq, rq_ref) and torch.equal(hq, hq_ref),
              f"fused_route_hist{suffix} integer mode differs from its "
              "plain version")
        n_slot = int(((rs_ref >= 0) & (rs_ref < S_EFB)).sum())
        row("fused_route_hist" + suffix,
            EFB_KERNELS["fused_route_hist" + suffix], err, k1, k1_ref, 3,
            8 * n + n_routed + n_slot * (fb + 12) + h_ref.numel() * 4 +
            table_bytes, n_slot * fb * 3, None,
            source="build_histograms_scatter")
        del h_ref, hq, hq_ref


def efb_traversal_row(torch, row, gbdt, tree):
    """Kernel V's bundled mode at one tree of the DART run over the
    200,000 bundled training rows against its plain version, bit for
    bit. Bound: each row's bundle bytes on its path once (distinct
    columns), the tree's nodes (22 bytes each), the [N] output and 4
    bytes for each distinct (split feature, bundle bin) pair a node visit
    decodes through the loc table; or its node visits at the f32 rate. Library: the PyTorch
    indexing walk with the loc table's decode, to the tree's depth (its
    device ms timed as one CUDA graph)."""
    from lightgbm_tpu_torch.learner import predict as pr
    bins, efb = gbdt.bins, gbdt._efb
    num_bins, nan = gbdt.num_bins_d, gbdt.missing_is_nan_d
    n = bins.shape[0]
    got = pr.predict_binned_tree(tree, bins, num_bins, nan, efb=efb)
    want = pr.predict_binned_tree_ref(tree, bins, num_bins, nan, efb=efb)
    check(same_bits(torch, got, want), "predict_binned's bundled mode "
          "differs from its plain version")
    rows_ = torch.arange(n, device=bins.device)
    sf = tree.split_feature.long()
    col = efb.col_of_feat.long()
    left, right = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    parent = np.full(left.shape[0], -1, np.int64)
    inner = np.nonzero(left >= 0)[0]
    parent[left[inner]] = inner
    parent[right[inner]] = inner
    parent = torch.as_tensor(parent, device=bins.device)
    cur = pr._traverse_ref(tree, bins, num_bins, nan, efb).long()
    seen = torch.zeros(bins.shape, dtype=torch.bool, device=bins.device)
    bb = efb.bundle_bmax
    decoded = torch.zeros(efb.loc_table.numel(), dtype=torch.bool,
                          device=bins.device)
    visits, depth = 0, 0
    while True:
        up = parent[cur]
        active = up >= 0
        m = int(active.sum())
        if m == 0:
            break
        up = up.clamp(min=0)
        visits += m
        feat = sf[up].clamp(min=0)
        seen[rows_[active], col[feat][active]] = True
        decoded[(feat * bb + bins[rows_, col[feat]].long())[active]] = True
        cur = torch.where(active, up, cur)
        depth += 1
    nbytes = int(seen.sum()) + 22 * int(tree.num_nodes) + 4 * n + \
        4 * int(decoded.sum())
    loc = efb.loc_table.reshape(-1).long()

    def library():
        nd = torch.zeros(n, dtype=torch.int64, device=bins.device)
        for _ in range(depth):
            feat = sf[nd].clamp(min=0)
            b = loc[feat * bb + bins[rows_, col[feat]].long()]
            go = torch.where(nan[feat] & (b == num_bins[feat] - 1),
                             tree.default_left[nd],
                             b <= tree.threshold_bin[nd])
            nxt = torch.where(go, tree.left[nd], tree.right[nd]).long()
            nd = torch.where(sf[nd] >= 0, nxt, nd)
        return tree.leaf_value[nd]
    row("predict_binned_efb", EFB_KERNELS["predict_binned_efb"], 0.0,
        lambda: pr.predict_binned_tree(tree, bins, num_bins, nan, efb=efb),
        lambda: pr.predict_binned_tree_ref(tree, bins, num_bins, nan,
                                           efb=efb), 3,
        nbytes, visits, library, source="predict_binned",
        library_graph=True)


def efb_turn(torch, lgt, ds, name, params):
    """One EFB configuration: engine.train at fused_block_size 10 for
    EFB_TREES trees, twice, against EFB_TREES update() calls: the model
    text byte-equal.
    Returns (train s, the first train's booster, its fused stats and
    stall polls, update() s)."""
    p = dict(EFB_PARAMS, fused_block_size=EFB_BLOCK, **params)
    shas, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = lgt.train(p, ds, EFB_TREES)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        shas.append(_sha(booster.model_to_string()))
        if len(shas) == 1:
            first = booster
    check(first.gbdt._efb is not None and first.gbdt.fused_stats,
          f"{name}: the booster did not bundle or the fused trainer did "
          "not run")
    stepped = lgt.Booster(p, ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EFB_TREES):
        stepped.update()
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    check(shas[0] == shas[1] == _sha(stepped.model_to_string()),
          f"{name}: train's model text differs across runs or from "
          "update()'s")
    g = first.gbdt
    st = g.fused_stats
    trees = sum(s_["trees"] for s_ in st)
    reads = sum(sum(s_["fixup_reads"]) for s_ in st)
    emit(name, params=params, trees=EFB_TREES,
         fused_block_size=EFB_BLOCK, byte_equal=True,
         model_sha256=shas[0][:16], train_s=secs, update_s=update_s,
         update_trees_per_s=EFB_TREES / update_s,
         host_syncs_per_tree=(reads + g.stall_polls) / trees,
         graph_pool_bytes=[s_["graph_pool_bytes"] for s_ in st],
         capture_s=[s_["capture_s"] for s_ in st],
         leaves=[int(t.num_leaves) for t in g.trees])
    return first


def replay_rate(torch, lgt, ds, params):
    """replayed_rate of EFB_PARAMS with `params` on top."""
    return replayed_rate(torch, lgt, ds, dict(EFB_PARAMS, **params))


def efb_default_rate(torch, lgt, ds):
    """(trees/s, booster) of the default bundled path, EFB_PARAMS as
    given: the portable grower (_hist_impl "scatter"), one iteration a
    dispatch, never the fused trainer; one warm-up update(), then
    EFB_DEFAULT_TREES update() calls timed."""
    booster = lgt.Booster(EFB_PARAMS, ds)
    g = booster.gbdt
    check(g._efb is not None and g._hist_impl == "scatter" and
          g._mxu_exclusions() == ["efb config"],
          "efb: the default bundled booster is not on the portable grower")
    booster.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EFB_DEFAULT_TREES):
        booster.update()
    torch.cuda.synchronize()
    rate = EFB_DEFAULT_TREES / (time.perf_counter() - t0)
    check(not g.fused_stats, "efb: the default bundled path ran fused")
    return rate, booster


def efb_path(torch, lgt, hm, row):
    """Phase `efb`: the CSR matrix binned against the dense one (bin
    matrix byte-equal, seconds of each); the launch counts reset, then the
    four turns (efb_turn: exact and quantized, segmented scan and
    expansion) and DART with EFB (3 iterations, kernel V's bundled mode
    re-predicting dropped trees), the counts read; every EFB kernel
    launched; host predictions from the CSR input within 1e-4 of the
    device scores and equal to the dense array's; then kernel rows for K2
    and K1 in both modes and V's bundled mode; then, in one call, the
    default bundled path's update() trees/s (the portable grower: bundled
    data takes the MXU grower only under efb_use_mxu, the four turns'
    setting), and replayed trees/s and held-out AUC of efb_use_mxu=true
    against enable_bundle=false on the same data. DART runs the default
    (portable) grower. Returns the launch counts."""
    csr, y = make_sparse(EFB_ROWS, seed=11)
    csr_v, y_v = make_sparse(EFB_VALID_ROWS, seed=99)
    bin_params = {"max_bin": EFB_PARAMS["max_bin"], "verbosity": -1}
    t0 = time.perf_counter()
    ds = lgt.Dataset(csr, label=y, params=bin_params).construct()
    csr_s = time.perf_counter() - t0
    dense = csr.toarray()
    t0 = time.perf_counter()
    ds_dense = lgt.Dataset(dense, label=y, params=bin_params).construct()
    dense_s = time.perf_counter() - t0
    check(np.array_equal(ds.binned.bins, ds_dense.binned.bins),
          "efb: the CSR Dataset's bins differ from the dense one's")
    del ds_dense

    hm.reset_launch_counts()
    t_path = time.perf_counter()
    turns = {name: efb_turn(torch, lgt, ds, name, params)
             for name, params in EFB_TURNS}
    dart = lgt.Booster(EFB_DART, ds)
    for _ in range(EFB_DART_TREES):
        dart.update()
    path_s = time.perf_counter() - t_path
    counts = hm.launch_counts()
    for key in EFB_PATH:
        check(counts[key] > 0, f"{key} was not launched on the efb path")
    booster = turns["efb_exact"]
    g = booster.gbdt
    score = g.train_score_host()
    host_csr = booster.predict(csr, raw_score=True)
    host_dense = booster.predict(dense, raw_score=True)
    host_err = float(np.abs(host_csr - score).max())
    check(host_err <= 1e-4, f"efb: host predictions from CSR are "
          f"{host_err} off the device scores")
    check(np.array_equal(host_csr, host_dense),
          "efb: CSR and dense predictions differ")
    del dense, host_dense

    range_g = g
    loc_g = turns["efb_exact_expansion"].gbdt
    efb_rows(torch, hm, row, {"range": range_g, "loc": loc_g})
    efb_traversal_row(torch, row, dart.gbdt, dart.gbdt.trees[-1])

    # three runs in one call: the default (portable grower), the fused
    # bundled path (efb_use_mxu) and enable_bundle=false
    rate_d, bst_d = efb_default_rate(torch, lgt, ds)
    rate_b, bst_b = replay_rate(torch, lgt, ds, EFB_MXU)
    rate_u, bst_u = replay_rate(torch, lgt, ds, {"enable_bundle": False})
    check(bst_u.gbdt._efb is None, "efb: enable_bundle=false bundled")
    auc_b = auc(bst_b.predict(csr_v, raw_score=True), y_v)
    auc_u = auc(bst_u.predict(csr_v, raw_score=True), y_v)
    auc_d = auc(bst_d.predict(csr_v, raw_score=True), y_v)
    # the label lives on 2 of 1,000 features, each active in 1 row of 20:
    # a weak target, the same for all three (the default after 5 trees)
    check(min(auc_b, auc_u, auc_d) > 0.5 and abs(auc_b - auc_u) <= 0.005,
          f"efb: held-out AUC bundled {auc_b}, unbundled {auc_u}, "
          f"default {auc_d}")
    efb = g._efb
    emit("efb", rows=EFB_ROWS, features=EFB_FEATURES,
         nnz=int(csr.nnz), Fb=efb.num_cols, Bb=efb.bundle_bmax,
         bundled_bin_bytes=int(g.bins.numel()),
         csr_binning_s=csr_s, dense_binning_s=dense_s, path_s=path_s,
         default_update_trees_per_s=rate_d,
         replayed_trees_per_s_bundled=rate_b,
         replayed_trees_per_s_unbundled=rate_u,
         held_out_auc_bundled=auc_b, held_out_auc_unbundled=auc_u,
         held_out_auc_default_5_trees=auc_d,
         host_vs_device_max_abs=host_err,
         launches={k: counts[k] for k in EFB_PATH})
    return counts


# ---------------------------------------------------------------------------
# gpu_use_dp=false, max_bin > 256 and the rescanning monotone methods: the
# single-precision mode of K1, K3 and K7 on the MXU grower, and the
# portable grower (learner/grower.py) with K7 over uint16 bins and kernel
# V's wide mode
# ---------------------------------------------------------------------------

# gpu_use_dp=false on the main configuration: the fused path's turns; the
# pallas backend (K7) and the wide data (K3: 200 features x 256 bins at 4
# channels leave the fused kernel's fit from ~100 slots up) checked with
# a few trees each
SP_PARAMS = dict(TRAIN_PARAMS, gpu_use_dp=False)
SP_CHECK_TREES = 3
SP_PATH = ("fused_route_hist_sp", "build_histograms_sp",
           "build_histograms_scatter_sp", "route_rows_counts",
           "partition_rows")
# max_bin 1023 on the portable grower: uint16 bins, K7's wide mode with
# the scatter kernel (use_pallas true) or the segment sums (false), a
# 40,000-row valid set through kernel V's wide mode
WIDE_BIN_PARAMS = dict(TRAIN_PARAMS, max_bin=1023, metric="auc")
WIDE_BIN_TREES = 10
S_PORTABLE = TRAIN_PARAMS["num_leaves"] + 1   # the portable grower's slots
WIDE_BIN_PATH = ("build_histograms_scatter_wide", "partition_rows",
                 "predict_binned_wide")
# the rescanning monotone methods on the portable grower, leaf-wise: 254
# passes a tree, each rescanning every node from a [510, 28, 256, 3]
# histogram cache; tree 0 against the CPU's at the cross_device shape's
# scale (100,000 rows, 63 leaves)
MONO_METHOD_PARAMS = dict(
    TRAIN_PARAMS, monotone_constraints=[1, -1] + [0] * (N_FEATURES - 2))
MONO_METHOD_TREES = 2
MONO_CPU_ROWS, MONO_CPU_LEAVES = 100_000, 63
MONO_METHOD_PATH = ("build_histograms_scatter", "partition_rows")
# the MXU grower's kernels: the portable paths launch none of them
MXU_ONLY = ("fused_route_hist", "route_rows", "route_rows_counts",
            "build_histograms", "node_values", "prune_best_first")


def single_prec_rows(torch, hm, hp, rng_mod, dev, row):
    """K1, K3 and K7 in the single-precision mode (double_prec=False: each
    hessian rounded to bf16 before its fixed point) at the main path's
    shapes (1M x 28, 256 bins; K1 at the bridge pass's 263 slots, K3 at
    the fix-up passes' 511, K7 at 263 slots with route tallies), bit for
    bit against their plain versions and across two calls; the mode is
    live: the hessian cells differ from the full-precision mode's, the
    gradient and count cells do not. Bounds as the f32 rows'. Then K1 and
    K4 (build_histograms_auto, v2's fit) on the max_bin 15 path's 4-bit
    packed bins in that mode, checked bit for bit (the gpu_use_dp=false
    path on packed bins; no row)."""
    d = kernel_inputs(torch, hm, rng_mod, dev)
    bins, grad, hess, cnt = d["bins"], d["grad"], d["hess"], d["cnt"]
    route = (d["tbl"], d["member"], d["feat_tbl"])
    n, f = bins.shape
    n_routed = int(d["split"][d["row_node"].long()].sum())
    table_bytes = d["tbl"].numel() * 4 + d["member"].numel() * 4
    # the grower's fixed point of the single-precision mode: that of the
    # rounded hessians it sums
    scale = hm.exact_scale(grad, hm.single_prec_hess(hess), cnt)

    def live(h_sp, h_dp, name):
        check(same_bits(torch, h_sp[..., 0::2], h_dp[..., 0::2]) and
              not torch.equal(h_sp[..., 1], h_dp[..., 1]),
              f"{name}: the single-precision mode is not what it should be")

    def k1(dp=False):
        return hm.fused_route_hist(bins, grad, hess, cnt, d["row_node"],
                                   *route, num_slots=S_FUSED, bmax=BMAX,
                                   scale=scale, double_prec=dp)

    def k1_ref():
        return hm.fused_route_hist_ref(bins, grad, hess, cnt, d["row_node"],
                                       *route, num_slots=S_FUSED, bmax=BMAX,
                                       scale=scale, double_prec=False)
    h_ref, rn_ref = k1_ref()
    check(torch.equal(k1()[1], rn_ref), "fused_route_hist_sp routing differs")
    err = check_hist(torch, "fused_route_hist_sp", k1, h_ref)
    live(h_ref, k1(True)[0], "fused_route_hist")
    _, rs_ref = hm.route_rows_ref(bins, d["row_node"], *route)
    n_slot = int(((rs_ref >= 0) & (rs_ref < S_FUSED)).sum())
    row("fused_route_hist_sp", "lightgbm_tpu/learner/histogram_mxu.py:785",
        err, k1, k1_ref, 3,
        8 * n + n_routed + n_slot * (f + 12) + h_ref.numel() * 4 +
        table_bytes, n_slot * f * 3, None, source="build_histograms_scatter")

    rslot = d["row_slot"]

    def k3(dp=False):
        return hm.build_histograms(bins, grad, hess, cnt, rslot,
                                   num_slots=S_HIST, bmax=BMAX, scale=scale,
                                   double_prec=dp)

    def k3_ref():
        return hm.build_histograms_ref(bins, grad, hess, cnt, rslot,
                                       num_slots=S_HIST, bmax=BMAX,
                                       scale=scale, double_prec=False)
    h_ref = k3_ref()
    err = check_hist(torch, "build_histograms_sp", k3, h_ref)
    live(h_ref, k3(True), "build_histograms")
    n_slot = int((rslot >= 0).sum())
    row("build_histograms_sp", "lightgbm_tpu/learner/histogram_mxu.py:472",
        err, k3, k3_ref, 3,
        4 * n + n_slot * (f + 12) + h_ref.numel() * 4, n_slot * f * 3,
        index_add_fn(torch, bins, rslot, torch.stack(
            [grad, hm.single_prec_hess(hess), cnt], 1), S_HIST, BMAX),
        source="build_histograms_scatter")
    del h_ref

    _, slot, tallies = hm.route_rows(bins, d["row_node"], *route,
                                     emit_counts=True, num_slots=S_TUNE,
                                     chunk_tallies=True)

    def k7(dp=False):
        return hp.build_histograms_scatter(
            bins, grad, hess, cnt, slot, num_slots=S_TUNE, bmax=BMAX,
            scale=scale, slot_tallies=tallies, double_prec=dp)

    def k7_ref():
        return hp.build_histograms_scatter_ref(
            bins, grad, hess, cnt, slot, num_slots=S_TUNE, bmax=BMAX,
            scale=scale, slot_tallies=tallies, double_prec=False)
    h_ref = k7_ref()
    err = check_hist(torch, "build_histograms_scatter_sp", k7, h_ref)
    live(h_ref, k7(True), "build_histograms_scatter")
    n_slot = int(((slot >= 0) & (slot < S_TUNE)).sum())
    row("build_histograms_scatter_sp",
        "lightgbm_tpu/learner/histogram_pallas.py:211", err, k7, k7_ref, 3,
        4 * n + n_slot * (f + 12) + S_TUNE * f * BMAX * 12, n_slot * f * 3,
        index_add_fn(torch, bins, slot, torch.stack(
            [grad, hm.single_prec_hess(hess), cnt], 1), S_TUNE, BMAX),
        source="build_histograms_scatter")
    del h_ref, d

    dp = kernel_inputs(torch, hm, rng_mod, dev, bmax=BMAX_PACKED)
    pk = torch.as_tensor(hm.pack_bins_4bit(dp["bins"].cpu().numpy()),
                         device=dev)
    g, h, c = dp["grad"], dp["hess"], dp["cnt"]
    kw = dict(bmax=BMAX_PACKED, num_features=f, double_prec=False,
              scale=hm.exact_scale(g, hm.single_prec_hess(h), c))
    route = (dp["tbl"], dp["member"], dp["feat_tbl"])
    check_hist(torch, "fused_route_hist_packed_sp",
               lambda: hm.fused_route_hist(pk, g, h, c, dp["row_node"],
                                           *route, num_slots=S_FUSED, **kw),
               hm.fused_route_hist_ref(pk, g, h, c, dp["row_node"], *route,
                                       num_slots=S_FUSED, **kw)[0])
    check_hist(torch, "build_histograms_packed_sp",
               lambda: hm.build_histograms_auto(pk, g, h, c, dp["row_slot"],
                                                num_slots=S_TUNE, **kw),
               hm.build_histograms_ref(pk, g, h, c, dp["row_slot"],
                                       num_slots=S_TUNE, **kw))
    emit("kernel_check", name="single_prec_packed",
         kernels=["fused_route_hist_packed_sp", "build_histograms_packed_sp"],
         rows=n, features=f, bins=BMAX_PACKED, equal=True)
    del dp, pk


def replayed_rate(torch, lgt, ds, params):
    """(replayed trees/s, booster): update_batch(10) (iteration 0, the
    capture and nine trees), then update_batch(10) timed, the graphs'
    replays alone."""
    booster = lgt.Booster(params, ds)
    booster.update_batch(EFB_BLOCK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster.update_batch(EFB_BLOCK)
    torch.cuda.synchronize()
    return EFB_BLOCK / (time.perf_counter() - t0), booster


def _model_sha(booster):
    return _sha(booster.model_to_string())


def single_prec_path(torch, lgt, hm, X, y, ds, exact_auc):
    """Phase `single_prec`: gpu_use_dp=false on the MXU grower. Launch
    counts reset, then the fused phases' turns on SP_PARAMS (train at
    fused_block_size 10, update_batch twice, against 30 update() calls,
    byte-equal), 10 update() trees held by leaf_check with host
    predictions against the device scores, the pallas backend (K7) through
    train against update() (3 trees, byte-equal) and the wide data (100k
    x 200: K3) through train_booster; counts read: every single-precision kernel
    launched, no full-precision histogram. Then replayed trees/s of
    gpu_use_dp false against true (alternating, in one call) and the
    held-out AUC beside the main path's. Returns the counts."""
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    t0 = time.perf_counter()
    turns = fused_turns(torch, lgt, hm, ds, logloss, "single_prec_fused",
                        SP_PARAMS)
    booster, _, losses, _ = train_booster(
        "single_prec", torch, lgt, hm, ds, SP_PARAMS, TRAIN_TREES, logloss)
    host_err = host_vs_device(booster, X)
    check(host_err <= 1e-4, f"single_prec: host predictions {host_err} off "
          "the device scores")
    sp_auc = held_out_auc(booster)
    pallas = dict(SP_PARAMS, hist_backend="pallas")
    trained = lgt.train(pallas, ds, SP_CHECK_TREES)
    stepped = lgt.Booster(pallas, ds)
    for _ in range(SP_CHECK_TREES):
        stepped.update()
    check(_model_sha(trained) == _model_sha(stepped),
          "single_prec: train differs from update() under hist_backend "
          "pallas")
    del trained, stepped
    Xw, yw = make_higgs_like(WIDE_ROWS, WIDE_FEATURES, seed=23)
    ds_w = lgt.Dataset(Xw, label=yw, params=SP_PARAMS)
    train_booster("single_prec_wide", torch, lgt, hm, ds_w, SP_PARAMS,
                  WIDE_TREES, logloss_of(torch, yw))
    del ds_w, Xw
    path_s = time.perf_counter() - t0
    counts = hm.launch_counts()
    for key in SP_PATH:
        check(counts[key] > 0, f"{key} was not launched on the single_prec "
              "path")
    for key in ("fused_route_hist", "build_histograms",
                "build_histograms_scatter"):
        check(counts[key] == 0, f"the single_prec path launched {key} in "
              "full precision")
    check_partition_launches(counts, "single_prec")
    rates = {"true": [], "false": []}
    for dp in ("true", "false", "false", "true"):
        rate, b = replayed_rate(torch, lgt, ds, dict(
            TRAIN_PARAMS, gpu_use_dp=dp == "true"))
        rates[dp].append(rate)
        del b
    emit("single_prec", trees_per_s_last10=turns,
         replayed_trees_per_s={"gpu_use_dp=true": rates["true"],
                               "gpu_use_dp=false": rates["false"]},
         held_out_auc=sp_auc, held_out_auc_gpu_use_dp_true=exact_auc,
         host_vs_device_max_abs=host_err, logloss=losses, path_s=path_s,
         launches={k: counts[k] for k in SP_PATH})
    check(sp_auc > 0.75 and abs(sp_auc - exact_auc) <= 0.005,
          f"single_prec: held-out AUC {sp_auc} against {exact_auc}")
    return counts


def stack_trees(torch, trees):
    from lightgbm_tpu_torch.learner.grower import TreeArrays
    return TreeArrays(*[torch.stack(list(f)) for f in zip(*trees)])


def wide_bin_rows(torch, hm, hp, row, gbdt, valid_bins):
    """K7's uint16 mode at the portable grower's shapes (the booster's
    1M x 28 bins at max_bin 1023, its 256 slots, 3% of rows parked), exact,
    bit for bit against its plain version and across two calls, also at
    the root pass's one slot (split runs, partials); its integer mode
    checked. Bound: src, each slotted row's 2-byte bins and channels once,
    the [256, 28, bmax, 3] output once; library: one index_add_ of the same
    cells. Then kernel V's wide mode: the booster's trees stacked over the
    40,000 held-out rows' uint16 bins from a score, trajectory bit for
    bit; bound: the bins on each row's paths, the nodes, the score in and
    the trajectory out; library: the indexing walk (one CUDA graph)."""
    from lightgbm_tpu_torch.learner import predict as pr
    dev = gbdt.bins.device
    bins, bmax = gbdt.bins, gbdt.bmax
    n, f = bins.shape
    rng = np.random.RandomState(43)
    slot = rng.randint(0, S_PORTABLE, n)
    slot[rng.rand(n) < 0.03] = -1
    slot = torch.as_tensor(slot.astype(np.int32), device=dev)
    grad = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    hess = torch.as_tensor(rng.uniform(0.05, 0.25, n).astype(np.float32),
                           device=dev)
    cnt = torch.ones(n, device=dev)
    scale = hm.exact_scale(grad, hess, cnt)
    for s in (1, S_PORTABLE):
        sl = slot if s > 1 else torch.where(slot >= 0, 0, -1).to(torch.int32)

        def k7(sl=sl, s=s):
            return hp.build_histograms_scatter(bins, grad, hess, cnt, sl,
                                               num_slots=s, bmax=bmax,
                                               scale=scale)

        def k7_ref(sl=sl, s=s):
            return hp.build_histograms_scatter_ref(bins, grad, hess, cnt, sl,
                                                   num_slots=s, bmax=bmax,
                                                   scale=scale)
        err = check_hist(torch, f"build_histograms_scatter_wide at {s} "
                         "slots", k7, k7_ref())
    g_q = torch.round(grad * 40).clamp(-127, 127).to(torch.int8)
    h_q = torch.round(hess * 400).to(torch.int8)
    check(torch.equal(*[fn(bins, g_q, h_q, cnt, slot, num_slots=S_PORTABLE,
                           bmax=bmax, quantized=True) for fn in (
        hp.build_histograms_scatter, hp.build_histograms_scatter_ref)]),
        "build_histograms_scatter's uint16 integer mode differs from its "
        "plain version")
    n_slot = int((slot >= 0).sum())
    wide64 = hm.bins_int64(bins)
    row("build_histograms_scatter_wide",
        "lightgbm_tpu/learner/histogram_pallas.py:211 (via "
        "build_histograms_pallas, :276)", err, k7, k7_ref, 3,
        4 * n + n_slot * (2 * f + 12) + S_PORTABLE * f * bmax * 12,
        n_slot * f * 3,
        index_add_fn(torch, wide64, slot, torch.stack([grad, hess, cnt], 1),
                     S_PORTABLE, bmax), source="build_histograms_scatter")
    del wide64

    trees = stack_trees(torch, gbdt.trees)
    k = trees.leaf_value.shape[0]
    nv = valid_bins.shape[0]
    score0 = torch.as_tensor(rng.randn(nv).astype(np.float32), device=dev)
    nb, nan = gbdt.num_bins_d, gbdt.missing_is_nan_d
    traj, leaf = pr.stacked_leaf_nodes(trees, valid_bins, nb, nan, score0)
    _, want, want_leaf = pr.stacked_score_traj_ref(trees, score0, valid_bins,
                                                   nb, nan, leaves=True)
    check(same_bits(torch, traj, want) and torch.equal(leaf, want_leaf),
          "predict_binned's wide mode differs from its plain version")
    vb64 = hm.bins_int64(valid_bins)
    rows_ = torch.arange(nv, device=dev)
    seen = torch.zeros((nv, f), dtype=torch.bool, device=dev)
    sf = trees.split_feature.long()
    visits, depth = 0, []
    for t in range(k):
        par = trees.parent[t].long()
        cur, dd = leaf[t].long(), 0
        while True:
            up = par[cur]
            active = up >= 0
            m = int(active.sum())
            if m == 0:
                break
            up = up.clamp(min=0)
            visits += m
            seen[rows_[active], sf[t][up][active]] = True
            cur = torch.where(active, up, cur)
            dd += 1
        depth.append(dd)
    nodes = int(trees.num_nodes.sum())
    nbytes = 2 * int(seen.sum()) + 22 * nodes + 4 * nv + 4 * k * nv

    def library():
        s_ = score0
        for t in range(k):
            node = torch.zeros(nv, dtype=torch.int64, device=dev)
            for _ in range(depth[t]):
                feat = sf[t][node].clamp(min=0)
                b = vb64[rows_, feat]
                go = torch.where(nan[feat] & (b == nb[feat] - 1),
                                 trees.default_left[t][node],
                                 b <= trees.threshold_bin[t][node])
                nxt = torch.where(go, trees.left[t][node],
                                  trees.right[t][node]).long()
                node = torch.where(sf[t][node] >= 0, nxt, node)
            s_ = s_ + trees.leaf_value[t][node]
        return s_
    row("predict_binned_wide", "lightgbm_tpu/learner/predict.py:25 "
        "(_traverse, predict_binned_tree; lightgbm_tpu/boosting/fused.py:54 "
        "stacked_score_traj; XLA, no Pallas), uint16 bins", 0.0,
        lambda: pr.stacked_score_traj(trees, score0, valid_bins, nb, nan),
        lambda: pr.stacked_score_traj_ref(trees, score0, valid_bins, nb,
                                          nan), 3, nbytes, visits, library,
        source="predict_binned", library_graph=True)


def wide_bins_path(torch, lgt, hm, hp, X, y, row, exact_auc):
    """Phase `wide_bins`: max_bin 1023 on the portable grower. The 1M x 28
    matrix binned to uint16 (seconds), a 40,000-row held-out set binned
    with its mappers; launch counts reset, then for use_pallas true (K7's
    wide mode) and false (the segment sums): train_booster (update(),
    leaf_check, host predictions against the device scores) and
    engine.train with the held-out set on auc (kernel V's wide mode every
    iteration), the two model texts byte-equal (10 trees each); counts
    read: K7 wide, the
    partition and V wide launched, no kernel of the MXU grower. Then the
    kernel rows (wide_bin_rows) and the held-out AUC beside the main
    path's. Returns the counts."""
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=WIDE_BIN_PARAMS).construct()
    binning_s = time.perf_counter() - t0
    Xva, yva = make_higgs_like(VALID_ROWS, N_FEATURES, seed=99)
    dv = lgt.Dataset(Xva, label=yva, reference=ds)
    logloss = logloss_of(torch, y)
    hm.reset_launch_counts()
    runs = {}
    for impl in ("pallas", "scatter"):
        params = dict(WIDE_BIN_PARAMS, use_pallas=impl == "pallas")
        booster, secs, losses, _ = train_booster(
            "wide_bins_" + impl, torch, lgt, hm, ds, params, WIDE_BIN_TREES,
            logloss)
        g = booster.gbdt
        check(g._hist_impl == impl and g.bins.dtype == torch.uint16 and
              g.bmax > 256, f"wide_bins: {g._hist_impl} grower over "
              f"{g.bins.dtype} bins, bmax {g.bmax}")
        host_err = host_vs_device(booster, X)
        check(host_err <= 1e-4, f"wide_bins_{impl}: host predictions "
              f"{host_err} off the device scores")
        ev = {}
        trained = lgt.train(params, ds, WIDE_BIN_TREES, valid_sets=[dv],
                            valid_names=["held_out"],
                            callbacks=[lgt.record_evaluation(ev)])
        check(_model_sha(trained) == _model_sha(booster),
              f"wide_bins_{impl}: two runs wrote different model text")
        held = auc(trained.predict(Xva, raw_score=True), yva)
        recorded = ev["held_out"]["auc"][-1]
        check(abs(recorded - held) <= 1e-6, f"wide_bins_{impl}: recorded "
              f"AUC {recorded} against the host model's {held}")
        runs[impl] = dict(train_s=secs, trees_per_s=WIDE_BIN_TREES / secs,
                          logloss=losses, held_out_auc=held,
                          host_vs_device_max_abs=host_err,
                          stats=dict(g.grow_stats),
                          leaves=[int(t.num_leaves) for t in g.trees],
                          model_sha256=_model_sha(booster)[:16])
    counts = hm.launch_counts()
    for key in WIDE_BIN_PATH:
        check(counts[key] > 0, f"{key} was not launched on the wide_bins "
              "path")
    for key in MXU_ONLY:
        check(counts[key] == 0, f"the wide_bins path launched {key}")
    check_partition_launches(counts, "wide_bins")
    wide_bin_rows(torch, hm, hp, row, booster.gbdt,
                  trained.gbdt.valid_bins[0])
    aucs = [r["held_out_auc"] for r in runs.values()]
    emit("wide_bins", rows=N_ROWS, features=N_FEATURES,
         bmax=int(booster.gbdt.bmax), binning_s=binning_s,
         bin_bytes=int(booster.gbdt.bins.numel() * 2), runs=runs,
         held_out_auc_max_bin_255=exact_auc,
         launches={k: counts[k] for k in WIDE_BIN_PATH})
    check(min(aucs) > 0.75, f"wide_bins: held-out AUC {aucs}")
    return counts


def monotone_sweep(booster, ds, Xva):
    """The largest step against the constraint when feature 0 (+1) and
    feature 1 (-1) sweep their bin upper bounds on MONO_ROWS held-out rows
    with the other features held (<= 0 when monotone)."""
    worst = -np.inf
    for j, sign in ((0, 1.0), (1, -1.0)):
        ub = np.asarray(ds.binned.mappers[j].bin_upper_bound, np.float64)
        grid = ub[np.isfinite(ub)].astype(np.float32)
        sweep = np.repeat(Xva[:MONO_ROWS], len(grid), axis=0)
        sweep[:, j] = np.tile(grid, MONO_ROWS)
        pred = booster.predict(sweep, raw_score=True).reshape(MONO_ROWS, -1)
        worst = max(worst, float(np.max(-sign * np.diff(pred, axis=1))))
    return worst


def clamped_leaf_check(torch, name, grown):
    """leaf_check for monotone-constrained trees: every leaf holds -G/H of
    its rows (float64 sums) clamped into the bounds its parent's scan used
    (the grower's node_bounds), within LEAF_TOL, so a wrong histogram shows
    in a clamped leaf too unless -G/H lies beyond its bound. Prints the
    largest difference and the share the bounds clamped."""
    errs, clamped, leaves = [], 0, 0
    for tree, row_node, grad, hess, bounds in grown:
        nn = int(tree.num_nodes)
        value = tree.leaf_value[:nn].double()
        node = row_node.long()
        rows = torch.stack([grad, hess, torch.ones_like(grad)], 1).double()
        sums = torch.zeros((nn, 3), dtype=torch.float64,
                           device=node.device).index_add_(0, node, rows)
        leaf = (sums[:, 2] > 0) & tree.is_leaf[:nn]
        free = -sums[:, 0] / torch.where(leaf, sums[:, 1], 1.0)
        lo, hi = bounds[:nn].double().unbind(1)
        want = torch.clamp(free, lo, hi)
        err = torch.where(leaf, (value - want).abs(), 0.0)
        errs.append(float(err.max()))
        check(errs[-1] <= LEAF_TOL, f"{name}: a leaf is {errs[-1]} off -G/H "
              "of its rows clamped into its bounds")
        clamped += int((leaf & ((free - want).abs() > LEAF_TOL)).sum())
        leaves += int(leaf.sum())
    emit("leaf_check", run=name, max_leaf_err=max(errs),
         max_leaf_err_per_tree=errs, clamped_leaves=clamped, leaves=leaves)


def monotone_methods_path(torch, lgt, hm, X, y, ds, exact_auc):
    """Phase `monotone_methods`: monotone_constraints_method intermediate
    and advanced (+1 on feature 0, -1 on feature 1) on the portable
    grower, leaf-wise. Launch counts reset, then per method: update() for
    MONO_METHOD_TREES trees (every leaf -G/H of its rows clamped into its
    bounds) and engine.train, byte-equal; held-out AUC, the monotone sweep
    (no step against a constraint), host predictions against the device
    scores, seconds a tree, passes a tree; counts read: K7 and the
    partition launched, no kernel of the MXU grower. Then tree 0 of each method on the card against the CPU's
    at MONO_CPU_ROWS rows and MONO_CPU_LEAVES leaves (the cross_device
    check's scale); the held-out AUC beside the unconstrained main path's.
    Returns the counts."""
    logloss = logloss_of(torch, y)
    Xva, _ = make_higgs_like(40_000, N_FEATURES, seed=99)
    hm.reset_launch_counts()
    runs = {}
    for method in ("intermediate", "advanced"):
        params = dict(MONO_METHOD_PARAMS, monotone_constraints_method=method)
        grown = []

        def keep(gbdt, grad, hess, tree, row_node):
            grown.append((tree, row_node, grad, hess,
                          gbdt.grow_stats["node_bounds"]))
        booster, secs, losses, _ = train_booster(
            "monotone_" + method, torch, lgt, hm, ds, params,
            MONO_METHOD_TREES, logloss, leaf_check=False, on_grow=keep)
        clamped_leaf_check(torch, "monotone_" + method, grown)
        del grown
        g = booster.gbdt
        check(g._hist_impl == "pallas" and g._mono_method == method,
              f"monotone_{method}: {g._hist_impl} grower, method "
              f"{g._mono_method}")
        trained = lgt.train(params, ds, MONO_METHOD_TREES)
        check(_model_sha(trained) == _model_sha(booster),
              f"monotone_{method}: two runs wrote different model text")
        del trained
        worst = monotone_sweep(booster, ds, Xva)
        check(worst <= 0.0, f"monotone_{method}: a held-out sweep steps "
              f"{worst} against its constraint")
        host_err = host_vs_device(booster, X)
        check(host_err <= 1e-4, f"monotone_{method}: host predictions "
              f"{host_err} off the device scores")
        st = g.grow_stats
        runs[method] = dict(
            s_per_tree=secs / MONO_METHOD_TREES, logloss=losses,
            held_out_auc=held_out_auc(booster), worst_step=worst,
            host_vs_device_max_abs=host_err,
            passes_per_tree=st["passes"] / st["trees"],
            leaves=[int(t.num_leaves) for t in g.trees],
            model_sha256=_model_sha(booster)[:16])
        del booster
    counts = hm.launch_counts()
    for key in MONO_METHOD_PATH:
        check(counts[key] > 0, f"{key} was not launched on the "
              "monotone_methods path")
    for key in MXU_ONLY:
        check(counts[key] == 0, f"the monotone_methods path launched {key}")
    check_partition_launches(counts, "monotone_methods")
    # tree 0 on the card against the CPU's: fixed-point histograms and root
    # sums, float64 scans and exact bounds give the same bits on both
    Xs, ys = X[:MONO_CPU_ROWS], y[:MONO_CPU_ROWS]
    tree0 = {}
    for method in ("intermediate", "advanced"):
        texts = {}
        for device in ("cuda", "cpu"):
            p = dict(MONO_METHOD_PARAMS, num_leaves=MONO_CPU_LEAVES,
                     monotone_constraints_method=method, device_type=device)
            b = lgt.train(p, lgt.Dataset(Xs, label=ys, params=p), 1)
            texts[device] = tree_blocks(b.model_to_string())
        tree0[method] = texts["cuda"] == texts["cpu"]
        check(tree0[method], f"monotone_{method}: tree 0 on the card differs "
              "from the CPU's")
    emit("monotone_methods", rows=N_ROWS, features=N_FEATURES,
         trees=MONO_METHOD_TREES, runs=runs, tree0_equals_cpu=tree0,
         held_out_auc_unconstrained_10_trees=exact_auc,
         cpu_rows=MONO_CPU_ROWS, cpu_leaves=MONO_CPU_LEAVES,
         launches={k: counts[k] for k in MONO_METHOD_PATH})
    return counts


# ---- forced splits, CEGB and the guard rails
FORCED_TREES = 20
FORCED_BLOCK = 10
# a root on feature 0, both children, and one grandchild (right-left)
FORCED_SPEC = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.5},
               "right": {"feature": 2, "threshold": -0.3,
                         "left": {"feature": 3, "threshold": 0.2}}}
# the grandchild's threshold lies past its feature's range: every row goes
# left, the forced split cannot apply and the BFS stops there (its child
# on feature 5 is never forced)
FORCED_STOP_SPEC = {**FORCED_SPEC, "right": {
    "feature": 2, "threshold": -0.3,
    "left": {"feature": 3, "threshold": 1e9,
             "left": {"feature": 5, "threshold": 0.0}}}}
CEGB_TREES = 10
CEGB_BLOCKED = 4      # the feature the coupled penalty keeps out
CEGB_COUPLED = [1e6 if f == CEGB_BLOCKED else 0.0 for f in range(N_FEATURES)]
CEGB_PARAMS = dict(TRAIN_PARAMS, cegb_penalty_split=0.1,
                   cegb_penalty_feature_coupled=CEGB_COUPLED)
# the coupled penalty alone: at 1M rows the split penalty above (0.1 x a
# node's rows) stops trees at a few leaves, so the blocked feature is
# also held out of full 255-leaf trees
CEGB_COUPLED_PARAMS = dict(TRAIN_PARAMS,
                           cegb_penalty_feature_coupled=CEGB_COUPLED)
LAZY_TREES = 3
LAZY_PARAMS = dict(TRAIN_PARAMS, cegb_penalty_feature_lazy=[1e-3] * N_FEATURES)
GUARD_TREES = 5
# a forced node's rank key in the prune, gain + 1e30 in f32: 1e30 itself
FORCED_KEY = float(np.float32(1e30))
GUARD_BAD_CALL = 3    # the custom objective's call that holds a NaN
FORCED_CEGB_PATH = ("prune_best_first", "fused_route_hist",
                    "fused_route_hist_int", "node_values", "node_sums",
                    "build_histograms_scatter")
# the row's launches: the path's prunes under a forced spec (its counts'
# key of that name), not the path's other prunes
ROW_PATH["prune_best_first_forced"] = "forced_cegb"


def _forced_applied(tree, spec, bins):
    """The spec's BFS nodes that `tree` (TreeArrays) split as the spec
    says, walking spec and tree together from the root until a node does
    not (bins: the spec's threshold bins in BFS order)."""
    feat = tree.split_feature.cpu().numpy()
    thr = tree.threshold_bin.cpu().numpy()
    left, right = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    fbin = [int(b) for b in bins]
    applied, todo, i = [], [(0, spec)], 0
    while todo:
        node, sp = todo.pop(0)
        if feat[node] != sp["feature"] or thr[node] != fbin[i]:
            return applied
        applied.append(int(node))
        i += 1
        for side, child in (("left", left), ("right", right)):
            if sp.get(side):
                todo.append((int(child[node]), sp[side]))
    return applied


def _nan_fobj(y, bad_call):
    """A binary logloss objective on the host whose call `bad_call` puts a
    NaN in one gradient."""
    def fobj(score, data):
        fobj.calls += 1
        p = 1.0 / (1.0 + np.exp(-score.astype(np.float64)))
        g = (p - y).astype(np.float32)
        h = (p * (1.0 - p)).astype(np.float32)
        if fobj.calls == bad_call:
            g[0] = np.nan
        return g, h
    fobj.calls = 0
    return fobj


def forced_cegb_path(torch, lgt, hm, X, y, ds, row):
    """Phase `forced_cegb`, launch counts reset before it and
    read after it:
    - forced splits on the fused trainer: FORCED_SPEC (a root on feature
      0, both children, one grandchild) through engine.train at
      fused_block_size 10 for 20 trees against 20 update() calls,
      byte-equal, exact and quantized; every tree's root and forced
      descendants carry the spec's features and threshold bins; held-out
      AUC above 0.75; replayed trees/s with and without the spec
      (informational, alternating);
    - FORCED_STOP_SPEC (an inapplicable grandchild): the prune's rank keys
      hold three forced nodes, not four, and the grandchild's split is not
      the spec's;
    - CEGB on the MXU grower (split penalty 0.1, a coupled penalty of 1e6
      on feature CEGB_BLOCKED; then the coupled penalty alone), per
      iteration, 10 trees each: the feature is never split on, K8 never
      launched, train equals update(), seconds a tree;
    - lazy CEGB on the portable grower, 3 trees: K7 launched, K1 not,
      finite trees, seconds a tree;
    - guard_nonfinite with a custom objective that puts a NaN in one
      gradient on its third call, each policy for 5 trees: warn,
      skip_iteration and rollback complete with one trip and finite
      predictions, raise raises GuardError; a clean run under warn writes
      guard_nonfinite=off's trees.
    The counts are read there; then the prune kernel P is held against
    its plain version, bit for bit, on the main path's forced rank keys
    (caught at the prune of an update() tree) and on a synthetic
    overgrown tree whose top group is tied at 1e30, and timed as the row
    prune_best_first_forced. Returns the counts, with the prunes run under
    a forced spec as "prune_best_first_forced"."""
    import json
    import tempfile
    from lightgbm_tpu_torch.learner import grower_mxu, prune
    from lightgbm_tpu_torch.reliability import counters, guards
    t_phase = time.perf_counter()
    hm.reset_launch_counts()
    tmp = tempfile.TemporaryDirectory()
    paths = {}
    for name, spec in (("forced", FORCED_SPEC), ("stop", FORCED_STOP_SPEC)):
        paths[name] = os.path.join(tmp.name, name + ".json")
        with open(paths[name], "w") as fh:
            json.dump(spec, fh)
    out = {}
    caught = []
    orig_prune = grower_mxu._prune_to_best_first

    def catch(tree, row_node, **kw):
        if kw.get("rank_gain") is not None:
            caught.append((tree.left, tree.right, tree.parent,
                           kw["rank_gain"]))
        return orig_prune(tree, row_node, **kw)

    forced_prunes = [0]           # P's launches under a forced spec

    @contextlib.contextmanager
    def under_spec():
        p0 = hm.launch_counts()["prune_best_first"]
        try:
            yield
        finally:
            forced_prunes[0] += hm.launch_counts()["prune_best_first"] - p0

    # ---- forced splits on the fused trainer, exact and quantized
    for name, base in (("exact", TRAIN_PARAMS), ("quantized", QUANT_PARAMS)):
        params = dict(base, forcedsplits_filename=paths["forced"],
                      fused_block_size=FORCED_BLOCK)
        with under_spec():
            trained = lgt.train(params, ds, FORCED_TREES)
        g = trained.gbdt
        check(bool(g.fused_stats) and g._fused_eligible(),
              f"forced {name}: train did not run the fused trainer")
        stepped = lgt.Booster(params, ds)
        with under_spec():
            for _ in range(FORCED_TREES):
                stepped.update()
        sha_t, sha_s = _model_sha(trained), _model_sha(stepped)
        check(sha_t == sha_s, f"forced {name}: train's model text is not "
              "update()'s")
        applied = [_forced_applied(t, FORCED_SPEC, g._forced[1])
                   for t in g.trees]
        check(all(len(a) == 4 for a in applied), f"forced {name}: trees "
              f"apply {sorted(set(len(a) for a in applied))} of the spec's "
              "4 splits")
        auc_ = held_out_auc(trained)
        check(auc_ > 0.75, f"forced {name}: held-out AUC {auc_} <= 0.75")
        if name == "exact":
            grower_mxu._prune_to_best_first = catch
            try:
                with under_spec():
                    stepped.update()
            finally:
                grower_mxu._prune_to_best_first = orig_prune
        # the trees' sha256 (the parameter lines name a temporary file)
        out[name] = dict(trees_sha256=_sha(tree_blocks(
                             trained.model_to_string()))[:16],
                         held_out_auc=auc_,
                         fused_stats_trees=[s["trees"]
                                            for s in g.fused_stats],
                         forced_nodes_tree0=applied[0],
                         leaves=[int(t.num_leaves) for t in g.trees])
        del trained, stepped, g
    torch.cuda.empty_cache()
    # ---- replayed trees/s with and without the spec (informational)
    rates = {"spec": [], "none": []}
    fixups = {"spec": [], "none": []}     # fix-up passes a tree
    for which in ("none", "spec", "spec", "none"):
        params = dict(TRAIN_PARAMS)
        if which == "spec":
            params["forcedsplits_filename"] = paths["forced"]
            with under_spec():
                rate, b = replayed_rate(torch, lgt, ds, params)
        else:
            rate, b = replayed_rate(torch, lgt, ds, params)
        rates[which].append(rate)
        fixups[which].append([sum(st["fixup_passes"]) / st["trees"]
                              for st in b.gbdt.fused_stats])
        del b
        torch.cuda.empty_cache()
    # ---- an inapplicable grandchild stops the BFS
    params = dict(TRAIN_PARAMS, forcedsplits_filename=paths["stop"])
    stop = lgt.Booster(params, ds)
    grower_mxu._prune_to_best_first = catch
    try:
        n_caught = len(caught)
        with under_spec():
            stop.update()
    finally:
        grower_mxu._prune_to_best_first = orig_prune
    stop_keys = caught[n_caught][3]
    n_forced = int((stop_keys == FORCED_KEY).sum())
    t0 = stop.gbdt.trees[0]
    rl = int(t0.left[int(t0.right[0])])
    rl_split = (int(t0.split_feature[rl]), int(t0.threshold_bin[rl]))
    check(n_forced == 3 and rl_split != (3, int(stop.gbdt._forced[1][3])),
          f"forced stop: {n_forced} forced nodes (want 3), the grandchild "
          f"split {rl_split}")
    check(len(_forced_applied(t0, FORCED_STOP_SPEC, stop.gbdt._forced[1]))
          == 3, "forced stop: the first three spec splits did not apply")
    out["stop"] = dict(forced_nodes=n_forced, grandchild_split=rl_split)
    del stop
    # ---- CEGB on the MXU grower, per iteration
    for name, params in (("cegb", CEGB_PARAMS),
                         ("cegb_coupled", CEGB_COUPLED_PARAMS)):
        before = hm.launch_counts()
        cegb = lgt.Booster(params, ds)
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        for _ in range(CEGB_TREES):
            cegb.update()
        torch.cuda.synchronize()
        cegb_s = (time.perf_counter() - t0_) / CEGB_TREES
        g = cegb.gbdt
        used = sorted({int(f) for t in g.trees
                       for f in t.split_feature.cpu().numpy() if f >= 0})
        check(g._hist_impl == "mxu" and CEGB_BLOCKED not in used,
              f"{name}: {g._hist_impl} grower, split features {used}")
        k8 = hm.launch_counts()["find_best_splits"] - \
            before["find_best_splits"]
        check(k8 == 0, f"{name} launched K8 {k8} times")
        trained = lgt.train(params, ds, CEGB_TREES)
        check(not trained.gbdt.fused_stats and
              _model_sha(trained) == _model_sha(cegb),
              f"{name}: train is not update()'s, one iteration a dispatch")
        out[name] = dict(s_per_tree=cegb_s, features_used=used,
                         leaves=[int(t.num_leaves) for t in g.trees],
                         feat_used=g._cegb_state.feat_used.cpu().numpy()
                         .astype(int).tolist(),
                         held_out_auc=held_out_auc(cegb))
        del cegb, trained, g
    # ---- lazy CEGB on the portable grower
    before = hm.launch_counts()
    lazy = lgt.Booster(LAZY_PARAMS, ds)
    torch.cuda.synchronize()
    t0_ = time.perf_counter()
    for _ in range(LAZY_TREES):
        lazy.update()
    torch.cuda.synchronize()
    lazy_s = (time.perf_counter() - t0_) / LAZY_TREES
    g = lazy.gbdt
    delta = {k: v - before[k] for k, v in hm.launch_counts().items()}
    finite = all(bool(torch.isfinite(t.leaf_value).all()) for t in g.trees)
    check(g._hist_impl == "pallas" and delta["build_histograms_scatter"] > 0
          and delta["fused_route_hist"] == 0 and finite,
          f"lazy cegb: {g._hist_impl} grower, K7 "
          f"{delta['build_histograms_scatter']}, K1 "
          f"{delta['fused_route_hist']}, finite {finite}")
    rfu = g._cegb_state.row_feat_used
    out["lazy"] = dict(s_per_tree=lazy_s, row_feat_used_shape=list(rfu.shape),
                       row_feat_used_share=float(rfu.float().mean()),
                       leaves=[int(t.num_leaves) for t in g.trees],
                       passes_per_tree=g.grow_stats["passes"] /
                       g.grow_stats["trees"])
    del lazy, g, rfu
    torch.cuda.empty_cache()
    # ---- guard_nonfinite, per iteration, with a custom objective
    guard = {}
    for policy in ("warn", "skip_iteration", "rollback", "raise"):
        counters.reset()
        params = dict(TRAIN_PARAMS, guard_nonfinite=policy)
        fobj = _nan_fobj(y, GUARD_BAD_CALL)
        raised = False
        try:
            b = lgt.train(params, ds, GUARD_TREES, fobj=fobj)
        except guards.GuardError:
            raised, b = True, None
        trips = counters.get("guard_trips")
        if policy == "raise":
            check(raised and trips == 1, f"guard raise: raised {raised}, "
                  f"{trips} trips")
            guard[policy] = dict(raised=raised, trips=trips)
            continue
        finite = bool(np.isfinite(b.predict(X[:HOST_ROWS])).all())
        check(not raised and b.current_iteration() == GUARD_TREES and
              trips == 1 and finite, f"guard {policy}: iterations "
              f"{b.current_iteration()}, {trips} trips, finite {finite}")
        guard[policy] = dict(trips=trips, iterations=b.current_iteration(),
                             finite=finite,
                             leaves=[int(t.num_leaves) for t in b.gbdt.trees])
        del b
    counters.reset()
    clean = lgt.train(dict(TRAIN_PARAMS, guard_nonfinite="warn"), ds,
                      GUARD_TREES)
    off = lgt.train(TRAIN_PARAMS, ds, GUARD_TREES)
    same = tree_blocks(clean.model_to_string()) == \
        tree_blocks(off.model_to_string())
    check(same and counters.get("guard_trips") == 0 and
          not clean.gbdt.fused_stats, "guard warn: a clean run's trees are "
          "not guard_nonfinite=off's")
    guard["clean_warn_equals_off"] = same
    del clean, off
    tmp.cleanup()
    counts = hm.launch_counts()
    counts["prune_best_first_forced"] = forced_prunes[0]
    for key in FORCED_CEGB_PATH + ("prune_best_first_forced",):
        check(counts[key] > 0, f"{key} was not launched on the forced_cegb "
              "path")
    # ---- P against its plain version on forced rank keys
    main_keys = caught[0]
    check(int((main_keys[3] == FORCED_KEY).sum()) == 4,
          "the main path's rank keys hold no 4 forced nodes")
    rng = np.random.RandomState(71)
    left, right, parent, gain = overgrown_tree(rng, M_GROWN,
                                               M_GROWN // 2 - 1, False)
    forced = np.zeros(M_GROWN, bool)
    todo = [0]
    while todo:                    # a root-connected group of forced nodes
        j = todo.pop(0)
        forced[j] = True
        todo += [int(c) for c in (left[j], right[j])
                 if left[c] >= 0 and rng.rand() < 0.8]
    rank = (gain + np.where(forced, np.float32(1e30), np.float32(0))) \
        .astype(np.float32)
    synth = [torch.as_tensor(a, device="cuda")
             for a in (left, right, parent, rank)]
    equal = {}
    for what, args in (("main path", main_keys), ("1e30-tied group", synth)):
        got = prune.prune_best_first(*args, num_leaves=PRUNE_LEAVES)
        want = prune.prune_best_first_ref(*args, num_leaves=PRUNE_LEAVES)
        equal[what] = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        check(all(equal[what]), f"prune_best_first on forced rank keys "
              f"({what}) differs from its plain version: {equal[what]}")
    m1 = M_GROWN
    row("prune_best_first_forced", "lightgbm_tpu/learner/grower_mxu.py:57",
        0.0, lambda: prune.prune_best_first(*main_keys,
                                            num_leaves=PRUNE_LEAVES),
        lambda: prune.prune_best_first_ref(*main_keys,
                                           num_leaves=PRUNE_LEAVES), 3,
        m1 * (16 + 10),
        (PRUNE_LEAVES - 1) * m1 + 2 * m1 * (m1 - 1).bit_length(), None,
        source="prune_best_first")
    emit("kernel_check", name="prune_best_first_forced",
         cases=list(equal), equal=True,
         forced_nodes={"main path": 4, "1e30-tied group": int(forced.sum())})
    emit("forced_cegb", rows=N_ROWS, features=N_FEATURES,
         trees=FORCED_TREES, fused_block_size=FORCED_BLOCK, spec=FORCED_SPEC,
         runs=out, replayed_trees_per_s=rates,
         fixup_passes_per_tree=fixups,
         order=["none", "spec", "spec", "none"], guard=guard,
         prune_launches=counts["prune_best_first"],
         prune_launches_under_spec=forced_prunes[0],
         seconds=time.perf_counter() - t_phase,
         launches={k: counts[k] for k in FORCED_CEGB_PATH})
    return counts


LINEAR_TREES = 10
LINEAR_QUANT_TREES = 5
LINEAR_LAMBDAS = (0.0, 0.1)
LINEAR_NAN_SHARE = 0.01
LINEAR_NAN_FEATURES = (0, 1)
LINEAR_PARAMS = dict(TRAIN_PARAMS, linear_tree=True)
LINEAR_QUANT = dict(LINEAR_PARAMS, use_quantized_grad=True,
                    hist_backend="mxu", linear_lambda=0.1)
LINEAR_PATH = ("linear_gram", "linear_values", "fused_route_hist",
               "prune_best_first", "predict_binned", "node_sums")
LINEAR_FIT_LEAVES = 8      # leaves held to a float64 host ridge solve
LINEAR_FIT_TOL = 1e-3      # of max(1, the host solution's largest |entry|)
LINEAR_HOST_TOL = 1e-4     # host float64 walk against device f32 scores
SHAP_ROWS = 1000
F64_OPS_PER_S = 34e12      # H100 SXM float64 outside the tensor cores
LINEAR_BIG_M1 = 8300       # node ids past L1's 8192 shared-memory counters
LINEAR_WIDE_D = 31         # the kernels' widest model: 32 slots with the
                           # intercept, 560 entries a leaf
SECTOR_BYTES = 32
ROW_PATH.update(dict.fromkeys(("linear_gram", "linear_values"), "linear"))


def _with_nan(X, seed):
    """X with LINEAR_NAN_SHARE of the rows' LINEAR_NAN_FEATURES values set
    to NaN (a copy)."""
    X = X.copy()
    rng = np.random.RandomState(seed)
    for f in LINEAR_NAN_FEATURES:
        X[rng.uniform(size=X.shape[0]) < LINEAR_NAN_SHARE, f] = np.nan
    return X


def host_ridge(lin, leaf, row_node, raw, g, h, cnt, lam):
    """(coefficients, const) of one leaf from a float64 ridge solve over
    its usable rows (cnt > 0, no NaN in its features), and the fitted
    model's, for the leaf check."""
    fs = lin.feat[leaf][lin.feat[leaf] >= 0].cpu().numpy()
    rows = ((row_node == leaf) & (cnt > 0)).cpu().numpy()
    x = raw.cpu().numpy()[rows][:, fs].astype(np.float64)
    ok = ~np.isnan(x).any(1)
    x = np.c_[x[ok], np.ones(ok.sum())]
    hv = h.cpu().numpy()[rows][ok].astype(np.float64)
    gv = g.cpu().numpy()[rows][ok].astype(np.float64)
    a = x.T @ (x * hv[:, None])
    a[np.arange(len(fs)), np.arange(len(fs))] += lam
    want = -np.linalg.solve(a, x.T @ gv)
    got = np.r_[lin.coeff[leaf][:len(fs)].cpu().numpy(),
                lin.const[leaf].cpu().numpy()].astype(np.float64)
    return got, want


def linear_bits_equal(torch, got, want):
    """Equal bits where the plain version is finite, NaN where it is NaN
    (the card and the host write other NaN bit patterns)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def raw_sectors(torch, raw, node, feat):
    """32-byte sectors of the row-major raw [N, F] that hold each row's
    leaf's model features (feat [M+1, D], -1 empty; rows whose node is out
    of range hold none), summed over the rows: the least a kernel reads of
    raw to gather them."""
    n, f = raw.shape
    m1 = feat.shape[0]
    total = 0
    for r0 in range(0, n, 1 << 18):
        nd = node[r0:r0 + (1 << 18)].long()
        inside = (nd >= 0) & (nd < m1)
        cols = feat[nd.clamp(0, m1 - 1)].long()
        rows = torch.arange(r0, r0 + nd.shape[0], device=raw.device)
        sec = (rows[:, None] * f + cols) * 4 // SECTOR_BYTES
        sec = torch.where((cols >= 0) & inside[:, None], sec, -1)
        sec = torch.sort(sec, dim=1).values
        first = sec[:, :1] >= 0
        later = (sec[:, 1:] != sec[:, :-1]) & (sec[:, 1:] >= 0)
        total += int(first.sum() + later.sum())
    return total


def linear_kernel_checks(torch, lmod, c, inf_leaf, valid=None):
    """L1 and L2 bit-equal to their plain versions, and across two calls,
    on the captured fit `c` (raw, row_node, g, h, cnt, the tree and its
    models): L1 on the fit's inputs, out-of-bag rows, an infinite hessian
    on a usable row of leaf inf_leaf (its X'HX NaN), 31 slots a leaf (all
    active, repeating columns: 560 entries, two a thread, 64-float
    records), LINEAR_BIG_M1 node ids (past the pack's shared-memory
    counters: a global counter a row), every row in one leaf (~1000
    chunks of it, ~500 runs reserving in it) and raw 4 bytes past a
    16-byte boundary (rows gathered, not staged); L2 on the training
    rows, the valid rows where `valid` = (leaf ids, raw) is given, and
    signed zeros (const -0.0, every other row +0 in every feature, the
    model coefficients negated, empty slots with coefficients -1 and -0 in
    even leaves, -1, +1 and -0 in odd ones), 31 active slots a leaf (the
    compact entries read from the global table), LINEAR_BIG_M1 leaves (the
    headers too) and raw off 16 bytes. Returns (the plain versions' gram
    outputs by case, the gram case names, the value case names)."""
    tree, lin = c["tree"], c["lin"]
    raw, node = c["raw"], c["row_node"]
    dev = raw.device
    n, f = raw.shape
    feat = lmod.leaf_features(lmod.path_feature_masks(
        tree, f, c["is_cat"]), c["dmax"])
    m1, d = feat.shape
    gram_args = (raw, node, c["g"], c["h"], c["cnt"], feat)
    cnt_bag = (torch.rand(c["cnt"].shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
               > 0.3).to(torch.float32)
    fs = lin.feat[inf_leaf]
    fs = fs[fs >= 0].long()
    usable_rows = (node == inf_leaf) & (c["cnt"] > 0) & \
        ~torch.isnan(raw[:, fs]).any(1)
    h_inf = c["h"].clone()
    h_inf[int(torch.nonzero(usable_rows)[0, 0])] = float("inf")
    ids = torch.arange(m1, device=dev)
    wide = ((ids[:, None] + torch.arange(LINEAR_WIDE_D, device=dev)) % f) \
        .to(torch.int32).contiguous()
    rows = torch.arange(n, device=dev)
    big = torch.where((node >= 0) & (node < m1),
                      (node.long() * 37 + rows) % LINEAR_BIG_M1, -1) \
        .to(torch.int32)
    big_feat = feat[torch.arange(LINEAR_BIG_M1, device=dev) % m1] \
        .contiguous()
    nf = (feat >= 0).sum(1)
    one = int(torch.argmax(nf * tree.is_leaf))      # a leaf with a model
    # raw 4 bytes past a 16-byte boundary: rows gathered, not staged
    raw_off = torch.empty(n * f + 1, dtype=raw.dtype, device=dev)[1:] \
        .view(n, f)
    raw_off.copy_(raw)
    gram_cases = {
        "main path": gram_args,
        "out-of-bag rows": gram_args[:4] + (cnt_bag, feat),
        "an infinite hessian": gram_args[:3] + (h_inf,) + gram_args[4:],
        f"{LINEAR_WIDE_D} slots": gram_args[:5] + (wide,),
        f"{LINEAR_BIG_M1} node ids": (raw, big) + gram_args[2:5] +
        (big_feat,),
        "one leaf, every row": (raw, torch.full_like(node, one)) +
        gram_args[2:],
        "raw off 16 bytes": (raw_off,) + gram_args[1:]}
    wants = {}
    for what, args in gram_cases.items():
        got, twice = lmod.linear_gram(*args), lmod.linear_gram(*args)
        want = wants[what] = lmod.linear_gram_ref(*args)
        for i, (a, b, w) in enumerate(zip(got, twice, want)):
            if w.dtype == torch.int32:
                ok = torch.equal(a, w) and torch.equal(b, w)
            else:
                ok = linear_bits_equal(torch, a, w) and \
                    linear_bits_equal(torch, b, w)
            check(ok, f"linear_gram output {i} ({what}) differs from its "
                  "plain version or across two calls")
    check(bool(torch.isnan(wants["an infinite hessian"][0][
        inf_leaf]).all()), "an infinite hessian did not make its leaf NaN")
    check(int(wants["one leaf, every row"][2][one]) ==
          int((c["cnt"] > 0).sum() - torch.isnan(
              raw[:, lin.feat[one][lin.feat[one] >= 0].long()]).any(1)
              .logical_and(c["cnt"] > 0).sum()),
          "one leaf, every row: its usable rows miscounted")
    # signed zeros: -0.0 survives a row only where every add is -0
    slot = torch.arange(lin.feat.shape[1], device=dev)
    lid = torch.arange(lin.feat.shape[0], device=dev)[:, None]
    empty_c = torch.where(
        lid % 2 == 0, torch.tensor([-1.0, -0.0], device=dev)[slot % 2],
        torch.tensor([-1.0, 1.0, -0.0], device=dev)[(lid + slot) % 3])
    sz = lmod.LinearLeaves(
        const=torch.full_like(lin.const, -0.0),
        coeff=torch.where(lin.feat >= 0, -lin.coeff.abs(), empty_c)
        .contiguous(), feat=lin.feat, nfeat=lin.nfeat)
    raw_sz = raw.clone()
    raw_sz[::2] = 0.0
    # 31 active slots a leaf (the entries read from the global table) and
    # LINEAR_BIG_M1 leaves (the headers too)
    gen = torch.Generator(dev).manual_seed(6)
    lin31 = lmod.LinearLeaves(
        const=lin.const, coeff=torch.randn(
            (m1, LINEAR_WIDE_D), device=dev, generator=gen),
        feat=wide, nfeat=torch.full_like(lin.nfeat, LINEAR_WIDE_D))
    tile = torch.arange(LINEAR_BIG_M1, device=dev) % m1
    big_tree = SimpleNamespace(leaf_value=tree.leaf_value[tile].contiguous())
    lin_big = lmod.LinearLeaves(*[t[tile].contiguous() for t in lin])
    value_cases = {"training rows": (tree, lin, node, raw)}
    if valid is not None:
        value_cases["valid rows"] = (tree, lin, *valid)
    value_cases.update({
        "signed zeros": (tree, sz, node, raw_sz),
        f"{LINEAR_WIDE_D} slots": (tree, lin31, node, raw),
        f"{LINEAR_BIG_M1} leaves": (big_tree, lin_big, big, raw),
        "raw off 16 bytes": (tree, lin, node, raw_off)})
    for what, (t, model, leaf, x) in value_cases.items():
        got = lmod.linear_leaf_values(t, model, leaf, x)
        twice = lmod.linear_leaf_values(t, model, leaf, x)
        want = lmod.linear_leaf_values_ref(t, model, leaf, x)
        check(linear_bits_equal(torch, got, want) and
              linear_bits_equal(torch, twice, want),
              f"linear_values ({what}) differs from its plain version")
        if what == "signed zeros":
            bits = want.view(torch.int32)
            check(bool((bits == -2 ** 31).any() and (bits == 0).any()),
                  "signed zeros: the case gave no -0.0 or no +0.0")
    return wants, list(gram_cases), list(value_cases)


def linear_path(torch, lgt, hm, X, y, row, booster):
    """Linear trees (linear_tree) at full width: the Higgs-like binary
    configuration with LINEAR_NAN_SHARE of features 0 and 1 NaN in the
    training and held-out rows, through engine.train with the 40,000-row
    held-out set, one iteration a dispatch on the MXU grower: 10 trees at
    each linear_lambda of LINEAR_LAMBDAS, the last run twice (model text
    byte-equal), and a quantized turn of 5 trees, twice. Checks the
    launches (L1, L2, K1, P and V; K5 in the quantized turn), the host
    model (native and numpy) against the device training scores and the
    valid scores, the text round trip, held-out AUC above 0.75 beside the
    constant-leaf model's on the same data, 8 leaves against a float64
    host ridge solve, SHAP on the constant-leaf main model (contributions
    summing to the raw score) and its refusal of the linear model; then L1
    and L2 bit-equal to their plain versions, and across two calls, on the
    captured inputs of the last exact tree's fit and on the valid set's
    leaf ids, and their kernel-table rows."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.learner import linear as lmod
    from lightgbm_tpu_torch.learner.predict import stacked_leaf_nodes
    t_phase = time.perf_counter()
    Xl = _with_nan(X, 81)
    Xva, yva = make_higgs_like(VALID_ROWS, N_FEATURES, seed=99)
    Xva = _with_nan(Xva, 82)
    t0 = time.perf_counter()
    ds = lgt.Dataset(Xl, label=y, params=LINEAR_PARAMS)
    ds.construct()
    binning_s = time.perf_counter() - t0
    check(ds.binned.raw is not None and ds.binned.raw.shape == X.shape,
          "the linear dataset kept no raw values")
    caught = {}
    fit = gbdt_mod.fit_linear_leaves

    def capture(tree, row_node, raw, g, h, cnt, is_cat, lam, *, dmax):
        lin = fit(tree, row_node, raw, g, h, cnt, is_cat, lam, dmax=dmax)
        caught.update(tree=tree, row_node=row_node, raw=raw, g=g, h=h,
                      cnt=cnt, is_cat=is_cat, lam=lam, dmax=dmax, lin=lin)
        return lin

    def run(params, trees):
        valid = ds.create_valid(Xva, label=yva)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b = lgt.train(dict(params, metric="auc"), ds, trees,
                      valid_sets=[valid])
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t) / trees

    hm.reset_launch_counts()
    runs, s_tree = {}, {}
    for lam in LINEAR_LAMBDAS:
        if lam == LINEAR_LAMBDAS[-1]:
            gbdt_mod.fit_linear_leaves = capture
        try:
            runs[lam], s_tree[f"lambda_{lam}"] = run(
                dict(LINEAR_PARAMS, linear_lambda=lam), LINEAR_TREES)
        finally:
            gbdt_mod.fit_linear_leaves = fit
    lin_b = runs[LINEAR_LAMBDAS[-1]]
    again, _ = run(dict(LINEAR_PARAMS, linear_lambda=LINEAR_LAMBDAS[-1]),
                   LINEAR_TREES)
    q_b, s_tree["quantized"] = run(LINEAR_QUANT, LINEAR_QUANT_TREES)
    q_again, _ = run(LINEAR_QUANT, LINEAR_QUANT_TREES)
    counts = hm.launch_counts()
    for key in LINEAR_PATH:
        check(counts[key] > 0, f"{key} was not launched on the linear path")
    text = lin_b.model_to_string()
    byte_equal = {"exact": _sha(text) == _sha(again.model_to_string()),
                  "quantized": _sha(q_b.model_to_string()) ==
                  _sha(q_again.model_to_string())}
    check(all(byte_equal.values()), f"linear model text differs across "
          f"two runs: {byte_equal}")
    check(text.count("is_linear=1") == LINEAR_TREES and
          "leaf_coeff=" in text, "the linear model text lacks its linear "
          "trees")
    del again, q_again
    # the constant-leaf model on the same data: seconds a tree on the same
    # per-iteration path (update()) and through train's fused blocks
    const_ds = lgt.Dataset(Xl, label=y, params=TRAIN_PARAMS)
    const_b = lgt.Booster(TRAIN_PARAMS, const_ds)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LINEAR_TREES):
        const_b.update()
    torch.cuda.synchronize()
    s_tree["constant_update"] = (time.perf_counter() - t) / LINEAR_TREES
    torch.cuda.synchronize()
    t = time.perf_counter()
    const_t = lgt.train(TRAIN_PARAMS, const_ds, LINEAR_TREES)
    torch.cuda.synchronize()
    s_tree["constant_train"] = (time.perf_counter() - t) / LINEAR_TREES
    aucs = {"linear": auc(lin_b.predict(Xva, raw_score=True), yva),
            "linear_quantized": auc(q_b.predict(Xva, raw_score=True), yva),
            "constant": auc(const_b.predict(Xva, raw_score=True), yva)}
    check(min(aucs.values()) > 0.75, f"held-out AUC: {aucs}")
    del const_t
    # host against device: the training rows and the held-out rows
    host = {}
    for name, b in (("exact", lin_b), ("quantized", q_b)):
        model = b._host_model()
        dev_train = b.gbdt.train_score_host()[:HOST_ROWS]
        native = b.predict(Xl[:HOST_ROWS], raw_score=True)
        numpy_ = model.predict(Xl[:HOST_ROWS], raw_score=True, native=False)
        dev_valid = b.gbdt.valid_scores[0].cpu().numpy()
        host[name] = {
            "train": float(np.abs(native - dev_train).max()),
            "native_numpy": float(np.abs(native - numpy_).max()),
            "valid": float(np.abs(b.predict(Xva, raw_score=True) -
                                  dev_valid).max())}
        check(max(host[name]["train"], host[name]["valid"]) <=
              LINEAR_HOST_TOL and host[name]["native_numpy"] == 0.0,
              f"linear host predictions against the device ({name}): "
              f"{host[name]}")
    back = lgt.Booster(model_str=text)
    round_trip = float(np.abs(back.predict(Xva) - lin_b.predict(Xva)).max())
    check(back.model_to_string() == text and round_trip <= 1e-9,
          f"linear model text round trip: {round_trip}")
    # SHAP on the constant-leaf main model (host numpy, ~20 ms a row and
    # 255-leaf tree: its first tree) and its refusal on linear trees
    t = time.perf_counter()
    contrib = booster.predict(X[:SHAP_ROWS], pred_contrib=True,
                              num_iteration=1)
    raw1 = booster.predict(X[:SHAP_ROWS], raw_score=True, num_iteration=1)
    shap_s = time.perf_counter() - t
    shap_err = float(np.abs(contrib.sum(1) - raw1).max())
    check(contrib.shape == (SHAP_ROWS, N_FEATURES + 1) and
          shap_err <= 1e-6, f"SHAP contributions do not sum to the raw "
          f"score: {shap_err}")
    try:
        lin_b.predict(Xva[:5], pred_contrib=True)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "pred_contrib on linear trees did not raise")
    # ---- 8 leaves of the captured fit against a float64 host solve
    c = caught
    lin = c["lin"]
    fitted = torch.nonzero(lin.nfeat > 0)[:, 0].cpu().numpy()
    check(len(fitted) >= LINEAR_FIT_LEAVES, f"only {len(fitted)} leaves "
          "got a linear model")
    pick = np.random.RandomState(83).choice(fitted, LINEAR_FIT_LEAVES,
                                            replace=False)
    fit_err = []
    for leaf in pick:
        got, want = host_ridge(lin, int(leaf), c["row_node"], c["raw"],
                               c["g"], c["h"], c["cnt"], c["lam"])
        fit_err.append(float(np.abs(got - want).max() /
                             max(1.0, np.abs(want).max())))
    check(max(fit_err) <= LINEAR_FIT_TOL, f"leaf models against a host "
          f"ridge solve: {fit_err}")
    # ---- L1 and L2 against their plain versions at the path's shapes,
    # with V's leaf ids of the valid set in the captured tree
    tree = c["tree"]
    gb = lin_b.gbdt
    _, vleaf = stacked_leaf_nodes(
        type(tree)(*[t.unsqueeze(0) for t in tree]), gb.valid_bins[0],
        gb.num_bins_d, gb.missing_is_nan_d)
    wants, gram_names, value_names = linear_kernel_checks(
        torch, lmod, c, int(pick[0]),
        valid=(vleaf[0].contiguous(), gb.valid_raws[0]))
    emit("kernel_check", name="linear_gram", cases=gram_names,
         bit_equal=True)
    emit("kernel_check", name="linear_values", cases=value_names,
         bit_equal=True)
    # ---- kernel rows, at the captured fit's shapes
    dev = c["raw"].device
    n, f = c["raw"].shape
    feat = lmod.leaf_features(lmod.path_feature_masks(
        tree, f, c["is_cat"]), c["dmax"])
    gram_args = (c["raw"], c["row_node"], c["g"], c["h"], c["cnt"], feat)
    m1, d = feat.shape
    d1 = d + 1
    # bytes: each row's node, g, h, cnt and its leaf's raw values, the
    # feature table, the outputs; float64 operations: each usable row's
    # three multiplies an (i <= j) entry and two an X'g entry. The sector
    # floor counts, in place of the raw values' own bytes, the 32-byte
    # sectors of the row-major raw that hold them
    node = c["row_node"].long()
    nact = (feat >= 0).sum(1).long() + 1            # slots with the intercept
    usable = wants["main path"][2].long()
    f64_ops = int((usable * (3 * (nact * (nact + 1) // 2) + 2 * nact)).sum())
    gram_tables = m1 * d * 4 + m1 * (d1 * d1 + d1 + 1) * 4
    gram_bytes = n * 16 + int(4 * (nact[node] - 1).sum()) + gram_tables
    sectors = {"linear_gram": raw_sectors(torch, c["raw"], c["row_node"],
                                          feat),
               "linear_values": raw_sectors(torch, c["raw"], c["row_node"],
                                            lin.feat)}
    floor_bytes = {"linear_gram": n * 16 + gram_tables}

    def jax_formulation():
        """The JAX package's accumulation (linear.py:87-150): 8192-row
        chunks of [C, D+1, D+1] outer products index_add_-ed per leaf."""
        raw, g, h, cn = c["raw"], c["g"], c["h"], c["cnt"]
        xthx = torch.zeros((m1, d1, d1), device=dev)
        xtg = torch.zeros((m1, d1), device=dev)
        for c0 in range(0, n, 8192):
            nd = c["row_node"][c0:c0 + 8192].long()
            lf = feat[nd]
            fm = lf >= 0
            xg = raw[c0:c0 + 8192].gather(1, lf.clamp(0).long())
            nanr = (torch.isnan(xg) & fm).any(1)
            x = torch.where(fm & ~torch.isnan(xg), xg, 0.0)
            xt = torch.cat([x, torch.ones_like(x[:, :1])], 1)
            use = (~nanr) & (cn[c0:c0 + 8192] > 0)
            wh = torch.where(use, h[c0:c0 + 8192], 0.0)
            wg = torch.where(use, g[c0:c0 + 8192], 0.0)
            xthx.index_add_(0, nd, xt[:, :, None] * xt[:, None, :] *
                            wh[:, None, None])
            xtg.index_add_(0, nd, xt * wg[:, None])
        return xthx, xtg

    row("linear_gram", "lightgbm_tpu/learner/linear.py:87 "
        "(fit_linear_leaves, XLA)", 0.0, lambda: lmod.linear_gram(*gram_args),
        lambda: lmod.linear_gram_ref(*gram_args), 3, gram_bytes, f64_ops,
        jax_formulation, source="linear_leaves", ops_per_s=F64_OPS_PER_S,
        library_graph=True)

    def indexing_walk():
        """One formulation in library calls: gather each row's model, its
        features, the dot, and the NaN fallback."""
        nd = c["row_node"].long()
        lf = lin.feat[nd]
        fm = lf >= 0
        xg = c["raw"].gather(1, lf.clamp(0).long())
        x = torch.where(fm, xg, 0.0)
        val = lin.const[nd] + (lin.coeff[nd] * x).sum(1)
        return torch.where((torch.isnan(xg) & fm).any(1),
                           tree.leaf_value[nd], val)

    nf_row = (lin.feat >= 0).sum(1)[node]
    values_tables = m1 * (3 * 4 + 2 * d * 4)
    values_bytes = n * 8 + int(4 * nf_row.sum()) + values_tables
    floor_bytes["linear_values"] = n * 8 + values_tables
    row("linear_values", "lightgbm_tpu/learner/linear.py:173 "
        "(linear_leaf_values, XLA)", 0.0,
        lambda: lmod.linear_leaf_values(tree, lin, c["row_node"], c["raw"]),
        lambda: lmod.linear_leaf_values_ref(tree, lin, c["row_node"],
                                            c["raw"]), 5,
        values_bytes, 2 * n * d, indexing_walk, source="linear_leaves")
    emit("linear", rows=N_ROWS, features=N_FEATURES, valid_rows=VALID_ROWS,
         nan_share=LINEAR_NAN_SHARE, nan_features=list(LINEAR_NAN_FEATURES),
         trees=LINEAR_TREES, quantized_trees=LINEAR_QUANT_TREES,
         lambdas=list(LINEAR_LAMBDAS), binning_s=binning_s,
         seconds_per_tree=s_tree, held_out_auc=aucs, host=host,
         round_trip_max_abs=round_trip, byte_equal=byte_equal,
         fit_check={"leaves": [int(x) for x in pick],
                    "max_rel_err": fit_err, "tol": LINEAR_FIT_TOL},
         leaves_with_models=int(len(fitted)), dmax=int(c["dmax"]),
         raw_sectors=sectors, sector_floor_ms={
             k: (floor_bytes[k] + SECTOR_BYTES * v) / HBM_BYTES_PER_S * 1e3
             for k, v in sectors.items()},
         shap={"rows": SHAP_ROWS, "trees": 1, "max_sum_err": shap_err,
               "seconds": shap_s, "linear_refused": refused},
         seconds=time.perf_counter() - t_phase,
         launches={k: counts[k] for k in LINEAR_PATH})
    return counts


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
    exact_auc = check_outputs(torch, lgt, booster, ds, X)
    native_host_phase(lgt, X, y, booster)
    q_booster, counts["quantized"] = quantized_path(torch, lgt, hm, X, y, ds,
                                                    reg_ds)
    q_auc = check_outputs(torch, lgt, q_booster, ds, X, QUANT_PARAMS,
                          "train_quantized_check")
    check(abs(q_auc - exact_auc) <= 0.005,
          f"quantized held-out AUC {q_auc} vs exact {exact_auc}")
    counts["fused"], fused_rates = fused_path(torch, lgt, hm, ds, y)
    counts["valid"] = valid_path(torch, lgt, hm, ds, y)
    counts["sampling"] = sampling_path(torch, lgt, hm, X, y, ds,
                                       make_row(torch, rows), fused_rates)
    fused_configs_check(torch, lgt, X, y, ds)
    fused_scratch_check(torch, lgt, hm, X, y)
    torch.cuda.empty_cache()
    counts["backends"] = backends_path(torch, lgt, hm, X, y, ds, q_booster,
                                       booster)
    counts["constraints"] = constraints_path(torch, lgt, hm, y, ds, booster)
    counts["scan"] = scan_path(torch, lgt, hm, grow_tree_mxu, y, ds)
    counts["single_prec"] = single_prec_path(torch, lgt, hm, X, y, ds,
                                             exact_auc)
    single_prec_rows(torch, hm, hp, rng, dev, make_row(torch, rows))
    counts["monotone_methods"] = monotone_methods_path(torch, lgt, hm, X, y,
                                                       ds, exact_auc)
    counts["forced_cegb"] = forced_cegb_path(torch, lgt, hm, X, y, ds,
                                             make_row(torch, rows))
    counts["linear"] = linear_path(torch, lgt, hm, X, y,
                                   make_row(torch, rows), booster)
    del ds, reg_ds
    torch.cuda.empty_cache()
    counts["packed"] = packed_path(torch, lgt, hm, X, y)
    counts["wide_bins"] = wide_bins_path(torch, lgt, hm, hp, X, y,
                                         make_row(torch, rows), exact_auc)
    del X, y
    torch.cuda.empty_cache()
    counts["multiclass"] = multiclass_path(torch, lgt, hm, dev,
                                           make_row(torch, rows))
    counts["ranking"] = ranking_path(torch, lgt, hm, dev)
    counts["objectives"] = objectives_path(torch, lgt, hm)
    torch.cuda.empty_cache()
    counts["efb"] = efb_path(torch, lgt, hm, make_row(torch, rows))
    for path, c in counts.items():
        check(path == "scan" or all(c[k] == 0 for k in SCAN_PATH),
              f"the {path} path launched K8: the booster never asks for it")
    for r in rows:
        paths = ROW_PATH[r["name"]]
        key = ROW_KEY.get(r["name"], r["name"])
        r["launches"] = sum(counts[p][key] for p in (
            (paths,) if isinstance(paths, str) else paths))
    check(sorted(r["name"] for r in rows) == sorted(ROW_PATH),
          "the kernel table and the paths' kernels differ")
    cross_device_phase(torch, lgt, grow_tree_mxu)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
