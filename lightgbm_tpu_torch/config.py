"""Configuration system: typed parameter registry with alias resolution.

Copy of lightgbm_tpu/config.py for the PyTorch/CUDA port (the port imports
nothing of the JAX package). The registry, aliases and conflict rules are
the same; the one difference is the `device_type` default, "cuda": the
port's entry points run on the card unless the caller asks for "cpu".
Which non-default values the port can train is decided in
boosting/gbdt.py (`check_supported`), not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Config", "ParamSpec", "param_dict_to_config", "PARAM_ALIASES"]


@dataclasses.dataclass
class ParamSpec:
    name: str
    type: type
    default: Any
    aliases: Tuple[str, ...] = ()
    check: Optional[Callable[[Any], bool]] = None
    desc: str = ""


def _p(name, type_, default, aliases=(), check=None, desc=""):
    return ParamSpec(name, type_, default, tuple(aliases), check, desc)


# Registry mirrors reference include/LightGBM/config.h. Grouped as in
# docs/Parameters.rst: core, learning control, IO, objective, metric, network.
_PARAMS: List[ParamSpec] = [
    # ---- Core parameters (config.h:96-226) ----
    _p("config", str, "", ("config_file",)),
    _p("task", str, "train",
       ("task_type",),
       # "prediction"/"test" are reference-CLI spellings of "predict"
       # (application.cpp:85); cli.Application.run routes all three
       lambda v: v in ("train", "predict", "prediction", "test",
                       "convert_model", "refit", "save_binary", "serve",
                       "loop")),
    _p("objective", str, "regression",
       ("objective_type", "app", "application", "loss")),
    _p("boosting", str, "gbdt",
       ("boosting_type", "boost"),
       lambda v: v in ("gbdt", "rf", "dart", "goss")),
    _p("data", str, "", ("train", "train_data", "train_data_file", "data_filename")),
    _p("valid", str, "", ("test", "valid_data", "valid_data_file", "test_data",
                          "test_data_file", "valid_filenames")),
    _p("num_iterations", int, 100,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
        "num_rounds", "nrounds", "num_boost_round", "n_estimators",
        "max_iter")),
    _p("learning_rate", float, 0.1, ("shrinkage_rate", "eta"),
       lambda v: v > 0.0),
    _p("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf",
                               "max_leaf_nodes"),
       lambda v: 1 < v <= 131072),
    _p("tree_learner", str, "serial",
       ("tree", "tree_type", "tree_learner_type"),
       lambda v: v in ("serial", "feature", "data", "voting")),
    _p("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs")),
    _p("device_type", str, "cuda", ("device",),
       lambda v: v in ("cpu", "gpu", "cuda", "cuda_exp", "tpu")),
    _p("seed", int, 0, ("random_seed", "random_state")),
    _p("deterministic", bool, False),
    # ---- Learning control (config.h:229-680) ----
    _p("force_col_wise", bool, False),
    _p("force_row_wise", bool, False),
    _p("histogram_pool_size", float, -1.0, ("hist_pool_size",)),
    _p("max_depth", int, -1),
    _p("min_data_in_leaf", int, 20,
       ("min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf"),
       lambda v: v >= 0),
    _p("min_sum_hessian_in_leaf", float, 1e-3,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
        "min_child_weight"),
       lambda v: v >= 0.0),
    _p("bagging_fraction", float, 1.0,
       ("sub_row", "subsample", "bagging"),
       lambda v: 0.0 < v <= 1.0),
    _p("pos_bagging_fraction", float, 1.0,
       ("pos_sub_row", "pos_subsample", "pos_bagging"),
       lambda v: 0.0 < v <= 1.0),
    _p("neg_bagging_fraction", float, 1.0,
       ("neg_sub_row", "neg_subsample", "neg_bagging"),
       lambda v: 0.0 < v <= 1.0),
    _p("bagging_freq", int, 0, ("subsample_freq",)),
    _p("bagging_seed", int, 3, ("bagging_fraction_seed",)),
    _p("feature_fraction", float, 1.0,
       ("sub_feature", "colsample_bytree"), lambda v: 0.0 < v <= 1.0),
    _p("feature_fraction_bynode", float, 1.0,
       ("sub_feature_bynode", "colsample_bynode"), lambda v: 0.0 < v <= 1.0),
    _p("feature_fraction_seed", int, 2),
    _p("extra_trees", bool, False, ("extra_tree",)),
    _p("extra_seed", int, 6),
    _p("early_stopping_round", int, 0,
       ("early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    _p("first_metric_only", bool, False),
    _p("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output")),
    _p("lambda_l1", float, 0.0, ("reg_alpha", "l1_regularization"),
       lambda v: v >= 0.0),
    _p("lambda_l2", float, 0.0, ("reg_lambda", "lambda", "l2_regularization"),
       lambda v: v >= 0.0),
    _p("linear_lambda", float, 0.0, (), lambda v: v >= 0.0),
    _p("min_gain_to_split", float, 0.0, ("min_split_gain",),
       lambda v: v >= 0.0),
    _p("drop_rate", float, 0.1, ("rate_drop",), lambda v: 0.0 <= v <= 1.0),
    _p("max_drop", int, 50),
    _p("skip_drop", float, 0.5, (), lambda v: 0.0 <= v <= 1.0),
    _p("xgboost_dart_mode", bool, False),
    _p("uniform_drop", bool, False),
    _p("drop_seed", int, 4),
    _p("top_rate", float, 0.2, (), lambda v: 0.0 <= v <= 1.0),
    _p("other_rate", float, 0.1, (), lambda v: 0.0 <= v <= 1.0),
    _p("min_data_per_group", int, 100, (), lambda v: v > 0),
    _p("max_cat_threshold", int, 32, (), lambda v: v > 0),
    _p("cat_l2", float, 10.0, (), lambda v: v >= 0.0),
    _p("cat_smooth", float, 10.0, (), lambda v: v >= 0.0),
    _p("max_cat_to_onehot", int, 4, (), lambda v: v > 0),
    _p("top_k", int, 20, ("topk",), lambda v: v > 0),
    _p("monotone_constraints", list, None, ("mc", "monotone_constraint",
                                            "monotonic_cst")),
    _p("monotone_constraints_method", str, "basic",
       ("monotone_constraining_method", "mc_method"),
       lambda v: v in ("basic", "intermediate", "advanced")),
    _p("monotone_penalty", float, 0.0, ("monotone_splits_penalty",
                                        "ms_penalty", "mc_penalty"),
       lambda v: v >= 0.0),
    _p("feature_contri", list, None, ("feature_contrib", "fc", "fp",
                                      "feature_penalty")),
    _p("forcedsplits_filename", str, "", ("fs", "forced_splits_filename",
                                          "forced_splits_file", "forced_splits")),
    _p("refit_decay_rate", float, 0.9, (), lambda v: 0.0 <= v <= 1.0),
    _p("cegb_tradeoff", float, 1.0, (), lambda v: v >= 0.0),
    _p("cegb_penalty_split", float, 0.0, (), lambda v: v >= 0.0),
    _p("cegb_penalty_feature_lazy", list, None),
    _p("cegb_penalty_feature_coupled", list, None),
    _p("path_smooth", float, 0.0, (), lambda v: v >= 0.0),
    _p("interaction_constraints", list, None),
    _p("verbosity", int, 1, ("verbose",)),
    _p("input_model", str, "", ("model_input", "model_in")),
    _p("output_model", str, "LightGBM_model.txt",
       ("model_output", "model_out")),
    _p("saved_feature_importance_type", int, 0),
    _p("snapshot_freq", int, -1, ("save_period",)),
    # ---- IO / dataset (config.h:683-940) ----
    _p("max_bin", int, 255, ("max_bins",), lambda v: v > 1),
    _p("max_bin_by_feature", list, None),
    _p("min_data_in_bin", int, 3, (), lambda v: v > 0),
    _p("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",),
       lambda v: v > 0),
    _p("data_random_seed", int, 1, ("data_seed",)),
    _p("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse")),
    _p("enable_bundle", bool, True, ("is_enable_bundle", "bundle")),
    _p("use_missing", bool, True),
    _p("zero_as_missing", bool, False),
    _p("feature_pre_filter", bool, True),
    _p("pre_partition", bool, False, ("is_pre_partition",)),
    _p("two_round", bool, False, ("two_round_loading", "use_two_round_loading")),
    _p("header", bool, False, ("has_header",)),
    _p("label_column", str, "", ("label",)),
    _p("weight_column", str, "", ("weight",)),
    _p("group_column", str, "", ("group", "group_id", "query_column", "query",
                                 "query_id")),
    _p("ignore_column", str, "", ("ignore_feature", "blacklist")),
    _p("categorical_feature", str, "", ("cat_feature", "categorical_column",
                                        "cat_column")),
    _p("forcedbins_filename", str, ""),
    _p("save_binary", bool, False, ("is_save_binary", "is_save_binary_file")),
    _p("precise_float_parser", bool, False),
    # ---- Predict (config.h:943-1003) ----
    _p("start_iteration_predict", int, 0),
    _p("num_iteration_predict", int, -1),
    _p("predict_raw_score", bool, False, ("is_predict_raw_score",
                                          "predict_rawscore", "raw_score")),
    _p("predict_leaf_index", bool, False, ("is_predict_leaf_index",
                                           "leaf_index")),
    _p("predict_contrib", bool, False, ("is_predict_contrib", "contrib")),
    _p("predict_disable_shape_check", bool, False),
    _p("pred_early_stop", bool, False),
    _p("pred_early_stop_freq", int, 10),
    _p("pred_early_stop_margin", float, 10.0),
    _p("output_result", str, "LightGBM_predict_result.txt",
       ("predict_result", "prediction_result", "predict_name",
        "prediction_name", "pred_name", "name_pred")),
    # ---- Serving (lightgbm_tpu/serving/, task=serve) ----
    _p("serve_max_batch_size", int, 1024, ("max_batch_size",),
       lambda v: v > 0),
    _p("serve_max_wait_ms", float, 2.0,
       ("max_wait_ms", "batch_timeout_ms"), lambda v: v >= 0),
    _p("serve_max_queue", int, 128, ("max_queue_depth",), lambda v: v > 0),
    _p("serve_min_bucket", int, 16, ("min_bucket",), lambda v: v > 0),
    _p("serve_max_bucket", int, 1024, ("max_bucket",), lambda v: v > 0),
    _p("serve_max_models", int, 8, (), lambda v: v > 0),
    _p("serve_metrics_file", str, "", ("metrics_file",)),
    _p("serve_slo_ms", float, 0.0, ("slo_ms", "serve_deadline_ms"),
       lambda v: v >= 0,
       desc="per-request SLO budget in milliseconds: the micro-batcher "
            "sheds a request at admission when its projected queue wait "
            "exceeds the remaining budget, and expires requests still "
            "queued past their deadline. 0 (default) disables deadlines"),
    _p("serve_deadline_policy", str, "fallback", ("deadline_policy",),
       lambda v: v in ("fallback", "fail"),
       desc="what a deadline-missed request gets: 'fallback' (default) "
            "answers it via host predict and counts a deadline miss; "
            "'fail' raises DeadlineExceeded to the caller fast"),
    _p("serve_replicas", int, 1, ("num_replicas",), lambda v: v >= 0,
       desc="device replicas per served model, with least-loaded "
            "routing gated on per-replica circuit breakers; 0 means one "
            "replica per local device"),
    _p("serve_breaker_threshold", int, 3, ("breaker_threshold",),
       lambda v: v >= 1,
       desc="consecutive device-dispatch failures that open a "
            "replica's circuit breaker (traffic fails over until the "
            "cooldown's half-open probe closes it again)"),
    _p("serve_breaker_cooldown_ms", float, 250.0, ("breaker_cooldown_ms",),
       lambda v: v >= 0,
       desc="how long an open breaker refuses dispatches before "
            "granting one half-open probe; a clean probe re-closes the "
            "breaker (self-healing)"),
    _p("serve_scheduler", str, "slo", ("batch_scheduler",),
       lambda v: v in ("fifo", "slo"),
       desc="micro-batch scheduling policy: 'slo' (default, continuous "
            "batching) orders the queue by remaining deadline budget "
            "with skip-and-fill packing so small requests interleave "
            "around large ones (a starvation guard bounds reordering); "
            "'fifo' keeps strict arrival order"),
    _p("serve_pack_size", int, 8, ("pack_size",), lambda v: v >= 1,
       desc="max members per fused multi-model ForestPack loaded via "
            "Server.load_pack; more members than this split into "
            "multiple packs. Each pack answers its whole member set "
            "with one device dispatch per coalescing round"),
    # ---- Observability (lightgbm_tpu/observability/,
    #      docs/Observability.md) ----
    _p("observe", bool, False, ("observability",),
       desc="enable the unified observability registry: per-iteration "
            "training telemetry, structured spans, compile accounting "
            "and device-utilization (MFU) accounting. Off by default; "
            "the disabled path costs one branch per site"),
    _p("observe_ring", int, 4096, (), lambda v: v >= 16,
       desc="ring-buffer capacity for buffered spans and per-iteration "
            "telemetry records (oldest evicted; aggregates unaffected)"),
    _p("observe_norms", bool, False, (),
       desc="also record per-iteration gradient/hessian norms and "
            "leaves grown. These force a host sync per iteration — "
            "diagnostic posture, not benchmarking. Implies observe"),
    _p("observe_trace_file", str, "", ("trace_file",),
       desc="write the span trace here after training: .jsonl for "
            "JSON-lines, anything else for Chrome/Perfetto trace_event "
            "JSON (chrome://tracing, ui.perfetto.dev). Implies observe"),
    _p("observe_metrics_port", int, 0, ("metrics_port",), lambda v: v >= 0,
       desc="serve Prometheus text-format metrics on this localhost "
            "port during task=train or task=serve (0 = off; serving "
            "picks an ephemeral port when 0 and observe is on)"),
    _p("profile_spans", str, "", (),
       desc="comma-separated fnmatch globs of span names to bracket "
            "with a jax.profiler device trace (e.g. "
            "'pipeline_block,sharded_grow'). Empty (default) disables "
            "device capture; degrades to a logged no-op where the "
            "profiler is unavailable. Implies observe"),
    _p("profile_dir", str, "", (),
       desc="directory for device-profiler captures (one subdirectory "
            "per capture); defaults to ./jax_profile when profile_spans "
            "is set"),
    _p("profile_max_captures", int, 4, (), lambda v: v >= 1,
       desc="hard budget of device-profiler captures per process — a "
            "long run collects a handful of representative windows "
            "instead of gigabytes"),
    _p("flightrec", bool, True, ("flight_recorder",),
       desc="crash flight recorder: keep a bounded ring of recent "
            "spans, collective brackets, fault hits and guard trips, "
            "flushed as postmortem_<rank>.json on watchdog abort, "
            "injected rank death, non-finite guard trips and unhandled "
            "training exceptions. Always on (even with observe=false); "
            "the ring costs one dict append per recorded event"),
    _p("flightrec_ring", int, 256, (), lambda v: v >= 16,
       desc="flight-recorder ring capacity (recent events retained for "
            "the post-mortem bundle; oldest evicted)"),
    _p("flightrec_dir", str, "", (),
       desc="directory for postmortem_<rank>.json bundles; defaults to "
            "checkpoint_dir when set (shared storage in a multihost "
            "run), else the working directory on fatal flushes only"),
    # ---- Reliability (lightgbm_tpu/reliability/, docs/Reliability.md) ----
    _p("checkpoint_period", int, 0, ("checkpoint_freq", "snapshot_period"),
       lambda v: v >= 0),
    _p("checkpoint_dir", str, "", ("checkpoint_path",)),
    _p("checkpoint_keep", int, 3, ("checkpoint_keep_last",
                                   "keep_last_checkpoints"),
       lambda v: v >= 1),
    _p("guard_nonfinite", str, "off", ("guard_policy", "nonfinite_policy"),
       lambda v: v in ("off", "warn", "skip_iteration", "rollback", "raise")),
    _p("retry_max_attempts", int, 3, ("device_retry_attempts",),
       lambda v: v >= 1),
    _p("retry_backoff_ms", float, 50.0, ("retry_base_backoff_ms",),
       lambda v: v >= 0),
    _p("retry_backoff_max_ms", float, 2000.0, (), lambda v: v >= 0),
    _p("collective_timeout_s", float, 0.0, ("collective_deadline_s",),
       lambda v: v >= 0,
       desc="collective-watchdog deadline: a multihost run whose "
            "host-boundary collective (allgather, sharded growth psum) "
            "blocks longer than this aborts the local process with a "
            "'rank k last seen Ns ago' diagnostic instead of hanging "
            "forever on a dead peer. 0 (default) disables the watchdog; "
            "it is always off on a single machine. The first collective "
            "of each kind gets 4x this deadline to absorb XLA "
            "compilation (docs/Reliability.md)"),
    _p("heartbeat_interval_s", float, 1.0, (), lambda v: v > 0,
       desc="how often each rank stamps its liveness file while the "
            "collective watchdog is armed; a peer is reported stale "
            "after ~3 missed intervals"),
    _p("heartbeat_dir", str, "", (),
       desc="shared directory for the watchdog's per-rank heartbeat "
            "files; defaults to <checkpoint_dir>/heartbeats when a "
            "checkpoint_dir is set, else heartbeat diagnosis is "
            "disabled (deadline aborts still fire, unnamed)"),
    _p("elastic_resize", bool, False, (),
       desc="when the collective watchdog names a dead rank, survivors "
            "vote a mesh shrink through the heartbeat directory, commit "
            "a new membership epoch, and exit for reincarnation at the "
            "smaller world instead of aborting (exit 75, not 113); the "
            "relaunched ranks re-shard rows from the epoch checkpoint "
            "and finish the run (docs/Distributed.md Elasticity). "
            "Default false preserves the abort-on-death behavior "
            "bit-for-bit. Requires heartbeat_dir (or checkpoint_dir) "
            "and a supervisor that relaunches on exit code 75"),
    _p("elastic_min_world", int, 1, (), lambda v: v >= 1,
       desc="smallest world size an elastic shrink may commit; a "
            "failure that would leave fewer survivors falls back to "
            "the watchdog abort so the supervisor can restart the full "
            "fleet instead of limping on too few chips"),
    _p("elastic_epoch_timeout_s", float, 30.0, (), lambda v: v >= 0,
       desc="how long a survivor waits for all peers' shrink proposals "
            "to agree before giving up on the vote and falling back to "
            "the watchdog abort"),
    _p("checkpoint_coordinated", bool, True, (),
       desc="multihost checkpointing runs the coordinated commit "
            "protocol (iteration agreement, per-rank shards, COMMIT "
            "marker — docs/Reliability.md). Disable to fall back to "
            "rank-independent single-host bundles (not resumable "
            "across ranks)"),
    # ---- Convert (config.h:1006-1020) ----
    _p("convert_model_language", str, ""),
    _p("convert_model", str, "gbdt_prediction.cpp",
       ("convert_model_file",)),
    # ---- Objective (config.h:1023-1130) ----
    _p("num_class", int, 1, ("num_classes",), lambda v: v > 0),
    _p("is_unbalance", bool, False, ("unbalance", "unbalanced_sets")),
    _p("scale_pos_weight", float, 1.0, (), lambda v: v > 0.0),
    _p("sigmoid", float, 1.0, (), lambda v: v > 0.0),
    _p("boost_from_average", bool, True),
    _p("reg_sqrt", bool, False),
    _p("alpha", float, 0.9, (), lambda v: v > 0.0),
    _p("fair_c", float, 1.0, (), lambda v: v > 0.0),
    _p("poisson_max_delta_step", float, 0.7, (), lambda v: v > 0.0),
    _p("tweedie_variance_power", float, 1.5, (), lambda v: 1.0 <= v < 2.0),
    _p("lambdarank_truncation_level", int, 30, (), lambda v: v > 0),
    _p("lambdarank_norm", bool, True),
    _p("label_gain", list, None),
    _p("linear_tree", bool, False, ("linear_trees",)),
    # ---- Metric (config.h:1133-1174) ----
    _p("metric", str, "", ("metrics", "metric_types")),
    _p("metric_freq", int, 1, ("output_freq",), lambda v: v > 0),
    _p("is_provide_training_metric", bool, False,
       ("training_metric", "is_training_metric", "train_metric")),
    _p("eval_at", list, None, ("ndcg_eval_at", "ndcg_at", "map_eval_at",
                               "map_at")),
    _p("multi_error_top_k", int, 1, (), lambda v: v > 0),
    _p("auc_mu_weights", list, None),
    # ---- Network (config.h:1177-1210) ----
    _p("num_machines", int, 1, ("num_machine",), lambda v: v > 0),
    _p("local_listen_port", int, 12400, ("local_port", "port"),
       lambda v: v > 0),
    _p("time_out", int, 120, (), lambda v: v > 0),
    _p("machine_list_filename", str, "", ("machine_list_file", "machine_list",
                                          "mlist")),
    _p("machines", str, "", ("workers", "nodes")),
    # ---- TPU-specific (new; no reference analog) ----
    _p("num_devices", int, 0, (),
       desc="devices in the mesh; 0 = use all visible"),
    _p("distributed_hist_agg", str, "auto", (),
       lambda v: v in ("auto", "psum", "reduce_scatter"),
       "histogram merge for the data/voting tree learners: "
       "'reduce_scatter' gives each device a feature shard of the global "
       "histogram (the reference Reduce-Scatter, "
       "data_parallel_tree_learner.cpp:184-233; O(S*F*B/world) memory "
       "per device), 'psum' replicates the full histogram (the seed "
       "Allreduce). 'auto' picks reduce_scatter wherever it is exact "
       "(single-process data/voting without EFB or rescanning monotone "
       "methods) and psum elsewhere; see distributed/crossbar.py"),
    _p("hist_dtype", str, "float32", (),
       lambda v: v in ("float32", "bfloat16"),
       "accumulation dtype for histograms"),
    _p("growth_passes_per_tree", int, 0, (),
       desc="max frontier passes per tree; 0 = auto from num_leaves/max_depth"),
    _p("use_pallas", bool, True, (),
       desc="use Pallas histogram kernel on TPU when applicable"),
    _p("gpu_use_dp", bool, True, ("hist_double_prec",),
       desc="double-bf16 (~f32) histogram sums on the MXU path. false "
            "keeps gradient sums exact but sums hessians in single bf16 "
            "(~1.3x faster, small AUC cost); unlike the reference GPU "
            "backend (f32 when false) bf16 is coarser, so the default "
            "here is true"),
    _p("hist_subtraction", bool, True, (),
       desc="sibling-histogram subtraction on the TPU grower (reference "
            "serial_tree_learner.cpp:311-326): build only the smaller "
            "child's histogram, derive the larger as parent minus smaller "
            "(~half the kernel slots per pass). false rebuilds every "
            "child's histogram from rows"),
    _p("growth_overshoot", float, 2.0, (),
       lambda v: v == 0.0 or v >= 1.0,
       "overgrow-and-prune on the batched TPU grower: grow toward "
       "overshoot*num_leaves leaves with unthrottled passes, then replay "
       "the reference's exact best-first selection over the recorded "
       "gains and prune (serial_tree_learner.cpp:159). Exact leaf-wise "
       "trees when the overshoot covers every best-first pick (~3x is "
       "ample). 0 = off (tail_split_cap hybrid growth instead)"),
    _p("growth_bridge_gate", float, 0.0, (),
       lambda v: 0.0 <= v <= 1.0,
       "overgrow-and-prune early-exit: skip the full-capacity bridge "
       "pass and fixup sweeps when the doubling schedule already grew "
       "at least this fraction of overshoot*num_leaves leaves (0 = "
       "always chase the full overshoot). The bridge is an s_max-wide "
       "histogram sweep (~65 ms at the Higgs bench shape) that runs "
       "exactly for the mid/late-boosting trees whose throttled last "
       "pass under-commits; 0.93 measured +6% throughput for ~2.4e-4 "
       "AUC@115 (docs/PerfNotes.md round 4)"),
    _p("tail_split_cap", int, 8, (), lambda v: v >= 0,
       "hybrid growth throttle for the batched TPU grower: once fewer "
       "leaves remain than splittable candidates, commit at most this "
       "many splits per pass before re-ranking (approaches the "
       "reference's strict best-first order, serial_tree_learner.cpp:159, "
       "as the cap shrinks). 0 = unthrottled batched growth"),
    _p("efb_use_mxu", bool, False, (),
       desc="route EFB-bundled training through the MXU growth path: "
            "bundle-space histogram kernels, the segmented bundle-space "
            "split scan (split_bundled.py), and bundle-range routing. "
            "Parity-tested, but the portable scatter grower measured "
            "FASTER on every bundled shape tried (docs/PerfNotes.md "
            "round 4: bundling is exactly the transformation that makes "
            "scatter updates cheap, while the one-hot-matmul histogram "
            "still pays per padded lane) — so bundled data defaults to "
            "the portable grower"),
    _p("efb_segmented_scan", bool, True, (),
       desc="scan bundled histograms directly per sub-feature segment "
            "([S, Fb, Bb] stays bundle-sized; split_bundled.py). false "
            "reverts to per-pass expansion to original features "
            "(efb.expand_histograms) — slower at wide F, kept as the "
            "parity baseline"),
    _p("bin_pack_4bit", bool, True, ("four_bit_bins",),
       desc="store the device bin matrix two-features-per-byte when "
            "every feature fits 4 bits (max_bin <= 15; the reference's "
            "4-bit DenseBin, src/io/dense_bin.hpp:42). Kernels unpack "
            "nibbles in VMEM — halves bin-matrix HBM with identical "
            "trees. Serial MXU growth path only"),
    _p("use_quantized_grad", bool, False, ("quantized_grad",),
       desc="stochastically-rounded integer gradients/hessians for the "
            "MXU histogram kernels (3 channels instead of 5, ~1.5x "
            "faster); leaf values are refit exactly afterwards, so "
            "quantization only perturbs the split search"),
    _p("hist_backend", str, "auto", (),
       lambda v: v in ("auto", "mxu", "pallas", "scatter"),
       "histogram kernel for the serial MXU growth path: 'mxu' = "
       "one-hot x MXU matmul (histogram_mxu.py), 'pallas' = "
       "slot-grouped scatter-accumulate kernel (histogram_pallas.py; "
       "per-row cost independent of frontier width), 'scatter' = "
       "pure-XLA segment sums (the parity oracle). 'auto' runs a "
       "one-shot on-device autotune of mxu vs pallas and pins the "
       "winner for the run (quantized posture only — there the "
       "backends are bit-identical, so the choice is byte-neutral on "
       "model.txt; exact mode pins mxu). The decision and per-backend "
       "timings land in observability and the bench JSON"),
    _p("hist_autotune", bool, True, (),
       desc="allow hist_backend='auto' to time both kernels on device "
            "before pinning one; false pins mxu without measuring "
            "(deterministic startup, e.g. for profiling runs)"),
    _p("partition_impl", str, "auto", (),
       lambda v: v in ("auto", "argsort", "scan"),
       "row-partitioning algorithm behind the slot-grouped scatter "
       "kernel (histogram_pallas.py partition_rows). Accepted for the "
       "JAX package's configs: every value runs the one stable "
       "partition (a counting-sort kernel on the card, a stable sort "
       "on the CPU), which gives the slot-contiguous block layout both "
       "of that package's algorithms give, so the choice is "
       "byte-neutral on model.txt"),
    _p("level_pipeline", bool, False, (),
       desc="stage-dispatched tree growth (learner/grower_pipeline.py): "
            "each doubling-schedule pass, the bridge and speculative "
            "fixup chunks run as separate async dispatches so level "
            "k+1's histogram build is enqueued before level k's "
            "bookkeeping is host-visible, and the host regains a "
            "per-level observation point (the level_pipeline trace "
            "span). Byte-identical models to the default monolithic "
            "one-dispatch-per-tree grower, which stays the parity "
            "oracle and remains the right shape for remoted "
            "accelerators where every dispatch pays a tunnel "
            "round-trip. Serial MXU growth only: the sharded grower "
            "and the fused multi-tree scan ignore it"),
    _p("level_pipeline_lookahead", int, 4, (), lambda v: v >= 1,
       "speculative fixup stages enqueued per chunk before the "
       "level-pipelined grower consults the previous chunk's "
       "(already in flight) done flag. Larger values keep the device "
       "busier past the done boundary at the cost of more identity "
       "no-op dispatches on early-finishing trees"),
    _p("fused_block_size", int, 10, (), lambda v: v >= 1,
       "iterations per fused on-device dispatch in engine.train when "
       "the config is fused-eligible (boosting/fused.py). Metrics, "
       "callbacks, and early stopping still run for EVERY iteration — "
       "valid scores come from the block's per-iteration trajectory, "
       "and an early stop mid-block rolls the extra trees back — so "
       "results match per-iteration training exactly; the win is one "
       "host round-trip per block instead of per tree. 1 = dispatch "
       "per iteration (the reference's cadence, gbdt.cpp:371)"),
    _p("pipeline", bool, True, ("pipelined_training",),
       desc="double-buffered training executor (pipeline/executor.py) "
            "when block dispatch is active (fused_block_size > 1 and "
            "the run is fused-eligible): block k+1 is dispatched "
            "asynchronously while the host unpacks block k's trees and "
            "runs its callbacks, syncing only at early-stop decisions. "
            "Bit-identical models to pipeline=false — the non-pipelined "
            "block path stays available as the parity oracle"),
    _p("pipeline_device_eval", bool, True, (),
       desc="compute valid-set metrics in-graph over the block's score "
            "trajectory (pipeline/device_eval.py), so early stopping "
            "reads one [block, n_metrics] array per dispatch instead of "
            "pulling full per-iteration score matrices to the host. "
            "Engages only when every metric on every valid set has a "
            "device kernel (pointwise families + multiclass "
            "logloss/error); ranking-style metrics (auc, ndcg, map) "
            "fall back to host evaluation for the whole run. Device "
            "metric values are f32 while host evaluation is f64, so "
            "logged metric VALUES may differ in the last digits; split "
            "decisions, scores and models are unaffected"),
    _p("pipeline_adaptive_blocks", bool, True, (),
       desc="let the pipelined executor grow the per-dispatch block "
            "size from the measured steady-state training rate "
            "(pipeline/scheduler.py) instead of using fused_block_size "
            "for every block, targeting pipeline_target_block_ms per "
            "dispatch and never crossing an early_stopping_rounds "
            "boundary. Block partitioning cannot change the trained "
            "model (the fused scan is iteration-exact), only dispatch "
            "cadence"),
    _p("pipeline_target_block_ms", float, 250.0, (), lambda v: v > 0,
       "steady-state device time the adaptive scheduler aims to keep "
       "in flight per dispatch. Larger blocks amortize more host "
       "round-trips but coarsen the early-stop sync cadence"),
    _p("pipeline_max_block", int, 200, (), lambda v: v >= 1,
       "upper bound on the adaptive scheduler's block size, whatever "
       "the measured rate suggests"),
    _p("stream_input", bool, False, ("streaming_input",),
       desc="two-pass out-of-core ingestion (docs/Streaming.md): pass 1 "
            "streams chunks from the source into a per-feature reservoir "
            "sketch that freezes the bin boundaries, pass 2 re-streams "
            "and quantizes each chunk into the bin matrix, overlapping "
            "the next chunk's parse with the current chunk's binning. "
            "The raw [N, F] float matrix never materializes: peak host "
            "memory is one chunk + the sketch + the uint8/16 bin matrix. "
            "On the CLI, task=train data=<file.csv|.npy> streams the "
            "file instead of loading it"),
    _p("stream_chunk_rows", int, 65536, ("stream_batch_rows",),
       lambda v: v >= 1,
       "rows per streamed chunk: the unit of parse/bin overlap and the "
       "peak raw-row materialization during ingestion"),
    _p("stream_sample_rows", int, 200000, ("stream_sketch_rows",),
       lambda v: v >= 1,
       "capacity of the pass-1 reservoir sketch (rows). When it covers "
       "the whole stream the sketch holds every row in order and the "
       "frozen boundaries are bit-identical to in-memory binning; below "
       "that, boundaries come from a uniform row sample "
       "(docs/Streaming.md error envelope)"),
    _p("stream_bin_parity", bool, False, (),
       desc="require exact-parity streamed binning: fail ingestion if "
            "the reservoir sample did not cover every row (i.e. "
            "stream_sample_rows < N), instead of silently accepting "
            "sample-based boundaries"),
    # ---- Continuous train->refresh->serve loop (docs/Continuous.md) ----
    _p("loop_dir", str, "", ("loop_state_dir",),
       desc="state root of task=loop (continuous/trainer.py): the "
            "GENERATION marker, the gens/ bundle history, the work/ "
            "per-cycle scratch (stream state + mid-train checkpoints) "
            "and the postmortems/ flight-recorder bundles all live "
            "under it. Required for task=loop — the loop's whole "
            "crash-survivability story is this directory"),
    _p("loop_rounds", int, 10, ("loop_num_iterations",), lambda v: v >= 1,
       "boosting iterations added per refresh cycle (the per-window "
       "continuation budget, NOT a total)"),
    _p("loop_window_chunks", int, 1, (), lambda v: v >= 1,
       "stream chunks consumed per refresh window: each cycle trains on "
       "WindowSource(base, cursor, loop_window_chunks) and advances the "
       "cursor by that many chunks on publish"),
    _p("loop_windows", int, 0, (), lambda v: v >= 0,
       "maximum refresh cycles before the loop exits (0 = run until the "
       "source is exhausted)"),
    _p("loop_keep", int, 3, (), lambda v: v >= 1,
       "generation bundles retained under <loop_dir>/gens; the bundle "
       "the live generation was published from is pinned and survives "
       "this quota (reliability/checkpoint.py pin_bundle)"),
    _p("loop_poison_retries", int, 3, (), lambda v: v >= 1,
       "crash-loop budget per window: a window whose cycle fails this "
       "many consecutive attempts is quarantined — skipped, logged, "
       "counted in lightgbm_tpu_freshness_quarantined_windows — instead "
       "of wedging the loop forever"),
    _p("loop_backoff_ms", float, 50.0, (), lambda v: v >= 0,
       "base of the capped exponential backoff between failed cycle "
       "attempts (reliability/backoff.py); 0 disables the sleep"),
    _p("loop_backoff_max_ms", float, 2000.0, (), lambda v: v >= 0,
       "cap of the inter-attempt backoff"),
    _p("loop_freshness_slo_s", float, 0.0, (), lambda v: v >= 0,
       "staleness budget for the freshness watchdog: when the "
       "data-to-serving latency of a publish exceeds it, the "
       "lightgbm_tpu_freshness_slo_alarm gauge latches 1 (0 disables "
       "the alarm; the latency metric itself is always recorded)"),
    _p("loop_model_name", str, "live", (),
       desc="registry name the loop publishes refreshed generations "
            "under (Server.load_model first, Server.hot_swap after)"),
]

_SPEC_BY_NAME: Dict[str, ParamSpec] = {p.name: p for p in _PARAMS}

# alias -> canonical name (reference: src/io/config_auto.cpp:10 alias_table)
PARAM_ALIASES: Dict[str, str] = {}
for _spec in _PARAMS:
    for _a in _spec.aliases:
        PARAM_ALIASES[_a] = _spec.name


def _coerce(spec: ParamSpec, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the spec's type."""
    if value is None:
        return None
    if spec.type is bool:
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "+", "t", "on")
        return bool(value)
    if spec.type is int:
        return int(float(value)) if isinstance(value, str) else int(value)
    if spec.type is float:
        return float(value)
    if spec.type is list:
        if isinstance(value, str):
            if not value:
                return None
            parts = [v for v in value.replace(";", ",").split(",") if v != ""]
            out = []
            for x in parts:
                try:
                    out.append(int(x))
                except ValueError:
                    try:
                        out.append(float(x))
                    except ValueError:
                        out.append(x)
            return out
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    if spec.type is str:
        return str(value)
    return value


class Config:
    """Resolved parameter set. Attribute access for every registered param."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        for spec in _PARAMS:
            setattr(self, spec.name, spec.default)
        self.raw_params: Dict[str, Any] = {}
        if params:
            self.update(params)

    def update(self, params: Dict[str, Any]) -> "Config":
        canon: Dict[str, Any] = {}
        for key, value in params.items():
            name = PARAM_ALIASES.get(key, key)
            if name in canon and canon[name] != value:
                # first occurrence wins among aliases, like reference
                # Config::SetMembersFromMap keeping canonical precedence
                continue
            canon[name] = value
        for name, value in canon.items():
            spec = _SPEC_BY_NAME.get(name)
            if spec is None:
                # unknown params are kept (custom objective extras etc.)
                self.raw_params[name] = value
                continue
            coerced = _coerce(spec, value)
            if spec.check is not None and coerced is not None \
                    and not spec.check(coerced):
                raise ValueError(
                    f"Invalid value {value!r} for parameter {name!r}")
            setattr(self, name, coerced)
            self.raw_params[name] = value
        self._resolve_conflicts()
        return self

    # reference: src/io/config.cpp:261 CheckParamConflict
    def _resolve_conflicts(self) -> None:
        if self.is_parallel and self.bagging_freq > 0 and \
                self.bagging_fraction < 1.0 and self.tree_learner == "feature":
            # feature-parallel shares all rows; bagging must be synchronized
            pass
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0:
                self.bagging_freq = max(self.bagging_freq, 1)
                self.bagging_fraction = min(self.bagging_fraction, 0.9)
        if self.boosting == "goss":
            # GOSS replaces bagging
            self.bagging_freq = 0
            self.bagging_fraction = 1.0
        if self.max_depth > 0:
            # cap num_leaves by full tree at max_depth
            full = 1 << min(self.max_depth, 30)
            if self.num_leaves > full:
                self.num_leaves = full
        if self.checkpoint_period > 0 and not self.checkpoint_dir:
            from .utils.log import Log
            Log.warning(
                "checkpoint_period > 0 needs checkpoint_dir; "
                "checkpointing disabled")
            self.checkpoint_period = 0
        if self.collective_timeout_s > 0 and self.num_machines <= 1:
            # not an error: the same config file may serve both the
            # launcher and a local smoke run — but say clearly that the
            # watchdog only arms with real peers
            from .utils.log import Log
            Log.warning(
                "collective_timeout_s is set but num_machines <= 1; "
                "the collective watchdog only arms on multihost runs")
        if (self.observe_trace_file or self.observe_norms or
                self.observe_metrics_port > 0 or
                self.profile_spans) and not self.observe:
            # asking for an observability output implies observing
            self.observe = True
        if self.serve_max_bucket < self.serve_min_bucket:
            from .utils.log import Log
            Log.warning(
                "serve_max_bucket < serve_min_bucket; raising "
                "serve_max_bucket to %d", self.serve_min_bucket)
            self.serve_max_bucket = self.serve_min_bucket
        if self.num_machines > 1 and self.tree_learner == "serial":
            # reference config.cpp:293-299: serial learner forces
            # single-machine (theirs is silent; warn so nobody believes
            # N independent per-partition models are one model)
            from .utils.log import Log
            Log.warning(
                "num_machines > 1 requires a parallel tree_learner "
                "(data/feature/voting); forcing num_machines=1")
            self.num_machines = 1
        requested_mc_method = self.monotone_constraints_method
        if self.monotone_constraints is not None and \
                requested_mc_method in ("intermediate", "advanced"):
            # the reference downgrades these for ALL distributed modes
            # (config.cpp:381-384: local nodes lack full histograms);
            # here data/feature-parallel scans see globally merged
            # histograms, so only voting (partial aggregation) cannot
            # support the rescan
            if self.tree_learner == "voting":
                from .utils.log import Log
                Log.warning(
                    "Cannot use %r monotone constraints with the voting "
                    "tree learner, auto set to \"basic\" method.",
                    requested_mc_method)
                self.monotone_constraints_method = "basic"
            if self.feature_fraction_bynode != 1.0 and \
                    self.monotone_constraints_method != "basic":
                # reference config.cpp:386-390: by-node sampling would
                # resample on every recompute-triggered re-find
                from .utils.log import Log
                Log.warning(
                    "Cannot use %r monotone constraints with "
                    "feature_fraction_bynode != 1, auto set to \"basic\" "
                    "method.", requested_mc_method)
                self.monotone_constraints_method = "basic"
        if self.linear_tree and self.boosting == "goss":
            raise ValueError("linear_tree is not supported with goss boosting")
        if self.linear_tree:
            # reference conflicts (config.cpp:357-371): serial learner only,
            # no zero_as_missing, no L1 regression
            if self.tree_learner != "serial":
                from .utils.log import Log
                Log.warning("Linear tree learner must be serial; "
                            "tree_learner=%s ignored", self.tree_learner)
                self.tree_learner = "serial"
            if self.zero_as_missing:
                raise ValueError("zero_as_missing must be false when "
                                 "fitting linear trees")
            if self.objective in ("regression_l1", "l1", "mae",
                                  "mean_absolute_error"):
                raise ValueError("Cannot use regression_l1 objective when "
                                 "fitting linear trees")

    @property
    def is_parallel(self) -> bool:
        return self.tree_learner != "serial" or self.num_machines > 1

    @property
    def is_data_based_parallel(self) -> bool:
        return self.tree_learner in ("data", "voting")

    @property
    def max_nodes(self) -> int:
        return 2 * self.num_leaves - 1

    def metric_list(self) -> List[str]:
        if not self.metric:
            return []
        if isinstance(self.metric, (list, tuple)):
            return list(self.metric)
        return [m for m in str(self.metric).replace(";", ",").split(",") if m]

    def to_dict(self) -> Dict[str, Any]:
        return {p.name: getattr(self, p.name) for p in _PARAMS}

    def __repr__(self) -> str:
        mods = {k: v for k, v in self.to_dict().items()
                if v != _SPEC_BY_NAME[k].default}
        return f"Config({mods})"


def param_dict_to_config(params: Optional[Dict[str, Any]]) -> Config:
    return Config(params or {})


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse `key=value` lines; '#' starts a comment.

    Reference: Application ctor config-file parsing (application.cpp:50-83).
    """
    out: Dict[str, str] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            out[key.strip()] = value.strip()
    return out
