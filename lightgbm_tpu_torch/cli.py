"""Command-line application (reference src/application/, src/main.cpp).

The port's copy of lightgbm_tpu/cli.py, with the reference CLI's
invocation contract:

    python -m lightgbm_tpu_torch.cli config=train.conf [key=value ...]

Tasks train, predict, refit, save_binary, convert_model
(application.cpp:85-269) and serve (a request file through the serving
engine, `serving.Server`, on the card unless device_type=cpu);
`key=value` config files ('#' comments, the command line overriding the
file, application.cpp:50-83). Training runs
through engine.train on the card unless device_type=cpu is given. Text
data: CSV, TSV (tab-separated when the first line holds a tab) or LibSVM,
the label in column `label_column` (default 0), a `header` line skipped;
a local file is parsed by the native runtime (cext.parse_delimited), a
URI through utils/file_io.open_file and np.loadtxt; `<data>.query` or
`<data>.group` and `<data>.weight` side files are read when present.
`snapshot_freq` saves `<output_model>.snapshot_iter_<n>`;
`observe_metrics_port` serves the registry's Prometheus text while
training and `observe_trace_file` gets the span trace after it; the
flight recorder is armed as soon as the config is read and flushes a
post-mortem bundle on an exception. Task loop waits for the streaming
and continuous modules (ROADMAP A11 part 2), as does stream_input, and
num_machines > 1 for the distributed learners (A10): they raise.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .boosting.gbdt import check_supported
from .callback import log_evaluation
from .config import Config, parse_config_file
from .data import BinnedDataset
from .engine import train as train_fn
from .utils.file_io import _scheme_of, open_file
from .utils.log import LightGBMError, Log

__all__ = ["main", "Application"]


def _parse_argv(argv: List[str]) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            Log.warning("Unknown CLI argument %s (expected key=value)", arg)
            continue
        key, value = arg.split("=", 1)
        params[key.strip()] = value.strip()
    file_params: Dict[str, str] = {}
    if "config" in params or "config_file" in params:
        path = params.get("config") or params.get("config_file")
        file_params = parse_config_file(path)
    # the command line overrides the config file (application.cpp:75-80)
    file_params.update(params)
    return file_params


def _load_text_data(path: str, cfg: Config):
    """(X, y) of a CSV/TSV/LibSVM file (reference Parser auto-detection,
    src/io/parser.cpp): the label in column `label_column` (default 0),
    `header` skipping the first line."""
    with open_file(path) as fh:
        first = fh.readline().strip()
    if ":" in first.split(" ")[-1] and "," not in first:
        # LibSVM: label idx:val idx:val ...
        return _load_libsvm(path)
    delim = "\t" if "\t" in first else ","
    skip = 1 if cfg.header else 0
    from . import cext
    # the native parser reads local files; a URI goes through open_file
    data = None if _scheme_of(path) else \
        cext.parse_delimited(path, delim, skip)
    if data is None:
        with open_file(path) as fh:
            data = np.loadtxt(fh, delimiter=delim, skiprows=skip, ndmin=2)
    label_col = 0
    if cfg.label_column.startswith("name:"):
        Log.fatal("label_column=name: requires header parsing; use index")
    elif cfg.label_column:
        label_col = int(cfg.label_column)
    y = data[:, label_col].astype(np.float32)
    X = np.delete(data, label_col, axis=1)
    return X, y


def _load_libsvm(path: str):
    rows = []
    labels = []
    max_idx = -1
    with open_file(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                i, v = tok.split(":")
                feats[int(i)] = float(v)
                max_idx = max(max_idx, int(i))
            rows.append(feats)
    X = np.zeros((len(rows), max_idx + 1))
    for r, feats in enumerate(rows):
        for i, v in feats.items():
            X[r, i] = v
    return X, np.asarray(labels, np.float32)


def _maybe_load_group(data_path: str) -> Optional[np.ndarray]:
    """The reference's <data>.query / <data>.group side files."""
    for ext in (".query", ".group"):
        p = data_path + ext
        if os.path.exists(p):
            return np.loadtxt(p, dtype=np.int64, ndmin=1)
    return None


def _maybe_load_weight(data_path: str) -> Optional[np.ndarray]:
    p = data_path + ".weight"
    if os.path.exists(p):
        return np.loadtxt(p, dtype=np.float32, ndmin=1)
    return None


class Application:
    """Task dispatcher (reference application.cpp:31-269)."""

    def __init__(self, argv: List[str]):
        self.params = _parse_argv(argv)
        self.config = Config(self.params)
        Log.set_verbosity(self.config.verbosity)
        # the flight recorder is armed as soon as the config exists: a
        # failure before any Booster is built (a bad data path) still
        # leaves its bundle in flightrec_dir
        from .observability import configure_from_config
        configure_from_config(self.config)

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            # before any data work, as the reference's Network::Init at
            # the start of InitTrain (application.cpp:165)
            check_supported(self.config)
            self.train()
        elif task in ("predict", "prediction", "test"):
            self.predict()
        elif task == "refit":
            self.refit()
        elif task == "convert_model":
            self.convert_model()
        elif task == "save_binary":
            self.save_binary()
        elif task == "serve":
            self.serve()
        elif task == "loop":
            raise LightGBMError(
                "task=loop is not ported to lightgbm_tpu_torch yet: it "
                "needs the streaming and continuous modules (ROADMAP.md "
                "port queue A11 part 2)")
        else:
            Log.fatal("Unknown task %s", task)

    # ------------------------------------------------------------------
    def _load_train_dataset(self) -> Dataset:
        cfg = self.config
        if BinnedDataset.is_binary_file(cfg.data):
            return Dataset(cfg.data, params=dict(self.params))
        if cfg.stream_input:
            raise LightGBMError(
                "stream_input is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP.md port queue A11 part 2)")
        X, y = _load_text_data(cfg.data, cfg)
        return Dataset(X, label=y, group=_maybe_load_group(cfg.data),
                       weight=_maybe_load_weight(cfg.data),
                       params=dict(self.params))

    def train(self) -> None:
        cfg = self.config
        if not cfg.data:
            Log.fatal("No training data: set data=<file>")
        dtrain = self._load_train_dataset()
        valid_sets, valid_names = [], []
        if cfg.valid:
            for i, vpath in enumerate(str(cfg.valid).split(",")):
                vX, vy = _load_text_data(vpath, cfg)
                valid_sets.append(Dataset(vX, label=vy,
                                          group=_maybe_load_group(vpath),
                                          reference=dtrain))
                valid_names.append(f"valid_{i + 1}")
        callbacks = [log_evaluation(cfg.metric_freq)]
        if cfg.snapshot_freq > 0:
            # model snapshots every snapshot_freq iterations (reference
            # gbdt.cpp:279-283: "snapshot_iter_<n>")
            out_model = cfg.output_model

            def _snapshot(env):
                it = env.iteration + 1
                if it % cfg.snapshot_freq == 0:
                    path = f"{out_model}.snapshot_iter_{it}"
                    env.model.save_model(path)
                    Log.info("Saved snapshot to %s", path)

            callbacks.append(_snapshot)
        init_model = cfg.input_model if cfg.input_model else None
        resume_from = None
        if cfg.checkpoint_period > 0 and cfg.checkpoint_dir:
            # a killed task=train run rerun with the same config resumes
            # at its last checkpoint; engine.train adds the periodic
            # checkpoint callback itself
            from .reliability.checkpoint import latest_checkpoint
            found = latest_checkpoint(cfg.checkpoint_dir)
            if found is not None:
                resume_from = found
                init_model = None
                Log.info("Auto-resuming from checkpoint %s", found)
        msrv = None
        if cfg.observe and cfg.observe_metrics_port > 0:
            # a live Prometheus scrape surface for the run
            from .observability import MetricsHTTPServer, registry
            msrv = MetricsHTTPServer(registry.prometheus_text,
                                     registry.snapshot,
                                     port=cfg.observe_metrics_port)
            Log.info("observability metrics at %s", msrv.url)
        try:
            booster = train_fn(dict(self.params), dtrain,
                               num_boost_round=cfg.num_iterations,
                               valid_sets=valid_sets or None,
                               valid_names=valid_names or None,
                               callbacks=callbacks,
                               init_model=init_model,
                               resume_from=resume_from)
        finally:
            if msrv is not None:
                msrv.close()
        stats = booster.gbdt._pipeline_stats
        if stats is not None and stats.blocks:
            Log.info("pipelined executor: %d blocks / %d iterations, "
                     "%.1f%% host/device overlap",
                     stats.blocks, stats.iterations,
                     100.0 * stats.overlap_frac)
        booster.save_model(cfg.output_model)
        Log.info("Finished training, model saved to %s", cfg.output_model)
        if cfg.observe and cfg.observe_trace_file:
            from .observability import registry
            fmt = registry.dump_trace(cfg.observe_trace_file)
            Log.info("Wrote %s span trace to %s", fmt,
                     cfg.observe_trace_file)

    def predict(self) -> None:
        cfg = self.config
        if not cfg.data:
            Log.fatal("No prediction data: set data=<file>")
        if not cfg.input_model:
            Log.fatal("No model file: set input_model=<file>")
        booster = Booster(model_file=cfg.input_model)
        X, _ = _load_text_data(cfg.data, cfg)
        pred = booster.predict(
            X, raw_score=cfg.predict_raw_score,
            pred_leaf=cfg.predict_leaf_index,
            pred_contrib=cfg.predict_contrib,
            start_iteration=cfg.start_iteration_predict,
            num_iteration=cfg.num_iteration_predict,
            pred_early_stop=cfg.pred_early_stop,
            pred_early_stop_freq=cfg.pred_early_stop_freq,
            pred_early_stop_margin=cfg.pred_early_stop_margin)
        out = np.asarray(pred)
        if out.ndim == 1:
            out = out[:, None]
        with open_file(cfg.output_result, "w") as fh:
            np.savetxt(fh, out, delimiter="\t", fmt="%.18g")
        Log.info("Finished prediction, results saved to %s",
                 cfg.output_result)

    def serve(self) -> None:
        """task=serve: score a request file through the serving engine.

        Unlike task=predict, rows go through the device-resident
        `serving.Server` (registry load, shape-bucketed predictor,
        micro-batching) as a mixed-size request stream, on the card unless
        device_type=cpu, and a metrics snapshot (QPS, latency
        percentiles, bucket cache hits, sheds) lands next to the
        predictions (`serve_metrics_file`, else
        `<output_result>.metrics.json`). With observe, the metrics are
        served at `observe_metrics_port` while it runs and the span trace
        goes to `observe_trace_file`."""
        import json
        cfg = self.config
        if not cfg.data:
            Log.fatal("No request data: set data=<file>")
        if not cfg.input_model:
            Log.fatal("No model file: set input_model=<file>")
        from .serving import Server
        X, _ = _load_text_data(cfg.data, cfg)
        with Server.from_config(cfg) as server:
            if cfg.observe:
                from .observability import registry as _obs
                _obs.enable(ring=cfg.observe_ring)
                msrv = server.start_metrics_server(
                    port=cfg.observe_metrics_port)
                Log.info("observability metrics at %s", msrv.url)
            server.load_model("default", model_file=cfg.input_model)
            # mixed-size request stream: walk the file in growing chunks
            # so the bucket cache sees many batch shapes, like live
            # traffic would produce
            futures = []
            lo, step = 0, 1
            while lo < len(X):
                hi = min(lo + step, len(X))
                futures.append(server.predict_async(
                    "default", X[lo:hi], raw_score=cfg.predict_raw_score))
                lo = hi
                step = min(step * 2, max(cfg.serve_max_batch_size, 1))
            preds = [np.asarray(f.result()) for f in futures]
            out = np.concatenate(
                [p[:, None] if p.ndim == 1 else p for p in preds], axis=0)
            with open_file(cfg.output_result, "w") as fh:
                np.savetxt(fh, out, delimiter="\t", fmt="%.18g")
            snapshot = server.metrics_snapshot()
        metrics_path = cfg.serve_metrics_file or \
            cfg.output_result + ".metrics.json"
        with open_file(metrics_path, "w") as fh:
            json.dump(snapshot, fh, indent=2)
            fh.write("\n")
        m = snapshot["models"]["default"]
        Log.info("Finished serving %d requests (%d rows, %d compiled "
                 "buckets), results saved to %s, metrics to %s",
                 m["requests"], m["rows"], m["buckets_compiled"],
                 cfg.output_result, metrics_path)
        if cfg.observe and cfg.observe_trace_file:
            from .observability import registry as _obs
            fmt = _obs.dump_trace(cfg.observe_trace_file)
            Log.info("Wrote %s span trace to %s", fmt,
                     cfg.observe_trace_file)

    def refit(self) -> None:
        """task=refit: the input model's leaves refitted on `data`
        (Booster.refit, decay refit_decay_rate), its gradients on the
        device device_type names."""
        cfg = self.config
        booster = Booster(params=dict(self.params),
                          model_file=cfg.input_model)
        X, y = _load_text_data(cfg.data, cfg)
        new_booster = booster.refit(X, y, decay_rate=cfg.refit_decay_rate)
        new_booster.save_model(cfg.output_model)
        Log.info("Finished refit, model saved to %s", cfg.output_model)

    def save_binary(self) -> None:
        """task=save_binary: bin the data once and cache it in
        <data>.bin (reference application.cpp's save_binary task)."""
        cfg = self.config
        if not cfg.data:
            Log.fatal("No training data: set data=<file>")
        dtrain = self._load_train_dataset()
        out = cfg.data + ".bin"
        dtrain.save_binary(out)
        Log.info("Dataset saved to binary file %s", out)

    def convert_model(self) -> None:
        cfg = self.config
        booster = Booster(model_file=cfg.input_model)
        code = _model_to_if_else(booster._host_model())
        with open_file(cfg.convert_model, "w") as fh:
            fh.write(code)
        Log.info("Model converted to %s", cfg.convert_model)


def _model_to_if_else(model) -> str:
    """C++ if-else code of the model (reference SaveModelToIfElse,
    gbdt_model_text.cpp:286 / Tree::ToIfElse tree.cpp)."""
    lines = ["#include <cmath>", "#include <cstdint>", "",
             "// generated by lightgbm_tpu convert_model", ""]
    for ti, t in enumerate(model.trees):
        lines.append(f"double PredictTree{ti}(const double* arr) {{")

        def emit(node, indent):
            pad = "  " * indent
            if node < 0:
                return [f"{pad}return {float(t.leaf_value[~node])!r};"]
            f = int(t.split_feature[node])
            thr = float(t.threshold[node])
            dt = int(t.decision_type[node])
            if dt & 1:
                # categorical: the threshold indexes cat_boundaries; the
                # category bitset becomes an explicit membership test
                # (reference Tree::ToIfElse CategoricalDecision)
                ci = int(thr)
                lo = int(t.cat_boundaries[ci])
                hi = int(t.cat_boundaries[ci + 1])
                vals = [(w - lo) * 32 + b for w in range(lo, hi)
                        for b in range(32)
                        if (int(t.cat_threshold[w]) >> b) & 1]
                in_set = " || ".join(f"v{node} == {v}" for v in vals) \
                    or "false"
                # non-finite, negative or huge values go right as in
                # HostTree.predict_rows, which keeps the cast defined
                cond = (f"std::isfinite(arr[{f}]) && arr[{f}] >= 0.0 && "
                        f"arr[{f}] < 2147483647.0 && "
                        f"[&]{{ int v{node} = static_cast<int>(arr[{f}]); "
                        f"return {in_set}; }}()")
            else:
                # numerical (reference NumericalDecision, tree.h:335-412):
                # missing type NaN routes NaN by default_left; None and
                # Zero map NaN to 0, then Zero routes |v| <= kZeroThreshold
                # by default_left
                mt = (dt >> 2) & 3
                dl = bool(dt & 2)
                if mt == 2:
                    if dl:
                        cond = (f"std::isnan(arr[{f}]) || "
                                f"arr[{f}] <= {thr!r}")
                    else:
                        cond = (f"!std::isnan(arr[{f}]) && "
                                f"arr[{f}] <= {thr!r}")
                elif mt == 1:
                    cond = (f"[&]{{ double u{node} = std::isnan(arr[{f}])"
                            f" ? 0.0 : arr[{f}]; "
                            f"return std::fabs(u{node}) <= 1e-35 ? "
                            f"{str(dl).lower()} : u{node} <= {thr!r}; }}()")
                else:
                    cond = (f"(std::isnan(arr[{f}]) ? 0.0 : arr[{f}])"
                            f" <= {thr!r}")
            out = [f"{pad}if ({cond}) {{"]
            out += emit(int(t.left_child[node]), indent + 1)
            out += [f"{pad}}} else {{"]
            out += emit(int(t.right_child[node]), indent + 1)
            out += [f"{pad}}}"]
            return out

        if t.num_leaves <= 1:
            lines.append(f"  return {float(t.leaf_value[0])!r};")
        else:
            lines.extend(emit(0, 1))
        lines.append("}")
        lines.append("")
    n = len(model.trees)
    lines.append("double Predict(const double* arr) {")
    lines.append("  double sum = 0.0;")
    for ti in range(n):
        lines.append(f"  sum += PredictTree{ti}(arr);")
    lines.append("  return sum;")
    lines.append("}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        Application(argv).run()
    except Exception as e:  # the reference main.cpp's catch-all
        Log.warning("Met Exceptions: %s", str(e))
        from .observability.flightrec import recorder
        recorder.record_exception("cli.main", e)
        recorder.flush("exception")
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
