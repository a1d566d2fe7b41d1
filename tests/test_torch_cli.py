"""The port's command line (lightgbm_tpu_torch.cli) against the JAX
package's (lightgbm_tpu.cli), on the CPU, in a tmp_path.

Both CLIs run the same files in-process with the same key=value
arguments, the port's with device_type=cpu. At growth_overshoot 0 and
min_gain_to_split 1e-3 the port's MXU grower grows the JAX booster's
portable-grower trees (ROADMAP C3), so task=train's trees are held to the
JAX CLI's at the bars of tests/test_torch_train.py (structure identical,
values within rtol 1e-4) and task=predict / task=refit outputs within
rtol 1e-5 / atol 1e-6. Exact bars: task=train's model text is byte-equal
to engine.train on the same rows with the same parameters (side files
.weight and .query included), save_binary's cache trains the same model
as its text file and loads in the JAX CLI, convert_model writes the JAX
CLI's C++ for the same model, the loaders (header, label_column, TSV,
LibSVM) give the JAX loaders' arrays, and the native parser gives
np.loadtxt's bits. serve and loop raise, naming ROADMAP A11. Data from the
numpy seeds stated in _write.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lightgbm_tpu import cli as jcli
from lightgbm_tpu.config import Config as JConfig
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cext, cli
from lightgbm_tpu_torch.config import Config
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_train import _assert_same_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["objective=binary", "num_leaves=7", "learning_rate=0.3",
         "max_bin=31", "min_data_in_leaf=5", "min_gain_to_split=0.001",
         "growth_overshoot=0", "num_iterations=5", "verbosity=-1"]


def _write(path, n=300, f=5, seed=41, delim=",", header=False,
           label_col=0, nan=True):
    """A delimited file of n rows: the label (binary) in column
    label_col, f features; returns (X, y)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    if nan:
        X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n) > 0).astype(float)
    cols = np.insert(X, label_col, y, axis=1)
    np.savetxt(path, cols, delimiter=delim, fmt="%.17g",
               header=delim.join(f"c{i}" for i in range(f + 1))
               if header else "", comments="")
    return X, y


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """Every test runs in its tmp_path (relative paths as a CLI user's)."""
    monkeypatch.chdir(tmp_path)


def _both(tmp_path, args, port_extra=("device_type=cpu",)):
    """Run the JAX CLI, then the port's, on `args` (paths in tmp_path)."""
    jcli.main([a.replace("@", "jax_") for a in args])
    cli.main([a.replace("@", "port_") for a in args] + list(port_extra))


def _read(tmp_path, name):
    with open(tmp_path / name) as fh:
        return fh.read()


def test_train_predict_refit_match_jax(tmp_path):
    _write(tmp_path / "train.csv")
    _write(tmp_path / "test.csv", n=120, seed=42)
    _both(tmp_path, ["task=train", "data=train.csv",
                     "output_model=@model.txt"] + TRAIN)
    _assert_same_model(_read(tmp_path, "jax_model.txt"),
                       _read(tmp_path, "port_model.txt"))
    _both(tmp_path, ["task=predict", "data=test.csv",
                     "input_model=@model.txt", "output_result=@pred.txt"])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port_pred.txt"),
                               np.loadtxt(tmp_path / "jax_pred.txt"),
                               rtol=1e-5, atol=1e-6)
    _both(tmp_path, ["task=refit", "data=test.csv", "input_model=@model.txt",
                     "output_model=@refit.txt", "refit_decay_rate=0.5"])
    j = lgt.Booster(model_file=str(tmp_path / "jax_refit.txt"))
    t = lgt.Booster(model_file=str(tmp_path / "port_refit.txt"))
    X = np.loadtxt(tmp_path / "test.csv", delimiter=",")[:, 1:]
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert t.model_to_string() != \
        lgt.Booster(model_file=str(tmp_path / "port_model.txt")) \
        .model_to_string()
    # predict's options: raw scores, leaf indices, the early stop
    _both(tmp_path, ["task=predict", "data=test.csv",
                     "input_model=@model.txt", "output_result=@leaf.txt",
                     "predict_leaf_index=true"])
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "port_leaf.txt"),
                                  np.loadtxt(tmp_path / "jax_leaf.txt"))
    _both(tmp_path, ["task=predict", "data=test.csv",
                     "input_model=jax_model.txt", "output_result=@es.txt",
                     "pred_early_stop=true", "pred_early_stop_freq=1",
                     "pred_early_stop_margin=0.5", "predict_raw_score=true"])
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "port_es.txt"),
                                  np.loadtxt(tmp_path / "jax_es.txt"))


def _port_api(params_argv, X, y, **ds_kw):
    params = dict(a.split("=", 1) for a in params_argv)
    ds = lgt.Dataset(X, label=y, params=dict(params), **ds_kw)
    return lgt.train(params, ds, int(params["num_iterations"]))


def test_train_is_engine_train_with_side_files(tmp_path):
    X, y = _write(tmp_path / "train.csv")
    w = np.random.RandomState(43).rand(len(y)) + 0.5
    np.savetxt(tmp_path / "train.csv.weight", w, fmt="%.17g")
    argv = ["task=train", "data=train.csv", "output_model=m.txt",
            "device_type=cpu"] + TRAIN
    cli.main(argv)
    api = _port_api(argv, X, y.astype(np.float32), weight=w)
    assert _read(tmp_path, "m.txt") == api.model_to_string()
    # a ranking file with its .query side file
    rng = np.random.RandomState(44)
    Xr = rng.randn(200, 4)
    yr = np.clip(np.round(Xr[:, 0] + 0.5 * rng.randn(200) + 1), 0, 3)
    np.savetxt(tmp_path / "rank.tsv", np.column_stack([yr, Xr]),
               delimiter="\t", fmt="%.17g")
    np.savetxt(tmp_path / "rank.tsv.query", [50, 70, 80], fmt="%d")
    rank = ["task=train", "data=rank.tsv", "output_model=r.txt",
            "device_type=cpu", "objective=lambdarank", "num_leaves=5",
            "min_data_in_leaf=3", "num_iterations=3", "verbosity=-1"]
    cli.main(rank)
    api = _port_api(rank, Xr, yr.astype(np.float32), group=[50, 70, 80])
    assert _read(tmp_path, "r.txt") == api.model_to_string()


def test_save_binary_then_train(tmp_path):
    _write(tmp_path / "train.csv")
    cli.main(["task=save_binary", "data=train.csv", "device_type=cpu",
              "max_bin=31"])
    assert (tmp_path / "train.csv.bin").exists()
    common = ["task=train", "device_type=cpu"] + TRAIN
    cli.main(common + ["data=train.csv", "output_model=a.txt"])
    cli.main(common + ["data=train.csv.bin", "output_model=b.txt"])

    def trees(name):
        return _read(tmp_path, name).split("end of trees")[0]
    assert trees("a.txt") == trees("b.txt")
    # the JAX CLI trains from the port's cache
    jcli.main(["task=train", "data=train.csv.bin", "output_model=j.txt"]
              + TRAIN)
    _assert_same_model(_read(tmp_path, "j.txt"), _read(tmp_path, "b.txt"))


def test_convert_model_matches_jax(tmp_path):
    X, y = _write(tmp_path / "train.csv")
    jcli.main(["task=train", "data=train.csv", "output_model=m.txt",
               "categorical_feature=3"] + TRAIN)
    _both(tmp_path, ["task=convert_model", "input_model=m.txt",
                     "convert_model=@m.cpp"], port_extra=())
    assert _read(tmp_path, "port_m.cpp") == _read(tmp_path, "jax_m.cpp")
    assert "double Predict(const double* arr)" in _read(tmp_path,
                                                        "port_m.cpp")


@pytest.mark.parametrize("fmt", ["header_label2", "tsv", "libsvm"])
def test_loaders_match_jax(tmp_path, fmt):
    path = str(tmp_path / "data.txt")
    params = {}
    if fmt == "header_label2":
        _write(path, header=True, label_col=2)
        params = {"header": "true", "label_column": "2"}
    elif fmt == "tsv":
        _write(path, delim="\t")
    else:
        rng = np.random.RandomState(45)
        with open(path, "w") as fh:
            for i in range(60):
                feats = sorted(rng.choice(8, 3, replace=False))
                fh.write(f"{i % 2} " + " ".join(
                    f"{j}:{rng.randn():.6f}" for j in feats) + "\n")
    Xt, yt = cli._load_text_data(path, Config(params))
    Xj, yj = jcli._load_text_data(path, JConfig(params))
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    assert Xt.shape[1] == (8 if fmt == "libsvm" else 5)


@pytest.mark.parametrize("delim,skip", [(",", 0), (",", 1), ("\t", 1)])
def test_native_parser_matches_loadtxt(tmp_path, delim, skip):
    path = str(tmp_path / "p.txt")
    _write(path, n=257, delim=delim, header=bool(skip))
    got = cext.parse_delimited(path, delim, skip)
    want = np.loadtxt(path, delimiter=delim, skiprows=skip, ndmin=2)
    assert got.dtype == np.float64 and got.shape == want.shape == (257, 6)
    np.testing.assert_array_equal(got, want)
    assert cext.count_rows(path, delim) == (257 + skip, 6)
    assert cext.parse_delimited(str(tmp_path / "missing.csv")) is None
    (tmp_path / "empty.csv").write_text("")
    assert cext.parse_delimited(str(tmp_path / "empty.csv")) is None


def test_observability_snapshots_and_flight_recorder(tmp_path, monkeypatch):
    from lightgbm_tpu_torch import observability
    from lightgbm_tpu_torch.observability import recorder, registry
    _write(tmp_path / "train.csv")
    served = []

    class _Server:
        def __init__(self, text, snap, port):
            served.append((text(), port))
            self.url = f"http://127.0.0.1:{port}/metrics"

        def close(self):
            served.append("closed")

    monkeypatch.setattr(observability, "MetricsHTTPServer", _Server)
    try:
        cli.main(["task=train", "data=train.csv", "output_model=m.txt",
                  "device_type=cpu", "observe_trace_file=trace.json",
                  "observe_metrics_port=9", "snapshot_freq=2"] + TRAIN)
        with open(tmp_path / "trace.json") as fh:
            assert json.load(fh)
        assert served[0][1] == 9 and served[-1] == "closed"
        assert sorted(p.name for p in tmp_path.glob("m.txt.snapshot_*")) \
            == ["m.txt.snapshot_iter_2", "m.txt.snapshot_iter_4"]
        # a failure before any booster still leaves its bundle
        with pytest.raises(Exception):
            cli.main(["task=train", "data=missing.csv", "device_type=cpu",
                      f"flightrec_dir={tmp_path / 'fr'}"])
        assert list((tmp_path / "fr").glob("postmortem_*.json"))
    finally:
        registry.disable()
        registry.reset()
        recorder.reset()
        recorder.configure(enabled=True, capacity=256, out_dir="")


@pytest.mark.parametrize("argv,err,match", [
    (["task=serve"], lgt.LightGBMError, "A11"),
    (["task=loop"], lgt.LightGBMError, "A11"),
    (["task=train", "data=train.csv", "stream_input=true"],
     lgt.LightGBMError, "A11"),
    (["task=train", "data=train.csv", "num_machines=2",
      "tree_learner=data"], NotImplementedError, "P14"),
    (["task=unknown"], ValueError, "task"),
])
def test_refused_tasks(tmp_path, argv, err, match):
    _write(tmp_path / "train.csv", n=50)
    with pytest.raises(err, match=match):
        cli.main(argv + ["device_type=cpu"])


def test_module_entry_point(tmp_path):
    """python -m lightgbm_tpu_torch.cli, with a config file the command
    line overrides."""
    _write(tmp_path / "train.csv", n=120)
    (tmp_path / "train.conf").write_text(
        "# a reference-style config\ntask = train\ndata = train.csv\n"
        "num_iterations = 9\n" + "\n".join(TRAIN[:5]) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.cli",
                    "config=train.conf", "num_iterations=2",
                    "device_type=cpu", "output_model=m.txt"],
                   cwd=tmp_path, env=env, check=True)
    assert lgt.Booster(model_file=str(tmp_path / "m.txt")).num_trees() == 2
    bad = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.cli",
                          "task=serve"], cwd=tmp_path, env=env,
                         capture_output=True, text=True)
    assert bad.returncode != 0 and "A11" in bad.stderr
