"""The port's serving forest (lightgbm_tpu_torch/serving/forest.py) and
its forest sum (learner/predict.predict_binned_forest_ref, the plain
version of csrc/serve_forest.cu) against the JAX package's, on the CPU.

Both packages build their forests from the same model string (trained by
the port on the CPU, or hand-edited for the unsupported cases), so every
field is compared exactly: the stacked tree arrays through
convert.device_forest_to_numpy (the port's int64 bitset words back to
uint32), tree_class, num_bins, missing_is_nan, the binners, and the bins
of adversarial rows (NaN, zeros, unseen and negative categories) after
the port's narrow dtype is widened to int32. The plain forest sum is
bit-equal to the JAX package's XLA predict_binned_forest on the same
arrays, with and without row_valid, pad rows exactly 0.0, and also on the
JAX forest's arrays carried over by convert.device_forest_from_numpy.
Booster.device_forest is memoized and rebuilt after update,
rollback_one_iter and refit. Data from the numpy seeds in _data.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.learner.predict import predict_binned_forest as \
    jax_forest_sum
from lightgbm_tpu.serving.forest import build_device_forest as jax_build
from lightgbm_tpu.tree import HostModel as JHostModel
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.convert import (device_forest_from_numpy,
                                        device_forest_to_numpy)
from lightgbm_tpu_torch.learner.predict import (predict_binned_forest,
                                                predict_binned_forest_ref)
from lightgbm_tpu_torch.serving.forest import (bin_dtype_for,
                                               build_device_forest)
from lightgbm_tpu_torch.tree import HostModel
from tests.test_torch_one_thread import one_thread  # noqa: F401

BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
        "device_type": "cpu", "min_gain_to_split": 1e-3}


def _data(kind, n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.randn(n)
    if kind == "nan":
        X[rng.rand(n, 6) < 0.15] = np.nan
    if kind == "zero":
        X[rng.rand(n, 6) < 0.2] = 0.0
    if kind == "categorical":
        X[:, 2] = rng.randint(0, 40, n)
        X[:, 4] = rng.randint(0, 5, n)
        y = y + (X[:, 2] % 3 == 0) - 0.5 * (X[:, 4] == 1)
    return X, y


def _model_text(kind):
    X, y = _data(kind)
    params = dict(BASE, objective="regression")
    ds_kw = {}
    if kind == "zero":
        params["zero_as_missing"] = True
    if kind == "categorical":
        ds_kw["categorical_feature"] = [2, 4]
        params.update(max_cat_threshold=16, cat_smooth=1.0,
                      min_data_per_group=5)
    if kind == "multiclass":
        y = np.digitize(y, [-0.5, 0.5]).astype(np.float64)
        params.update(objective="multiclass", num_class=3)
    bst = lgt.train(params, lgt.Dataset(X, label=y, **ds_kw), 6)
    return bst.model_to_string(), X


CASES = ("numeric", "nan", "zero", "categorical", "multiclass")


@pytest.fixture(scope="module")
def models():
    return {kind: _model_text(kind) for kind in CASES}


def _queries(kind, X):
    """Rows the binners must agree on: the training rows, NaNs, exact
    zeros, values past every edge, unseen and negative categories."""
    Q = np.concatenate([X[:60], X[:12] * 100.0]).copy()
    Q[0, :] = np.nan
    Q[1, :] = 0.0
    Q[2, :] = 1e-40
    Q[3, :] = -1e-40
    if kind == "categorical":
        Q[4, 2] = 99.0          # unseen
        Q[5, 2] = -3.0          # negative
        Q[6, 4] = 2.5e9         # past int32
        Q[7, 2] = np.inf
    return Q


def _both(text):
    return (build_device_forest(HostModel.from_string(text)),
            jax_build(JHostModel.from_string(text)))


def _jax_arrays(jf):
    return {"stacked": {k: np.asarray(v)
                        for k, v in jf.stacked._asdict().items()},
            "tree_class": np.asarray(jf.tree_class),
            "num_bins": np.asarray(jf.num_bins),
            "missing_is_nan": np.asarray(jf.missing_is_nan)}


def _assert_arrays_equal(got, want):
    for key in ("tree_class", "num_bins", "missing_is_nan"):
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    for field, w in want["stacked"].items():
        g = got["stacked"][field]
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g, w), field


@pytest.mark.parametrize("kind", CASES)
def test_forest_fields_equal_jax(models, kind):
    pf, jf = _both(models[kind][0])
    assert pf.supported and jf.supported
    _assert_arrays_equal(device_forest_to_numpy(pf), _jax_arrays(jf))
    for attr in ("num_outputs", "num_features", "num_trees", "objective",
                 "average_output", "num_iterations"):
        assert getattr(pf, attr) == getattr(jf, attr), attr
    assert len(pf.binners) == len(jf.binners)
    for pb, jb in zip(pf.binners, jf.binners):
        assert (pb.is_categorical, pb.missing_type, pb.num_bin,
                pb.cat_to_bin) == (jb.is_categorical, jb.missing_type,
                                   jb.num_bin, jb.cat_to_bin)
        assert (pb.edges is None) == (jb.edges is None)
        if pb.edges is not None:
            assert np.array_equal(pb.edges, jb.edges)
    if kind == "categorical":
        assert any(b.is_categorical for b in pf.binners)
        assert bool(pf.stacked.is_cat.any())
    if kind in ("nan", "zero"):
        assert bool(pf.missing_is_nan.any())
    assert int(pf.stacked.num_leaves.min()) > 1
    if kind == "multiclass":
        assert pf.num_outputs == 3 and set(pf.tree_class.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("kind", CASES)
def test_bin_rows_equal_jax(models, kind):
    text, X = models[kind]
    pf, jf = _both(text)
    Q = _queries(kind, X)
    got = pf.bin_rows(Q)
    want = jf.bin_rows(Q)
    assert got.dtype == pf.bin_dtype == bin_dtype_for(
        max(b.num_bin for b in pf.binners))
    assert got.dtype == np.uint8
    assert np.array_equal(got.astype(np.int32), want)


@pytest.mark.parametrize("kind", CASES)
def test_forest_sum_ref_bit_equal_jax(models, kind):
    """The plain forest sum against the JAX package's XLA function on the
    same rows: unpadded, padded to a bucket with row_valid, and with a
    scattered row_valid; pad rows exactly 0.0, real rows bit-equal."""
    import jax.numpy as jnp
    text, X = models[kind]
    pf, jf = _both(text)
    Q = _queries(kind, X)
    n, pad = len(Q), 128
    bins = pf.bin_rows(Q)
    pbins = np.concatenate([bins, np.zeros((pad - n, bins.shape[1]),
                                           bins.dtype)])
    rng = np.random.RandomState(5)
    for valid in (None, np.arange(pad) < n, rng.rand(pad) < 0.6):
        want = np.asarray(jax_forest_sum(
            jf.stacked, jf.tree_class, jnp.asarray(pbins.astype(np.int32)),
            jf.num_bins, jf.missing_is_nan, num_outputs=jf.num_outputs,
            row_valid=None if valid is None else jnp.asarray(valid)))
        got = predict_binned_forest(
            pf.stacked, pf.tree_class, torch.from_numpy(pbins),
            pf.num_bins, pf.missing_is_nan, pf.num_outputs,
            row_valid=None if valid is None else torch.from_numpy(valid))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))
        if valid is not None:
            assert np.all(got.numpy()[~valid].view(np.int32) == 0)
    # rows= marks the same pad rows as a prefix row_valid
    by_rows = predict_binned_forest_ref(
        pf.stacked, pf.tree_class, torch.from_numpy(pbins), pf.num_bins,
        pf.missing_is_nan, pf.num_outputs, rows=n)
    unpadded = predict_binned_forest_ref(
        pf.stacked, pf.tree_class, torch.from_numpy(bins), pf.num_bins,
        pf.missing_is_nan, pf.num_outputs)
    assert torch.equal(by_rows[:n].view(torch.int32),
                       unpadded.view(torch.int32))
    assert torch.equal(by_rows[n:].view(torch.int32),
                       torch.zeros_like(by_rows[n:]).view(torch.int32))
    # wider dtypes of the same bins give the same bits
    for dt in (torch.uint16, torch.int32):
        wide = torch.from_numpy(bins.astype(np.int32)).to(dt)
        assert torch.equal(predict_binned_forest_ref(
            pf.stacked, pf.tree_class, wide, pf.num_bins, pf.missing_is_nan,
            pf.num_outputs).view(torch.int32), unpadded.view(torch.int32))
    # the JAX forest's arrays carried over give the same sum
    carried = device_forest_from_numpy(_jax_arrays(jf))
    again = predict_binned_forest_ref(
        carried["stacked"], carried["tree_class"], torch.from_numpy(bins),
        carried["num_bins"], carried["missing_is_nan"], pf.num_outputs)
    assert torch.equal(again.view(torch.int32), unpadded.view(torch.int32))
    # and the serving answers match host predict within f32 accumulation
    host = lgt.Booster(model_str=text).predict(Q, raw_score=True)
    np.testing.assert_allclose(
        unpadded.numpy().reshape(host.shape).astype(np.float64), host,
        rtol=1e-5, atol=1e-6)


def test_file_loaded_model(models, tmp_path):
    """A model read back from its file (no training BinMappers) builds
    the JAX package's forest."""
    text, X = models["nan"]
    path = tmp_path / "model.txt"
    lgt.Booster(model_str=text).save_model(str(path))
    pf = lgt.Booster(model_file=str(path)).device_forest("cpu")
    jf = jlgb.Booster(model_file=str(path)).device_forest()
    _assert_arrays_equal(device_forest_to_numpy(pf), _jax_arrays(jf))
    Q = _queries("nan", X)
    assert np.array_equal(pf.bin_rows(Q).astype(np.int32), jf.bin_rows(Q))


def _mixed_missing(text):
    """The model text with the first numerical node of feature 0 given
    another missing_type than the feature's other nodes."""
    out, done = [], False
    for line in text.splitlines():
        if line.startswith("decision_type=") and not done:
            vals = line.split("=", 1)[1].split()
            feats = None
            for prev in reversed(out):
                if prev.startswith("split_feature="):
                    feats = prev.split("=", 1)[1].split()
                    break
            for i, (dt, f) in enumerate(zip(vals, feats)):
                if int(dt) & 1 == 0:
                    vals[i] = str((int(dt) & ~12) | (8 if int(dt) & 12 != 8
                                                     else 4))
                    done = True
                    break
            line = "decision_type=" + " ".join(vals)
        out.append(line)
    return "\n".join(out) + "\n"


def _linear_text():
    X, y = _data("numeric", n=300, seed=2)
    bst = lgt.train(dict(BASE, objective="regression", linear_tree=True),
                    lgt.Dataset(X, label=y), 2)
    return bst.model_to_string()


@pytest.mark.parametrize("case", ["no_trees", "linear", "mixed_missing"])
def test_unsupported_reasons_equal_jax(models, case):
    if case == "no_trees":
        pm, jm = HostModel(), JHostModel()
        pm.max_feature_idx = jm.max_feature_idx = 3
        pf, jf = build_device_forest(pm), jax_build(jm)
    else:
        text = _linear_text() if case == "linear" else \
            _mixed_missing(models["numeric"][0])
        pf, jf = _both(text)
    assert not pf.supported and not jf.supported
    assert pf.unsupported_reason == jf.unsupported_reason
    assert pf.device is None and pf.stacked is None
    assert {"no_trees": "no trees", "linear": "linear",
            "mixed_missing": "missing_type"}[case] in pf.unsupported_reason


def test_device_forest_memoized_and_invalidated():
    X, y = _data("numeric", n=300, seed=3)
    bst = lgt.train(dict(BASE, objective="regression", num_leaves=7),
                    lgt.Dataset(X, label=y), 2, keep_training_booster=True)
    f1 = bst.device_forest()
    assert f1.device == torch.device("cpu")
    assert bst.device_forest() is f1 and bst.device_forest("cpu") is f1
    bst.update()
    f2 = bst.device_forest()
    assert f2 is not f1 and f2.num_trees == f1.num_trees + 1
    bst.rollback_one_iter()
    f3 = bst.device_forest()
    assert f3 is not f2 and f3.num_trees == f1.num_trees
    assert torch.equal(f3.stacked.leaf_value, f1.stacked.leaf_value)
    refit = bst.refit(X, y * 2.0, decay_rate=0.0)
    f4 = refit.device_forest()
    assert f4 is not f3 and bst.device_forest() is f3
    assert not torch.equal(f4.stacked.leaf_value, f3.stacked.leaf_value)
    np.testing.assert_allclose(
        f4.convert_raw(predict_binned_forest(
            f4.stacked, f4.tree_class, torch.from_numpy(f4.bin_rows(X)),
            f4.num_bins, f4.missing_is_nan, f4.num_outputs).numpy()),
        refit.predict(X), rtol=1e-5, atol=1e-6)


def test_loaded_booster_serves_on_the_card_by_default(models):
    """A booster loaded from text builds its forest where its
    device_type says: the card by default, which raises without one."""
    text = models["numeric"][0]
    assert lgt.Booster(params={"device_type": "cpu"}, model_str=text) \
        .device_forest().device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            lgt.Booster(model_str=text).device_forest()


def test_many_categories_stay_uint8():
    """At max_bin 255 a categorical feature's serving bins stay within
    uint8 (at most 255 categories plus the unseen bin), even with a high
    max_cat_threshold; the binner's dtype rule widens past 256 and
    65,536 bins, and the sum is the same on wider bins."""
    rng = np.random.RandomState(11)
    n = 6000
    X = rng.randn(n, 3)
    X[:, 0] = rng.randint(0, 400, n)
    y = np.sin(X[:, 0]) + 0.1 * X[:, 1]
    bst = lgt.train(dict(BASE, objective="regression", max_bin=255,
                         max_cat_threshold=256, max_cat_to_onehot=1,
                         min_data_per_group=1, cat_smooth=0.1,
                         num_leaves=31, cat_l2=0.0),
                    lgt.Dataset(X, label=y, categorical_feature=[0]), 10)
    f = bst.device_forest("cpu")
    cat = f.binners[0]
    assert cat.is_categorical and 1 < cat.num_bin <= 256
    bins = f.bin_rows(X[:500])
    assert bins.dtype == np.uint8
    raw = predict_binned_forest(f.stacked, f.tree_class,
                                torch.from_numpy(bins), f.num_bins,
                                f.missing_is_nan, 1)
    np.testing.assert_allclose(raw[:, 0].numpy().astype(np.float64),
                               bst.predict(X[:500], raw_score=True),
                               rtol=1e-5, atol=1e-6)
    assert (bin_dtype_for(256), bin_dtype_for(257), bin_dtype_for(65536),
            bin_dtype_for(65537)) == (np.uint8, np.uint16, np.uint16,
                                      np.int32)


def test_wide_numeric_binner_picks_int32():
    """A binner with more than 65,536 bins (thresholds rewritten into a
    70,000-edge model) bins to int32, and the forest sum reads them."""
    edges = np.arange(70_000, dtype=np.float64) * 0.5
    lines = ["tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
             "label_index=0", "max_feature_idx=0", "objective=regression",
             "feature_names=f0", "feature_infos=[0:1]", "tree_sizes=0", ""]
    for i, thr in enumerate((float(edges[0]), float(edges[-1]))):
        lines += [f"Tree={i}", "num_leaves=2", "num_cat=0",
                  "split_feature=0", "split_gain=1", f"threshold={thr!r}",
                  "decision_type=2", "left_child=-1", "right_child=-2",
                  f"leaf_value={0.25 * (i + 1)!r} {-0.5 * (i + 1)!r}",
                  "leaf_weight=1 1", "leaf_count=1 1", "internal_value=0",
                  "internal_weight=1", "internal_count=2", "is_linear=0",
                  "shrinkage=1", ""]
    lines += ["end of trees", ""]
    model = HostModel.from_string("\n".join(lines))
    f = build_device_forest(model)
    f.binners[0].edges = edges
    f.binners[0].num_bin = len(edges) + 1
    f.num_bins[0] = len(edges) + 1
    f.stacked.threshold_bin[1, 0] = len(edges) - 1
    X = np.array([[-1.0], [0.0], [10.0], [edges[-1]], [edges[-1] + 1.0]])
    bins = f.bin_rows(X)
    assert bins.dtype == np.int32 and bins[-1, 0] == len(edges)
    raw = predict_binned_forest(f.stacked, f.tree_class,
                                torch.from_numpy(bins), f.num_bins,
                                f.missing_is_nan, 1)[:, 0].numpy()
    want = np.asarray(HostModel.from_string("\n".join(lines)).predict(
        X, raw_score=True), np.float32)
    assert np.array_equal(raw, want)

