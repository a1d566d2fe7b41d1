"""Forced splits (forcedsplits_filename) in the port against the JAX
package, on the CPU.

The spec tree is read and flattened breadth first as the JAX package's
GBDT._load_forced_splits does (a node on an unused or a categorical
feature kept as feature -1, with a warning). Boosters of 3 update() calls
on make_binary(3000 x 6), num_leaves 15, max_bin 31, under a nested spec
(a root on feature 3, both its children, one grandchild):

- the MXU grower (overshoot 2: overgrown, then pruned with the forced
  splits ranked first) against the JAX booster pinned to its MXU grower
  in interpret mode (the file's one compile): identical structure,
  values within 1e-4 (quantized: test_torch_forced_quantized.py, whose
  JAX compile is another);
- the portable grower (use_pallas=false: the segment sums; max_bin 511:
  the scatter kernel) against the unpinned JAX booster, whose CPU path is
  its portable grower;
- a spec whose grandchild cannot apply (a threshold past the feature's
  range: no rows go right) stops there, on both growers and as in the
  JAX package;
- bundled data (EFB), the port's segmented MXU path and its default
  portable path against the JAX package's default (portable) booster;
- train at fused_block_size 2 byte-equal to update(), exact, quantized
  and multiclass (every class tree under the spec);
- a forced split whose gain loses the best-first replay survives the
  overshoot prune (the Grower's programs).
"""

import json
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learner import grower_mxu
from lightgbm_tpu_torch.learner.prune import prune_best_first_ref
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from lightgbm_tpu_torch.utils.log import Log
from tests.conftest import make_binary
from tests.test_torch_efb import _assert_same_model, _sparse_X
from tests.test_torch_one_thread import one_thread  # noqa: F401

_ROUNDS = 3
_BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
         "min_data_in_leaf": 5, "verbosity": -1}
# a root on feature 3, both children, and one grandchild (right-left)
_SPEC = {"feature": 3, "threshold": 0.0,
         "left": {"feature": 4, "threshold": 0.1},
         "right": {"feature": 1, "threshold": -0.2,
                   "left": {"feature": 0, "threshold": 0.3}}}


def _data():
    return make_binary(n=3000, f=6)


def _spec_file(tmp, spec=_SPEC, name="forced.json"):
    fn = tmp / name
    fn.write_text(json.dumps(spec))
    return str(fn)


def _jax_booster(X, y, params, pinned):
    jb = lgb.Booster(dict(params, pipeline=False),
                     lgb.Dataset(X, label=y, params=params))
    if pinned:
        jb.gbdt._hist_impl = "mxu"
        jb.gbdt._mxu_interpret = True
    for _ in range(_ROUNDS):
        jb.update()
    return jb


def _port_booster(X, y, params, rounds=_ROUNDS):
    p = dict(params, device_type="cpu")
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for _ in range(rounds):
        bst.update()
    return bst


def _logloss(bst, X, y):
    p = 1.0 / (1.0 + np.exp(-bst.predict(X, raw_score=True)))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def _forced_nodes(tree, spec):
    """(node, spec) pairs of the spec's BFS that the tree applied, walking
    the spec and the tree together from the root."""
    out, todo = [], [(0, spec)]
    while todo:
        node, sp = todo.pop(0)
        if int(tree.split_feature[node]) < 0:
            continue
        out.append((node, sp))
        for side in ("left", "right"):
            if sp.get(side):
                todo.append((int(getattr(tree, side)[node]), sp[side]))
    return out


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return _spec_file(tmp_path_factory.mktemp("forced"))


def _jax_pinned(spec_path, quantized):
    """The JAX package's booster pinned to its MXU grower (interpret
    mode) under the nested spec."""
    X, y = _data()
    return _jax_booster(X, y, dict(_BASE, forcedsplits_filename=spec_path,
                                   use_quantized_grad=quantized), True)


def test_load_forced_splits_matches_jax(tmp_path, caplog, monkeypatch):
    """The flattened spec arrays equal the JAX package's, with a node on
    an unused (constant) feature and one on a categorical feature kept as
    -1 leaves, each with the JAX package's warning."""
    rng = np.random.RandomState(3)
    X = rng.randn(500, 5)
    X[:, 1] = 2.0                             # constant: not a used feature
    X[:, 2] = rng.randint(0, 6, 500)          # categorical
    y = (X[:, 0] > 0).astype(np.float32)
    spec = {"feature": 0, "threshold": 0.25,
            "left": {"feature": 1, "threshold": 2.0,
                     "left": {"feature": 3, "threshold": 0.0}},
            "right": {"feature": 4, "threshold": -0.5,
                      "left": {"feature": 2, "threshold": 3},
                      "right": {"feature": 3, "threshold": 1.5}}}
    params = {"max_bin": 31, "verbosity": 0, "categorical_feature": "2",
              "forcedsplits_filename": _spec_file(tmp_path, spec)}
    ds = lgt.Dataset(X, label=y, params=params).binned
    jds = lgb.Dataset(X, label=y, params=params).binned
    assert list(ds.used_features) == list(jds.used_features) == [0, 2, 3, 4]
    import logging
    # no Booster sets the verbosity here: warnings on, whatever ran before
    monkeypatch.setattr(Log, "verbosity", 0)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        got = GBDT._load_forced_splits(Config(params), ds,
                                       torch.device("cpu"))
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "unused feature 1" in text and "categorical feature 2" in text
    want = JaxGBDT._load_forced_splits(JaxConfig(params), jds)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # BFS: the root, its left (unused: childless), its right, then the
    # right's children (categorical, and feature 3 = used feature 2)
    assert got[0].tolist() == [0, -1, 3, -1, 2]
    assert got[2].tolist() == [1, -1, 3, -1, -1]
    assert GBDT._load_forced_splits(Config({}), ds, "cpu") is None


def check_forced_mxu_booster(jb, spec_path, quantized):
    """The port's MXU-grower booster under the nested spec against the
    pinned JAX booster jb: the same model (exact), or the training loss
    within 1% (quantized); every tree applies the spec's four splits at
    its threshold bins and keeps its true gains."""
    X, y = _data()
    p = dict(_BASE, forcedsplits_filename=spec_path,
             use_quantized_grad=quantized)
    bst = _port_booster(X, y, p)
    g = bst.gbdt
    assert g._hist_impl == "mxu" and g._forced is not None
    if quantized:
        # ROADMAP C2: other rounding noise, the loss within 1%
        lj, lt = _logloss(jb, X, y), _logloss(bst, X, y)
        assert abs(lt - lj) <= 0.01 * lj, (lt, lj)
    else:
        _assert_same_model(jb.model_to_string(), bst.model_to_string(),
                           1e-4)
    spec_bins = [int(b) for b in g._forced[1]]
    for tree in g.trees:
        applied = _forced_nodes(tree, _SPEC)
        assert len(applied) == 4
        feats = [int(tree.split_feature[n]) for n, _ in applied]
        assert feats == [3, 4, 1, 0]
        # BFS order of the spec: root, left, right, right-left
        assert [int(tree.threshold_bin[n]) for n, _ in applied] == \
            [spec_bins[i] for i in range(4)]
        # the true gains are kept (the rank keys are the prune's alone)
        assert float(tree.gain.abs().max()) < 1e20


def test_forced_mxu_booster_matches_pinned_jax(spec_path):
    check_forced_mxu_booster(_jax_pinned(spec_path, False), spec_path,
                             False)


@pytest.mark.parametrize("extra", [{"use_pallas": False}, {"max_bin": 511}])
def test_forced_portable_booster_matches_jax(spec_path, extra):
    """The port's portable grower (segment sums, or the scatter kernel's
    plain version at max_bin 511) against the unpinned JAX booster."""
    X, y = _data()
    p = dict(_BASE, forcedsplits_filename=spec_path, **extra)
    bst = _port_booster(X, y, p)
    assert bst.gbdt._hist_impl == ("scatter" if "use_pallas" in extra
                                   else "pallas")
    jb = _jax_booster(X, y, p, False)
    _assert_same_model(jb.model_to_string(), bst.model_to_string(), 1e-4)
    assert all(int(t.split_feature[0]) == 3 for t in bst.gbdt.trees)


def test_inapplicable_grandchild_stops_the_bfs(tmp_path):
    """A grandchild whose threshold lies past its feature's range sends
    every row left: its forced split cannot apply, that node splits on its
    own gain and its spec subtree (a further child) is never used; the
    rest of the spec applies. The MXU and the portable grower agree, and
    the portable one equals the JAX package's."""
    X, y = _data()
    spec = json.loads(json.dumps(_SPEC))
    spec["right"]["left"] = {"feature": 0, "threshold": 1e9,
                             "left": {"feature": 5, "threshold": 0.0}}
    p = dict(_BASE, forcedsplits_filename=_spec_file(tmp_path, spec),
             growth_overshoot=0.0)
    mxu = _port_booster(X, y, p)
    port = _port_booster(X, y, dict(p, use_pallas=False))
    jb = _jax_booster(X, y, p, False)
    _assert_same_model(jb.model_to_string(), port.model_to_string(), 1e-4)
    for bst in (mxu, port):
        for tree in bst.gbdt.trees:
            applied = _forced_nodes(tree, spec)
            feats = [int(tree.split_feature[n]) for n, _ in applied]
            assert feats[:3] == [3, 4, 1]
            rl = int(tree.left[int(tree.right[0])])
            # the grandchild's forced split did not apply: its own split
            # is gain-chosen, and the spec's feature-5 child is not forced
            b_rl = int(tree.threshold_bin[rl])
            assert not (int(tree.split_feature[rl]) == 0 and
                        b_rl == int(bst.gbdt._forced[1][3]))
    t_m, t_p = mxu.gbdt.trees[0], port.gbdt.trees[0]
    nn = int(t_m.num_nodes)
    for fld in ("split_feature", "threshold_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(t_m, fld)[:nn].numpy(),
                                      getattr(t_p, fld)[:nn].numpy(), fld)


@pytest.mark.parametrize("use_mxu", [True, False])
def test_forced_bundled_matches_jax(tmp_path, use_mxu):
    """Bundled data (EFB) with a forced split on a bundled sparse feature
    and one on a dense one: the port's segmented MXU path (the forced sums
    expanded from bundle space, efb_use_mxu) and its default portable path
    (expanded histograms) against the JAX package's default booster (its
    portable grower), both without the overshoot."""
    X, logit = _sparse_X(5, n=2500)
    y = (logit > np.median(logit)).astype(np.float32)
    spec = {"feature": 5, "threshold": 0.5,
            "right": {"feature": 0, "threshold": 0.5}}
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1, "forcedsplits_filename":
             _spec_file(tmp_path, spec), "efb_use_mxu": use_mxu}
    # the MXU grower grows the portable grower's tree without the
    # overshoot (batched passes, not the best-first replay)
    bst = _port_booster(X, y, dict(p, growth_overshoot=0.0))
    g = bst.gbdt
    assert g._efb is not None and g._efb.scan is not None
    assert g._hist_impl == ("mxu" if use_mxu else "scatter")
    jp = dict(p)
    del jp["efb_use_mxu"]
    jb = _jax_booster(X, y, jp, False)
    _assert_same_model(jb.model_to_string(), bst.model_to_string(), 1e-4)
    assert all(int(t.split_feature[0]) == 5 for t in g.trees)


@pytest.mark.parametrize("extra", [
    {}, {"use_quantized_grad": True},
    {"objective": "multiclass", "num_class": 3}])
def test_forced_train_equals_update(spec_path, extra):
    """train at fused_block_size 2 (the fused trainer, the spec held by
    its Grower) writes update()'s model text, exact, quantized and with
    3 class trees an iteration, every one of them under the spec."""
    X, y = _data()
    if "num_class" in extra:
        y = (y + (X[:, 2] > 0.5)).astype(np.float32)      # 3 classes
    p = dict(_BASE, forcedsplits_filename=spec_path, device_type="cpu",
             fused_block_size=2, **extra)
    trained = lgt.train(p, lgt.Dataset(X, label=y, params=p), 5)
    assert trained.gbdt.fused_stats
    assert len(trained.gbdt.trees) == 5 * extra.get("num_class", 1)
    for t in trained.gbdt.trees:
        assert [int(t.split_feature[n]) for n, _ in
                _forced_nodes(t, _SPEC)] == [3, 4, 1, 0]
    stepped = _port_booster(X, y, p, rounds=5)

    def strip(text):
        return re.sub(r"\[fused_block_size: .*\]\n", "", text)
    assert strip(trained.model_to_string()) == \
        strip(stepped.model_to_string())


def test_forced_split_survives_the_overshoot_prune():
    """A forced left child with a weak gain (feature 5, bin 1) is kept by
    the prune to 8 leaves of a tree overgrown to 16: the rank keys put
    the forced splits first. Ranked by the true gains, the same overgrown
    tree's replay drops it."""
    X, y = _data()
    ds = lgt.Dataset(X, label=y, params={"max_bin": 31}).binned
    n = ds.num_data
    grad = torch.as_tensor(-(y - y.mean()), dtype=torch.float32)
    ones = torch.ones(n)
    nb5 = int(ds.num_bins[5])
    forced = tuple(torch.tensor(a, dtype=torch.int32) for a in (
        [5, 5, 2], [nb5 // 2 - 1, 1, 3], [1, -1, -1], [2, -1, -1]))
    grower = grower_mxu.Grower(
        torch.as_tensor(ds.bins), torch.as_tensor(ds.num_bins),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical), num_leaves=8, max_depth=-1,
        hp=SplitHyperParams(), bmax=int(ds.num_bins.max()), forced=forced,
        overshoot=2.0)
    inputs, state = grower.start(grad, ones, ones, torch.ones(6))
    for _, fn in grower.scheduled():
        state = fn(inputs, state)

    def run(pass_idx):
        nonlocal state
        state = grower.fixup(inputs, state, pass_idx)
    grower.fixup_loop(lambda: bool(state.done), run)
    tree, _ = grower.finish(inputs, state)
    assert int(tree.num_leaves) == 8
    left, right = int(tree.left[0]), int(tree.right[0])
    assert [int(tree.split_feature[i]) for i in (0, left, right)] == \
        [5, 5, 2]
    assert int(tree.threshold_bin[left]) == 1
    # the forced splits keep their true gains
    grown = state.tree
    assert torch.equal(tree.gain[:3], grown.gain[[0, 1, 2]])
    # ranked by the true gains alone, the grown tree's node 1 (the forced
    # left child) is not selected
    sel, *_ = prune_best_first_ref(grown.left, grown.right, grown.parent,
                                   grown.gain, num_leaves=8)
    assert bool(state.was_forced[1]) and not bool(sel[1])
