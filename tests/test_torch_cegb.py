"""Cost-effective gradient boosting (cegb_*) in the port against the JAX
package, on the CPU.

Boosters of 3 update() calls on make_binary(3000 x 6), num_leaves 15,
max_bin 31:

- split + coupled CEGB (a coupled penalty of 1e6 on feature 1) on the
  MXU grower against the JAX booster pinned to its MXU grower in
  interpret mode (the file's one compile): identical structure, values
  within 1e-4, and the feature-used flags carried across the trees equal
  (split-only CEGB: test_torch_cegb_split.py, whose static CEGB settings
  make another compile);
- lazy CEGB (cegb_penalty_feature_lazy), which grows on the portable
  grower, against the unpinned JAX booster (its CPU path is the portable
  grower), on the scatter kernel's plain version and on the segment sums;
- a per-feature list of the wrong length raises the JAX package's
  ValueError; CEGB keeps the booster off the fused trainer; the split
  scan kernel K8 never runs under a gain penalty.
"""

import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.learner import grower_mxu
from lightgbm_tpu_torch.learner.grower import CegbParams, CegbState
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from tests.conftest import make_binary
from tests.test_torch_efb import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

_ROUNDS = 3
_BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
         "min_data_in_leaf": 5, "verbosity": -1}
_CONFIGS = {
    "split": {"cegb_penalty_split": 0.002},
    "coupled": {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.001,
                "cegb_penalty_feature_coupled": [0.0, 1e6, 0.0, 5.0, 0.0,
                                                 2.0]},
}
_LAZY = {"cegb_penalty_feature_lazy": [0.01, 0.0, 0.02, 0.0, 0.01, 0.0],
         "cegb_penalty_split": 0.001}


def _data():
    return make_binary(n=3000, f=6)


def _jax_booster(X, y, params, pinned):
    jb = lgb.Booster(dict(params, pipeline=False),
                     lgb.Dataset(X, label=y, params=params))
    if pinned:
        jb.gbdt._hist_impl = "mxu"
        jb.gbdt._mxu_interpret = True
    for _ in range(_ROUNDS):
        jb.update()
    return jb


def _port_booster(X, y, params):
    p = dict(params, device_type="cpu")
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for _ in range(_ROUNDS):
        bst.update()
    return bst


def check_cegb_mxu_booster(name):
    """The port's MXU-grower booster under _CONFIGS[name] against the JAX
    booster pinned to its MXU grower: the same model and the same
    feature-used flags after the last tree."""
    X, y = _data()
    jb = _jax_booster(X, y, dict(_BASE, **_CONFIGS[name]), True)
    bst = _port_booster(X, y, dict(_BASE, **_CONFIGS[name]))
    g = bst.gbdt
    assert g._hist_impl == "mxu" and g._cegb_cfg is not None
    _assert_same_model(jb.model_to_string(), bst.model_to_string(), 1e-4)
    # the feature-used flags, carried across the trees
    np.testing.assert_array_equal(g._cegb_state.feat_used.numpy(),
                                  np.asarray(jb.gbdt._cegb_state[2]))
    if name == "coupled":
        assert g._cegb_state.feat_used.any()
        for tree in g.trees:
            nn = int(tree.num_nodes)
            assert not (tree.split_feature[:nn] == 1).any()


def test_cegb_mxu_booster_matches_pinned_jax():
    check_cegb_mxu_booster("coupled")


@pytest.mark.parametrize("extra", [{}, {"use_pallas": False}])
def test_lazy_cegb_portable_booster_matches_jax(extra, caplog):
    """Lazy CEGB excludes the MXU grower (with the JAX package's warning)
    and grows on the portable one: the scatter kernel's plain version, or
    the segment sums."""
    X, y = _data()
    p = dict(_BASE, **_LAZY, **extra)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bst = _port_booster(X, y, dict(p, verbosity=0))
    g = bst.gbdt
    assert g._hist_impl == ("scatter" if extra else "pallas")
    if not extra:
        assert g._mxu_exclusions() == ["cegb_penalty_feature_lazy"]
        assert "cegb_penalty_feature_lazy" in " ".join(
            r.getMessage() for r in caplog.records)
    jb = _jax_booster(X, y, p, False)
    _assert_same_model(jb.model_to_string(), bst.model_to_string(), 1e-4)
    st = g._cegb_state
    for got, want in zip((st.feat_used, st.row_feat_used),
                         jb.gbdt._cegb_state[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.row_feat_used.shape == (3000, 6) and st.row_feat_used.any()


@pytest.mark.parametrize("key", ["cegb_penalty_feature_coupled",
                                 "cegb_penalty_feature_lazy"])
def test_wrong_length_penalty_raises(key):
    X, y = _data()
    p = dict(_BASE, device_type="cpu", **{key: [1.0, 2.0]})
    with pytest.raises(ValueError, match="cegb per-feature penalty has 2 "
                       "entries but the dataset has 6 features"):
        lgt.Booster(p, lgt.Dataset(X, label=y, params=p))


def test_cegb_is_not_fused():
    """CEGB's feature-used flags carry from tree to tree: train runs one
    iteration a dispatch, with update()'s model."""
    X, y = _data()
    p = dict(_BASE, device_type="cpu", fused_block_size=3,
             **_CONFIGS["coupled"])
    trained = lgt.train(p, lgt.Dataset(X, label=y, params=p), _ROUNDS)
    assert not trained.gbdt._fused_eligible()
    assert not trained.gbdt.fused_stats
    stepped = _port_booster(X, y, p)
    assert trained.model_to_string() == stepped.model_to_string()


def test_gain_penalty_keeps_the_scan_kernel_out(monkeypatch):
    """use_scan_kernel=True with a CEGB penalty scans with
    find_best_splits (K8 takes no penalty), as the JAX package does."""
    X, y = _data()
    ds = lgt.Dataset(X, label=y, params={"max_bin": 31}).binned
    n = ds.num_data

    def refuse(*a, **k):
        raise AssertionError("K8 under a gain penalty")
    monkeypatch.setattr(grower_mxu, "find_best_splits_kernel", refuse)
    grad = torch.as_tensor(-(y - y.mean()), dtype=torch.float32)
    ones = torch.ones(n)
    cfg = CegbParams(tradeoff=1.0, penalty_split=0.01, has_coupled=True)
    state = CegbState(torch.tensor([0.0, 1e6, 0.0, 0.0, 0.0, 0.0]),
                      torch.zeros(6), torch.zeros(6, dtype=torch.bool),
                      torch.zeros((1, 1), dtype=torch.bool))
    tree, _ = grower_mxu.grow_tree_mxu(
        torch.as_tensor(ds.bins), grad, ones, ones, torch.ones(6),
        torch.as_tensor(ds.num_bins),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical), num_leaves=15, max_depth=-1,
        hp=SplitHyperParams(), bmax=int(ds.num_bins.max()),
        use_scan_kernel=True, cegb_cfg=cfg, cegb_state=state)
    nn = int(tree.num_nodes)
    assert int(tree.num_leaves) > 1
    assert not (tree.split_feature[:nn] == 1).any()
    assert state.feat_used.any() and not bool(state.feat_used[1])
