"""The growth passes run no op that would make the host wait for the card.

A TorchDispatchMode watches one grow_tree_mxu call on the CPU and counts
the ops that sync on a CUDA device — reading a value back
(aten._local_scalar_dense: item, int, bool), selecting by a mask
(aten.nonzero, aten.masked_select, indexing or writing with a boolean
index), output sizes that depend on the data (aten.bincount,
aten.repeat_interleave without its size, aten.unique*) — and host data
made into a tensor (aten.lift_fresh*: torch.tensor, or a Python scalar
written by indexing), which on the card is a copy from the host that a
CUDA graph capture refuses. The kernels' plain versions (`*_ref`, what a
wrapper runs on the CPU; the card runs the kernel) are not watched.
Expected: none inside a pass, the prologue or the epilogue; around them
exactly the fix-up loop's reads of `done` (Grower.fixup_loop), one before
each fix-up pass, which the runs below need. The fused trainer's programs
(boosting/fused.py, what its CUDA graphs capture) are watched the same
way over a block of trees: none inside any program. The efb* configurations
train on sparse, mutually exclusive features that the booster bundles
(exclusive feature bundling): the bundle-range routing and the segmented
scan, or the loc-table routing and the per-pass expansion. The forced*
configurations grow under a nested forced-split spec: its tensors and the
forced node state ride every pass and program.
"""

import json

import collections
import functools
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting import fused
from lightgbm_tpu_torch.learner import grower_mxu
from lightgbm_tpu_torch.learner import histogram_mxu, histogram_pallas
from lightgbm_tpu_torch.learner import prune, split_kernel
from tests.test_torch_one_thread import one_thread  # noqa: F401

_SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "bincount",
             "repeat_interleave", "unique", "_unique", "_unique2",
             "unique_dim", "unique_consecutive", "lift_fresh",
             "lift_fresh_copy"}
_REFS = [(histogram_mxu, n) for n in (
    "fused_route_hist_ref", "route_rows_ref", "build_histograms_ref",
    "node_values_ref", "node_sums_ref")] + [
    (histogram_pallas, "build_histograms_scatter_ref"),
    (histogram_pallas, "partition_rows_ref"),
    (split_kernel, "find_best_splits_kernel_ref"),
    (prune, "prune_best_first_ref")]


def _bool_index(args) -> bool:
    """An index or index_put whose indices hold a boolean tensor."""
    idx = args[1] if len(args) > 1 else ()
    return isinstance(idx, (list, tuple)) and any(
        isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in idx)


class _SyncCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.where = "outside"
        self.quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.quiet:
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _SYNC_OPS or (name in ("index", "index_put") and
                                     _bool_index(args)):
                self.counts[(self.where, name)] += 1
        return func(*args, **(kwargs or {}))


def _quiet(mode, fn):
    @functools.wraps(fn)
    def run(*a, **k):
        mode.quiet += 1
        try:
            return fn(*a, **k)
        finally:
            mode.quiet -= 1
    return run


def _within(mode, where, fn):
    @functools.wraps(fn)
    def run(*a, **k):
        outer, mode.where = mode.where, where
        try:
            return fn(*a, **k)
        finally:
            mode.where = outer
    return run


_CONFIGS = {
    "exact": {},
    "quantized": {"use_quantized_grad": True},
    "constrained": {"monotone_constraints": [1, -1, 0, 0, 0, 0],
                    "interaction_constraints": [[0, 1, 2], [3, 4, 5]],
                    "feature_fraction": 0.8,
                    "feature_fraction_bynode": 0.8, "extra_trees": True},
    "quantized_pallas": {"use_quantized_grad": True,
                         "hist_backend": "pallas", "max_bin": 15},
    # efb_use_mxu: bundled data on the MXU grower and the fused trainer
    "efb": {"max_bin": 15, "efb_use_mxu": True},
    "efb_expansion": {"max_bin": 15, "efb_segmented_scan": False,
                      "efb_use_mxu": True},
    "forced": {"forced": True},
    "forced_quantized": {"forced": True, "use_quantized_grad": True},
}
# a root on feature 0, both children, one grandchild
_SPEC = {"feature": 0, "threshold": 0.0,
         "left": {"feature": 1, "threshold": 0.2,
                  "right": {"feature": 2, "threshold": -0.1}},
         "right": {"feature": 3, "threshold": 0.1}}


def _spec_file() -> str:
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as fh:
        json.dump(_SPEC, fh)
    return path


def _booster(name):
    rng = np.random.RandomState(9)
    X = rng.randn(2000, 6).astype(np.float32)
    if name.startswith("efb"):
        # 24 sparse features, one nonzero in each group of 8 a row
        sparse = np.zeros((2000, 24), np.float32)
        for g in range(0, 24, 8):
            sparse[np.arange(2000), rng.randint(g, g + 8, 2000)] = \
                rng.rand(2000) + 0.5
        X = np.concatenate([X[:, :2], sparse], axis=1)
    y = ((X[:, 0] + X[:, 1] + 0.3 * rng.randn(2000)) > 0.5) \
        .astype(np.float32)
    # 15 leaves of >= 40 rows: trees that need fix-up passes after the
    # bridge, so the loop reads `done` more than once
    params = dict({"objective": "binary", "num_leaves": 15,
                   "min_data_in_leaf": 40, "max_bin": 31, "verbosity": -1,
                   "device_type": "cpu"}, **_CONFIGS[name])
    spec = params.pop("forced", False) and _spec_file()
    if spec:
        params["forcedsplits_filename"] = spec
    try:
        bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    finally:
        if spec:
            os.remove(spec)
    assert (bst.gbdt._efb is not None) == name.startswith("efb")
    assert (bst.gbdt._forced is not None) == name.startswith("forced")
    bst.update()
    return bst


def _watch(monkeypatch):
    """A counter whose plain-version calls are not watched."""
    mode = _SyncCounter()
    for mod, ref in _REFS:
        monkeypatch.setattr(mod, ref, _quiet(mode, getattr(mod, ref)))
    return mode


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_growth_passes_do_not_sync(name, monkeypatch):
    bst = _booster(name)
    g = bst.gbdt
    grad, hess = g.objective.get_gradients(g.train_score)
    args = (grad, hess, g._cnt, g._feature_mask_at(1), g._tree_key(1))

    mode = _watch(monkeypatch)
    # the Grower is built once a booster (its interaction groups go to
    # the device there): not counted with the growth
    for meth, where in (("__init__", "setup"), ("one_pass", "pass"),
                        ("start", "start"), ("finish", "finish")):
        monkeypatch.setattr(grower_mxu.Grower, meth,
                            _within(mode, where,
                                    getattr(grower_mxu.Grower, meth)))
    with mode:
        grower = grower_mxu.Grower(g.bins, g.num_bins_d, g.missing_is_nan_d,
                                   g.is_cat_d, **g._mxu_grow_kwargs())
        tree, _ = grower.grow(*args)
    passes, reads = grower.last_fixups
    assert int(tree.num_leaves) > 1
    assert reads == passes + 1
    if name == "exact":
        assert passes >= 1
    inside = {k: v for k, v in mode.counts.items()
              if k[0] not in ("outside", "setup")}
    assert inside == {}, inside
    assert ("setup", "_local_scalar_dense") not in mode.counts
    outside = {k: v for k, v in mode.counts.items() if k[0] == "outside"}
    assert outside == {("outside", "_local_scalar_dense"): reads}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_fused_programs_do_not_sync(name, monkeypatch):
    bst = _booster(name)
    mode = _watch(monkeypatch)
    monkeypatch.setattr(fused.FusedTrainer, "_run", _within(
        mode, "program", fused.FusedTrainer._run))
    with mode:
        bst.update_batch(4)
    stats = bst.gbdt._fused_run.stats
    assert stats["trees"] == 4
    inside = {k: v for k, v in mode.counts.items() if k[0] != "outside"}
    assert inside == {}, inside
    # outside the programs: the fix-up loop's reads of `done`
    assert mode.counts[("outside", "_local_scalar_dense")] == \
        sum(stats["fixup_reads"])
