"""The fused best-split scan (K8) against the JAX package, on the CPU.

The port's wrapper split_kernel.find_best_splits_kernel runs its plain
version (find_best_splits_kernel_ref) on CPU tensors; it is held against
the JAX find_best_splits_kernel in Pallas interpret mode and against the
port's own split.find_best_splits, the relation the JAX package's
tests/test_mxu_kernels.py holds its kernel to. Selections (feature,
threshold, NaN direction) must be identical; picked sums within rtol 2e-5
/ atol 1e-5 of the JAX kernel's, gains and outputs within that bar of the
port's scan. Against the JAX kernel, gains and outputs hold to rtol 1e-4:
its CPU prefix sums (a triangular matmul) are an ulp or so off the float64
sums rounded once, and a near-empty right child (parent minus prefix)
multiplies that in its output and gain.

Then grow_tree_mxu(use_scan_kernel=True) against use_scan_kernel=False and
against the JAX grower with the scan kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu.learner.split import SplitHyperParams as JaxHP
from lightgbm_tpu.learner.split_kernel import \
    find_best_splits_kernel as jax_kernel
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner import split_kernel as sk
from lightgbm_tpu_torch.learner.split import SplitHyperParams
from lightgbm_tpu_torch.learner.split import find_best_splits
from tests.test_torch_constraints import assert_same_tree
from tests.test_torch_grower import _data
from tests.test_torch_one_thread import one_thread  # noqa: F401

_S, _F, _B = 6, 5, 31
_CASES = ("plain", "nan", "mono", "mono_nan", "slot_masks",
          "l1_max_delta_smooth", "mono_penalty_depth", "integer_hist",
          "masked_slot")


def _inputs(case):
    """(args, hp kwargs, monotone kwargs) of one case, numpy arrays; the
    histograms of tests/test_mxu_kernels.py's scan-kernel test, with
    signed gradients so that the monotone cases split too."""
    r = np.random.RandomState(3)
    hist = np.abs(r.rand(_S, _F, _B, 3)) * np.array([1.0, 1.0, 50.0])
    if case == "integer_hist":
        # quantized-like: integer gradient, hessian and count sums
        hist = np.stack([r.randint(-40, 41, (_S, _F, _B)),
                         r.randint(1, 9, (_S, _F, _B)),
                         r.randint(1, 9, (_S, _F, _B))], -1).astype(float)
        # every feature a shuffle of feature 0's bins: the slot totals
        # hold for each
        for j in range(1, _F):
            hist[:, j] = hist[:, 0, r.permutation(_B)]
        tot = hist[:, 0].sum(1)
    else:
        tot = hist.sum(2).mean(1)
        hist = hist / hist.sum(2, keepdims=True) * tot[:, None, None, :]
        # signed gradients, every feature still summing to the slot's total
        hist[..., 0] -= 0.9 * hist[..., 0].mean(2, keepdims=True)
        tot = hist[:, 0].sum(1)
    hist = hist.astype(np.float32)
    fmask = np.ones(_F, np.float32)
    if case in ("slot_masks", "masked_slot"):
        fmask = (np.random.RandomState(4).rand(_S, _F) < 0.7) \
            .astype(np.float32)
        if case == "masked_slot":
            fmask[2] = 0.0                     # a slot with no feature left
    mnan = np.array([case in ("nan", "mono_nan", "slot_masks",
                              "l1_max_delta_smooth", "masked_slot")] * 2 +
                    [False] * (_F - 2))
    args = (hist, tot[:, 0].astype(np.float32), tot[:, 1].astype(np.float32),
            tot[:, 2].astype(np.float32),
            (np.random.RandomState(6).randn(_S) * 0.1).astype(np.float32),
            np.full(_F, _B, np.int32), mnan, np.zeros(_F, bool), fmask)
    hp = dict(min_data_in_leaf=3)
    if case == "l1_max_delta_smooth":
        hp.update(lambda_l1=0.05, lambda_l2=0.5, max_delta_step=0.4,
                  path_smooth=2.0, min_gain_to_split=0.01)
    mono = {}
    if case in ("mono", "mono_nan", "mono_penalty_depth"):
        hp.update(has_monotone=True,
                  monotone_penalty=1.5 if case == "mono_penalty_depth"
                  else 0.0)
        mono = dict(monotone=np.array([1, -1, 0, 0, 0], np.int32),
                    cons_min=np.full(_S, -0.5, np.float32),
                    cons_max=np.full(_S, 0.5, np.float32),
                    depth=np.arange(_S, dtype=np.int32))
    return args, hp, mono


def _both(case):
    args, hp, mono = _inputs(case)
    want = jax_kernel(*map(jnp.asarray, args), JaxHP(**hp), interpret=True,
                      **{k: jnp.asarray(v) for k, v in mono.items()})
    targs = tuple(map(torch.as_tensor, args))
    tmono = {k: torch.as_tensor(v) for k, v in mono.items()}
    got = sk.find_best_splits_kernel(*targs, SplitHyperParams(**hp), **tmono)
    return got, want, targs, SplitHyperParams(**hp), tmono


@pytest.mark.parametrize("case", _CASES)
def test_kernel_matches_jax_kernel(case):
    got, want, _, _, _ = _both(case)
    for fld in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), fld)
    for fld in ("left_grad", "left_hess", "left_count"):
        np.testing.assert_allclose(getattr(got, fld).numpy(),
                                   np.asarray(getattr(want, fld)),
                                   rtol=2e-5, atol=1e-5, err_msg=fld)
    for fld in ("gain", "left_output", "right_output"):
        np.testing.assert_allclose(getattr(got, fld).numpy(),
                                   np.asarray(getattr(want, fld)),
                                   rtol=1e-4, atol=1e-5, err_msg=fld)
    has = got.feature.numpy() >= 0
    assert has.sum() >= 3                            # real splits happen
    if case == "masked_slot":
        # the junk slot: no split, bin 0, NaN-left (-inf >= -inf), -inf gain
        assert not has[2] and int(got.threshold_bin[2]) == 0
        assert bool(got.default_left[2]) and got.gain[2] == -np.inf


@pytest.mark.parametrize("case", _CASES)
def test_kernel_matches_port_scan(case):
    got, _, targs, hp, tmono = _both(case)
    want = find_best_splits(*targs, hp, **tmono)
    for fld in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      getattr(want, fld).numpy(), fld)
    for fld in ("gain", "left_grad", "left_hess", "left_count",
                "left_output", "right_output"):
        np.testing.assert_allclose(getattr(got, fld).numpy(),
                                   getattr(want, fld).numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=fld)


def test_ref_emits_the_selection_only():
    args, hp, mono = _inputs("mono_nan")
    targs = tuple(map(torch.as_tensor, args))
    hp = SplitHyperParams(**hp)
    tmono = {k: torch.as_tensor(v) for k, v in mono.items()}
    tables = sk.pack_inputs(*targs[1:], hp, **tmono)
    out = sk.find_best_splits_kernel_ref(targs[0], *tables, hp)
    assert out.shape == (_S, sk.N_OUT) and out.dtype == torch.float32
    best = sk.find_best_splits_kernel(*targs, hp, **tmono)
    np.testing.assert_array_equal(out[:, sk.O_FEAT].numpy(),
                                  best.feature.numpy())
    nal = out[:, sk.O_NAL] > 0.5
    left = torch.where(nal[:, None], out[:, sk.O_LL:sk.O_LL + 3],
                       out[:, sk.O_LR:sk.O_LR + 3])
    np.testing.assert_array_equal(left[:, 0].numpy(),
                                  best.left_grad.numpy())
    assert (out[:, sk.O_LL + 3:] == 0).all()
    # the monotone mode needs the constraints; without them the plain
    # gain forms run, as in the JAX wrapper
    _, _, _, mono_tbl = sk.pack_inputs(*targs[1:], hp)
    assert mono_tbl is None


def _grow(ds, grad, hess, hp, scan_kernel, **extra):
    kw = dict(num_leaves=15, max_depth=0, bmax=int(ds.num_bins.max()))
    t, r = torch_grower.grow_tree_mxu(
        torch.as_tensor(ds.bins), torch.as_tensor(grad),
        torch.as_tensor(hess), torch.ones(ds.num_data),
        torch.ones(ds.num_features), torch.as_tensor(ds.num_bins),
        torch.as_tensor(ds.missing_types == 2),
        torch.as_tensor(ds.is_categorical), hp=hp,
        use_scan_kernel=scan_kernel, **kw, **extra)
    return t, r.numpy()


def test_grower_with_scan_kernel_matches():
    # tests/test_mxu_kernels.py's grower case: the port's scan kernel
    # against its plain scan and against the JAX grower's scan kernel
    ds, grad, hess = _data(3000, 6, seed=9, with_nan=True)
    hp = SplitHyperParams(min_data_in_leaf=20)
    t0, r0 = _grow(ds, grad, hess, hp, False)
    t1, r1 = _grow(ds, grad, hess, hp, True)
    nn = int(t0.num_nodes)
    assert int(t1.num_nodes) == nn and int(t1.num_leaves) == 15
    for fld in ("split_feature", "threshold_bin", "default_left", "left",
                "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(t1, fld)[:nn].numpy(),
                                      getattr(t0, fld)[:nn].numpy(), fld)
    np.testing.assert_allclose(t1.leaf_value[:nn].numpy(),
                               t0.leaf_value[:nn].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(r1, r0)

    t_jax, r_jax = jax_grower.grow_tree_mxu(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(ds.num_data, jnp.float32),
        jnp.ones(ds.num_features, jnp.float32), jnp.asarray(ds.num_bins),
        jnp.asarray(ds.missing_types == 2), jnp.asarray(ds.is_categorical),
        num_leaves=15, max_depth=0, hp=JaxHP(min_data_in_leaf=20),
        bmax=int(ds.num_bins.max()), interpret=True, use_scan_kernel=True)
    want = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in t_jax._asdict().items()})
    assert_same_tree(want, np.asarray(r_jax), t1, r1, ds, leaf_rtol=0.0)


def test_grower_scan_kernel_with_constraints_matches_jax():
    # monotone constraints, per-slot masks from bynode sampling and
    # interaction groups, all through the kernel
    from tests.test_torch_constraints import _OPTIONS, _grow_both
    ds, grad, hess = _data(3000, 6, seed=2, with_nan=True)
    option = dict(_OPTIONS["all"], hp=dict(has_monotone=True,
                                           monotone_penalty=0.5))
    want, r_want, got, r_got = _grow_both(ds, grad, hess, option,
                                          scan_kernel=True)
    assert_same_tree(want, r_want, got, r_got, ds, leaf_rtol=0.0)


@pytest.mark.parametrize("setting,kernel_passes", [
    ("numerical", True), ("extra_trees", False), ("categorical", False)])
def test_grower_dispatch(monkeypatch, setting, kernel_passes):
    # the kernel scans every pass it covers: numerical features without
    # extra_trees' random thresholds; otherwise split.find_best_splits
    calls = {"kernel": 0, "scan": 0}
    kernel, scan = torch_grower.find_best_splits_kernel, \
        torch_grower.find_best_splits

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(torch_grower, "find_best_splits_kernel",
                        count("kernel", kernel))
    monkeypatch.setattr(torch_grower, "find_best_splits", count("scan", scan))
    ds, grad, hess = _data(2000, 6, seed=5,
                           with_cat=setting == "categorical")
    hp = SplitHyperParams(extra_trees=setting == "extra_trees",
                          has_categorical=setting == "categorical")
    t, _ = _grow(ds, grad, hess, hp, True,
                 rng_key=convert.key_from_numpy(np.asarray(
                     jax.random.PRNGKey(1))))
    assert int(t.num_leaves) == 15
    total = calls["kernel"] + calls["scan"]
    assert total >= 4
    assert calls["kernel"] == (total if kernel_passes else 0)
