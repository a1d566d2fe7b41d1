"""The PyTorch port end to end on the CPU against the JAX package.

Both packages train the same data with the same params: the JAX Booster on
its MXU growth path in Pallas interpret mode, the port on device_type=cpu
(its kernels' plain versions). Bin mappers and every tree's structure must
be identical; leaf values, gains and predictions agree to f32 summation
order (the JAX histograms sum double-bf16 channels, the port's float64).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.conftest import make_binary, make_regression

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VALUE_KEYS = ("leaf_value", "internal_value", "split_gain")
_STRUCT_KEYS = ("num_leaves", "num_cat", "split_feature", "threshold",
                "decision_type", "left_child", "right_child", "leaf_count",
                "internal_count", "cat_boundaries", "cat_threshold",
                "shrinkage")


def _params(objective):
    return {"objective": objective, "num_leaves": 15, "max_bin": 63,
            "verbosity": -1}


def _jax_booster(X, y, params, rounds):
    bst = lgb.Booster(dict(params, pipeline=False),
                      lgb.Dataset(X, label=y, params=params))
    g = bst.gbdt
    assert g._efb is None          # dense data: nothing bundled
    g._hist_impl = "mxu"           # the TPU growth path ...
    g._mxu_interpret = True        # ... in Pallas interpret mode
    for _ in range(rounds):
        bst.update()
    return bst


def _torch_booster(X, y, params, rounds):
    params = dict(params, device_type="cpu")
    return lgt.train(params, lgt.Dataset(X, label=y, params=params), rounds)


def _trees(model_str):
    """Per tree: {key: value string} of its block."""
    body = model_str.split("end of trees")[0]
    out = []
    for block in body.split("Tree=")[1:]:
        kv = dict(line.split("=", 1) for line in block.splitlines()[1:]
                  if "=" in line)
        out.append(kv)
    return out


def _assert_same_model(s_jax, s_torch):
    t_jax, t_torch = _trees(s_jax), _trees(s_torch)
    assert len(t_jax) == len(t_torch)
    for i, (a, b) in enumerate(zip(t_jax, t_torch)):
        assert set(a) == set(b), i
        for key in _STRUCT_KEYS:
            if key in a:
                assert a[key] == b[key], (i, key)
        for key in _VALUE_KEYS:
            if key in a:
                va = np.asarray(a[key].split(" "), np.float64)
                vb = np.asarray(b[key].split(" "), np.float64)
                # a split gain is a difference of leaf-gain terms as large
                # as the tree's largest gain, so its summation-order error
                # scales with that, not with the (smaller) gain itself
                atol = 1e-5 * (np.abs(va).max() if key == "split_gain"
                               else 1.0)
                np.testing.assert_allclose(vb, va, rtol=1e-4, atol=atol,
                                           err_msg=f"tree {i} {key}")


@pytest.mark.parametrize("objective,make", [("binary", make_binary),
                                            ("regression", make_regression)])
def test_train_matches_jax_package(objective, make, tmp_path):
    X, y = make(n=2000, f=10)
    params = _params(objective)
    b_jax = _jax_booster(X, y, params, 5)
    b_torch = _torch_booster(X, y, params, 5)
    m_jax = b_jax.train_set.binned.mappers
    m_torch = b_torch.train_set.binned.mappers
    assert [m.to_dict() for m in m_jax] == [m.to_dict() for m in m_torch]
    _assert_same_model(b_jax.model_to_string(), b_torch.model_to_string())
    # each tree's leaf values agree to ~1e-5 absolute (the bar above at
    # these leaf magnitudes); raw scores near zero inherit that absolute
    # error summed over the 5 trees
    for raw in (True, False):
        np.testing.assert_allclose(b_torch.predict(X, raw_score=raw),
                                   b_jax.predict(X, raw_score=raw),
                                   rtol=1e-5, atol=5e-5)
    # device scores agree with the host model (the node_values update)
    np.testing.assert_allclose(b_torch.gbdt.train_score.numpy(),
                               b_torch.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    # model text round trip inside the port
    path = tmp_path / "model.txt"
    b_torch.save_model(str(path))
    loaded = lgt.Booster(model_file=str(path))
    np.testing.assert_array_equal(loaded.predict(X), b_torch.predict(X))
    assert loaded.model_to_string() == b_torch.model_to_string()


def test_exact_leaves_hold_their_rows_sums():
    # at max_bin 15 a histogram cell sums thousands of rows and sibling
    # subtraction takes differences of such sums; every leaf value must
    # still be -G/H of the rows it holds (no regularisation here)
    X, y = make_binary(n=100_000, f=10)
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 15,
              "min_data_in_leaf": 20, "verbosity": -1, "device_type": "cpu"}
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    gbdt = bst.gbdt
    grown = []
    grow = gbdt._grow

    def kept_grow(grad, hess):
        tree, row_node = grow(grad, hess)
        grown.append((tree.leaf_value.numpy(), row_node.numpy(),
                      grad.numpy(), hess.numpy()))
        return tree, row_node
    gbdt._grow = kept_grow
    for _ in range(4):
        bst.update()
    for leaf_value, row_node, grad, hess in grown:
        m = leaf_value.shape[0]
        g = np.bincount(row_node, grad.astype(np.float64), m)
        h = np.bincount(row_node, hess.astype(np.float64), m)
        leaf = np.bincount(row_node, minlength=m) > 0
        np.testing.assert_allclose(leaf_value[leaf], -g[leaf] / h[leaf],
                                   rtol=1e-4, atol=1e-5)


def test_import_leaves_jax_out():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'lightgbm_tpu.')) or "
            "m == 'lightgbm_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for bad in ("import jax", "from jax", "lightgbm_tpu ", "lightgbm_tpu.",
                "import lightgbm_tpu\n"):
        assert bad not in src, bad


def test_train_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = make_binary(n=200, f=4)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(X, label=y), 1)


@pytest.mark.parametrize("extra", [
    {"monotone_constraints": [1, 0, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"monotone_constraints": [1, 0, 0, 0],
     "monotone_constraints_method": "advanced"},
    {"cegb_penalty_feature_coupled": [1.0, 0.0, 0.0, 0.0]},
    {"use_pallas": False},
    {"guard_nonfinite": "raise"},
    {"forcedsplits_filename": "forced.json"},
    {"cegb_penalty_split": 1.0},
    {"linear_tree": True},
    {"gpu_use_dp": False},
    {"level_pipeline": True},
    {"tree_learner": "data"},
])
def test_unsupported_params_raise(extra):
    X, y = make_binary(n=200, f=4)
    params = dict({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu"}, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP.md port queue"):
        lgt.train(params, lgt.Dataset(X, label=y), 1)


def test_valid_sets_and_callbacks_raise():
    """Valid sets and callbacks train (tests/test_torch_valid.py); what
    stays unported around them refuses, naming its queue item: the
    checkpoint callback and checkpoint_period with checkpoint_dir (A9),
    resume_from (A9)."""
    X, y = make_binary(n=200, f=4)
    ds = lgt.Dataset(X, label=y)
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1}
    with pytest.raises(NotImplementedError, match="A9"):
        lgt.callback.checkpoint(5, "ckpt")
    with pytest.raises(NotImplementedError, match="A9"):
        lgt.train(params, ds, 1, resume_from="ckpt")
    with pytest.raises(NotImplementedError, match="A9"):
        lgt.train(dict(params, checkpoint_period=5, checkpoint_dir="ckpt"),
                  ds, 1)
