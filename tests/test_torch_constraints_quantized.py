"""Quantized growth and quantized training under the split-search
options against the JAX package (its grower and booster in Pallas
interpret mode), at the bars of tests/test_torch_constraints.py, whose
helpers these tests use: in a file of their own so that --dist loadfile
spreads the JAX interpret compiles."""

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from tests.conftest import make_binary
from tests.test_torch_constraints import (_ALL_OPTIONS, _OPTIONS,
                                          _grow_both, assert_same_tree)
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_quantized import _dyadic_problem
from tests.test_torch_train import _jax_booster


@pytest.mark.parametrize("name", ["monotone", "all"])
def test_quantized_grower_options_match_jax(name):
    ds, grad, hess = _dyadic_problem(3000, 6, seed=4, const_hess=False)
    want, r_want, got, r_got = _grow_both(ds, grad, hess, _OPTIONS[name],
                                          quantized=True)
    assert_same_tree(want, r_want, got, r_got, ds, quantized=True)
    leaf = got.is_leaf.numpy()
    value = got.leaf_value.numpy()[leaf]
    free = value == -got.sum_grad.numpy()[leaf] / got.sum_hess.numpy()[leaf]
    assert free.sum() >= 5 and (~free).sum() >= 1   # both kinds of leaf


def test_quantized_train_all_options_match_jax_package():
    # quantized training under every option at once, held as
    # test_quantized_booster_matches_jax_package holds quantized training:
    # after the first tree each tree's rounding key folds in the bits of
    # an f32 sum(grad) that torch and XLA add in different orders, so the
    # trees may differ and the training losses agree to 1%
    X, y = make_binary(n=2000, f=10)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1, "use_quantized_grad": True},
                  **_ALL_OPTIONS)
    b_jax = _jax_booster(X, y, params, 3)
    p = dict(params, device_type="cpu")
    b_torch = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)

    def logloss(b):
        prob = np.clip(b.predict(X), 1e-15, 1 - 1e-15)
        return float(-np.mean(y * np.log(prob) + (1 - y) * np.log(1 - prob)))
    loss_jax, loss_torch = logloss(b_jax), logloss(b_torch)
    assert abs(loss_torch - loss_jax) <= 0.01 * loss_jax, (loss_torch,
                                                           loss_jax)
    assert loss_torch < 0.95 * np.log(2.0)
    np.testing.assert_allclose(b_torch.gbdt.train_score.numpy(),
                               b_torch.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
