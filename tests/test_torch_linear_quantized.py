"""Linear trees under quantized gradients: the port's booster against the
JAX booster pinned to its MXU grower in interpret mode (its quantized
kernels: a compile of their own). The trees grow on quantized gradients,
the leaf models fit the full-precision ones in both packages. Tree 0 is
held exactly in structure and within 1e-4 relative + 5e-5 in its values
and models (as test_torch_linear_booster.py); after it, the quantization
noise differs (ROADMAP C2: each tree's key folds in an f32 sum's bits),
so the training loss is held within 1% of the JAX package's. The labels
are multiples of 1/8 over 2048 rows, so boost_from_average and tree 0's
gradients, and with them its key, are exact in f32 in both packages (as
in test_torch_quantized.py)."""

import numpy as np

from tests.test_torch_linear_booster import (BASE, assert_same_models,
                                             jax_booster, piecewise,
                                             port_booster)
from tests.test_torch_one_thread import one_thread  # noqa: F401


def test_linear_quantized_booster_matches_pinned_jax():
    X, y = piecewise(2048)
    y = (np.round(y * 8) / 8).astype(np.float32)
    Xv, yv = piecewise(800, seed=1)
    params = dict(BASE, use_quantized_grad=True, linear_lambda=0.1)
    jb = jax_booster(X, y, Xv, yv, params)
    tb = port_booster(X, y, Xv, yv, params)
    assert all(lm is not None for lm in tb.gbdt.linear_models)
    assert_same_models(jb, tb, structure_trees=1)
    lj = np.mean((jb.predict(X) - y) ** 2)
    lt = np.mean((tb.predict(X) - y) ** 2)
    assert abs(lt - lj) <= 0.01 * lj, (lt, lj)
