"""Linear trees on the binary objective: the port's booster against the
JAX booster pinned to its MXU grower in interpret mode (a compile of its
own: the binary hessians are not constant). The same bars as
test_torch_linear_booster.py: every tree's structure and leaf features
identical, leaf values and models within 1e-4 relative + 5e-5 (f32 sums
and solve against fixed-point sums and a float64 solve), valid scores and
predictions within 1e-4."""

import numpy as np

from tests.test_torch_linear_booster import (BASE, assert_same_models,
                                             binary_rows, jax_booster,
                                             port_booster)
from tests.test_torch_one_thread import one_thread  # noqa: F401


def test_linear_binary_booster_matches_pinned_jax():
    X, y = binary_rows()
    Xv, yv = binary_rows(800, seed=3)
    params = dict(BASE, objective="binary", linear_lambda=0.1)
    jb = jax_booster(X, y, Xv, yv, params)
    tb = port_booster(X, y, Xv, yv, params)
    assert_same_models(jb, tb)
    np.testing.assert_allclose(
        tb.gbdt.valid_scores[0].numpy(),
        np.asarray(jb.gbdt.valid_scores[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), rtol=1e-4,
                               atol=1e-4)
