"""The EFB boosters of tests/test_torch_efb_boosters.py at
min_gain_to_split 0, against the JAX package's bundled booster (its MXU
grower in Pallas interpret mode).

On this data some nodes are pure: every row has one gradient to hessian
ratio (one label at one score), so every split's true gain is 0, and its
f32 gain comes out as one or two ulps of the node's own gain (G^2 / H),
positive or not as the order of the sums goes. Either package may take
such a split where the other does not; the split uses up growth budget,
and the trees part from there on (ROADMAP C3). Here the split finders of
both packages are wrapped (test-side, the packages unchanged) to refuse
a split whose gain is at most two f32 ulps of its node's gain. With that
alone, the models are identical in structure, within 1e-4 in values
(tests/test_torch_train.py's exact-mode bars), and send every training
row to the same leaf of every tree. Unwrapped, the four cases in _PARTS
part at such nodes (the port refuses at least one split there). The
cases in _MORE run in tests/test_torch_efb_min_gain_more.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.learner.grower_mxu as jax_grower
import lightgbm_tpu.learner.split_bundled as jax_split_bundled
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from tests.test_torch_efb import _assert_same_model, _port_booster
from tests.test_torch_efb_boosters import _BOOSTERS, _case, _jax_booster
from tests.test_torch_one_thread import one_thread  # noqa: F401

ULPS = 2
_PARTS = {"dart", "expansion", "multiclass", "nan_cat"}
_FINDERS = ("find_best_splits", "find_best_splits_kernel")


def _refusing_torch(fn, refused):
    def wrapped(*args, **kw):
        best = fn(*args, **kw)
        shift = (args[1] * args[1] / args[2]).abs()
        ulp = torch.nextafter(shift, torch.full_like(shift, np.inf)) - shift
        zero = (best.gain > 0) & (best.gain <= ULPS * ulp)
        refused.append(int(zero.sum()))
        return best._replace(gain=torch.where(zero, -np.inf, best.gain))
    return wrapped


def _refusing_jax(fn):
    def wrapped(*args, **kw):
        best = fn(*args, **kw)
        shift = jnp.abs(args[1] * args[1] / args[2])
        ulp = jnp.nextafter(shift, jnp.inf) - shift
        zero = (best.gain > 0) & (best.gain <= ULPS * ulp)
        return best._replace(gain=jnp.where(zero, -jnp.inf, best.gain))
    return wrapped


@pytest.fixture
def refuse_zero_gain(monkeypatch):
    """Both packages' split finders refuse the pure nodes' splits; yields
    the port's refusal counts. The JAX package's traced programs are
    cleared before and after, so none of them outlives the wrapper."""
    refused = []
    for name in _FINDERS + ("find_best_splits_bundled",):
        monkeypatch.setattr(torch_grower, name, _refusing_torch(
            getattr(torch_grower, name), refused))
    for name in _FINDERS:
        monkeypatch.setattr(jax_grower, name,
                            _refusing_jax(getattr(jax_grower, name)))
    monkeypatch.setattr(jax_split_bundled, "find_best_splits_bundled",
                        _refusing_jax(
                            jax_split_bundled.find_best_splits_bundled))
    jax.clear_caches()
    yield refused
    monkeypatch.undo()
    jax.clear_caches()


# the cases that run in tests/test_torch_efb_min_gain_more.py, so that
# --dist loadfile spreads their JAX interpret compiles
_MORE = ("multiclass", "quantized", "regression")


def _min_gain_case(name, refuse_zero_gain):
    """test_min_gain_zero_parts_only_at_pure_nodes's body."""
    X, y, params, rounds = _case(name, min_gain_to_split=0.0)
    bst = _port_booster(X, y, params, rounds)
    assert bst.gbdt._efb is not None
    jbst = _jax_booster(X, y, params, rounds)
    _assert_same_model(jbst.model_to_string(), bst.model_to_string(), 1e-4)
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  jbst.predict(X, pred_leaf=True))
    if name in _PARTS:
        assert sum(refuse_zero_gain) > 0


@pytest.mark.parametrize("name", [n for n in sorted(_BOOSTERS)
                                  if n not in _MORE])
def test_min_gain_zero_parts_only_at_pure_nodes(name, refuse_zero_gain):
    _min_gain_case(name, refuse_zero_gain)
