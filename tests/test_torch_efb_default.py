"""Bundled (EFB) data on the port's default growth path, against the JAX
package's default: the portable grower, not the MXU grower.

The JAX package's _mxu_exclusions (lightgbm_tpu/boosting/gbdt.py:566-584)
sends bundled data to its portable grower unless efb_use_mxu is true, the
bundles fit 256 bins and the segmented scan is in use or the expansion
fits 1 GiB; the exclusion alone warns of nothing, and use_quantized_grad
then trains full precision. On the CPU the JAX booster takes its portable
grower by itself (gbdt.py:222-223), so here it runs unpinned: the port's
default booster must equal it at the bars of tests/test_torch_efb.py
(structure identical, values within 1e-4), quantized included, and train
one iteration a dispatch. With efb_use_mxu=true the port keeps the MXU
grower and the fused trainer, train byte-equal to update(). Data: the
sparse, mutually exclusive _sparse_X(5, n=2500) of tests/test_torch_efb.py
at its _BASE parameters, 3 trees.
"""

import logging
import re

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_efb import _BASE, _assert_same_model, _sparse_X
from tests.test_torch_one_thread import one_thread  # noqa: F401

_ROUNDS = 3


def _data():
    X, logit = _sparse_X(5, n=2500)
    return X, (logit > np.median(logit)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_default():
    """The JAX package's default booster on the bundled data, unpinned."""
    X, y = _data()
    jbst = lgb.Booster(dict(_BASE, pipeline=False),
                       lgb.Dataset(X, label=y, params=_BASE))
    assert jbst.gbdt._efb is not None
    assert jbst.gbdt._hist_impl == "scatter"
    for _ in range(_ROUNDS):
        jbst.update()
    return jbst


@pytest.mark.parametrize("quantized", [False, True])
def test_default_bundled_booster_matches_unpinned_jax(jax_default, quantized,
                                                      caplog):
    X, y = _data()
    params = dict(_BASE, device_type="cpu", verbosity=0)
    if quantized:
        params["use_quantized_grad"] = True
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bst = lgt.train(params, lgt.Dataset(X, label=y, params=params),
                        _ROUNDS)
    g = bst.gbdt
    assert g._efb is not None and g._hist_impl == "scatter"
    assert g._mxu_exclusions() == ["efb config"]
    # one iteration a dispatch on the portable grower
    assert not g.fused_stats and g.grow_stats["trees"] == _ROUNDS
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "MXU path excluded" not in text
    assert ("use_quantized_grad only accelerates" in text) == quantized
    # quantized trains full precision: the exact model
    _assert_same_model(jax_default.model_to_string(), bst.model_to_string(),
                       1e-4)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jax_default.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def test_efb_use_mxu_keeps_the_fused_bundled_path():
    X, y = _data()
    params = dict(_BASE, device_type="cpu", efb_use_mxu=True,
                  fused_block_size=2)
    trained = lgt.train(params, lgt.Dataset(X, label=y, params=params),
                        _ROUNDS)
    g = trained.gbdt
    assert g._efb is not None and g._hist_impl == "mxu"
    assert g._mxu_exclusions() == [] and g.fused_stats
    stepped = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    for _ in range(_ROUNDS):
        stepped.update()

    def strip(text):
        return re.sub(r"\[fused_block_size: .*\]\n", "", text)
    assert strip(trained.model_to_string()) == \
        strip(stepped.model_to_string())


@pytest.mark.parametrize("extra,rule", [
    ({"efb_use_mxu": True, "efb_segmented_scan": False}, False),
    ({"efb_use_mxu": True, "efb_segmented_scan": False,
      "growth_overshoot": 20000.0}, True),
    ({"efb_use_mxu": True, "growth_overshoot": 20000.0}, False)])
def test_expansion_budget_excludes_the_mxu_grower(extra, rule):
    """The expansion path's [s_max, F, bmax, 3] f32 scan tensor over 1 GiB
    (here through an overshoot of 20,000: s_max 300,001) excludes the MXU
    grower as in the JAX package (_mxu_expand_bytes); the segmented scan
    is never excluded by it. Nothing is trained."""
    X, y = _data()
    params = dict(_BASE, device_type="cpu", **extra)
    g = lgt.Booster(params, lgt.Dataset(X, label=y, params=params)).gbdt
    jp = dict(_BASE, pipeline=False, **extra)
    jg = lgb.Booster(jp, lgb.Dataset(X, label=y, params=jp)).gbdt
    assert g._mxu_expand_bytes() == jg._mxu_expand_bytes(jg.config)
    assert ("efb config" in g._mxu_exclusions()) == rule
    assert g._mxu_exclusions() == jg._mxu_exclusions(jg.config)
