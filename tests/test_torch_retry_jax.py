"""The retry-and-fall-back ladder of the port against the JAX package's.

One Booster call sequence runs in both packages, the JAX booster pinned to
its MXU grower in Pallas interpret mode (tests/test_bench_robustness.py
pins it so, since only that grower reaches its fused dispatch): the
reliability counters, the fault trips and calls and _fused_disabled agree
after every step, and the models agree to the exact-mode parity bars
(tests/test_torch_train.py). Apart from tests/test_torch_retry_train.py so
that its two JAX interpret compiles (the fused scan and the grower) run
on a worker of their own.
"""

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
import pytest
from lightgbm_tpu.reliability.counters import counters as jax_counters
from lightgbm_tpu_torch.reliability import counters
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_retry_train import (_ENV, PARAMS, _clean,  # noqa: F401
                                          _data, faults, jax_faults)
from tests.test_torch_train import _assert_same_model

pytestmark = pytest.mark.faults


def _jax_pinned(X, y):
    bst = lgb.Booster(dict(PARAMS), lgb.Dataset(X, label=y,
                                                params={"max_bin": 31}))
    g = bst.gbdt
    g._hist_impl = "mxu"          # the fused-eligible TPU path ...
    g._mxu_interpret = True       # ... in Pallas interpret mode
    g._fused_run = None
    assert g._fused_eligible()
    return bst


def _snap(reg, ctr, gb):
    return (ctr.snapshot(), reg.snapshot(),
            reg.calls("fused_dispatch"), reg.calls("histogram_build"),
            reg.remaining("fused_dispatch"),
            bool(getattr(gb, "_fused_disabled", False)))


def test_ladder_matches_the_pinned_jax_booster(monkeypatch):
    """iteration 0's growth retried, then blocks of 3 through
    update_batch with LGBM_TPU_INJECT_FUSED_FAULT: a block retried, one
    let through, one exhausted (fall-back), a second exhausted in a row
    (the fused path off), then a block per iteration. Every step's
    counters, trips, calls and _fused_disabled agree with the JAX
    package's."""
    X, y = _data()
    jbst = _jax_pinned(X, y)
    p = dict(PARAMS, device_type="cpu")
    pbst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    for reg in (faults, jax_faults):
        reg.schedule("histogram_build", fail=1)
    steps = [("update", None), ("batch", "1"), ("batch", "1:3"),
             ("batch", None), ("batch", "3"), ("batch", None)]
    for kind, env in steps:
        if env is not None:
            monkeypatch.setenv(_ENV, env)
        got = []
        for bst, reg, ctr in ((pbst, faults, counters),
                              (jbst, jax_faults, jax_counters)):
            if kind == "update":
                bst.update()
            else:
                bst.update_batch(3)
            got.append(_snap(reg, ctr, bst.gbdt))
        assert got[0] == got[1], (kind, env)
    assert got[0][0]["device_retries"] == 6
    assert got[0][0]["fallbacks"] == 2 and got[0][5] is True
    assert pbst.current_iteration() == jbst.current_iteration() == 16
    _assert_same_model(jbst.model_to_string(), pbst.model_to_string())
    # and the faulted port booster writes the clean port booster's model
    clean = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    clean.update()
    for _ in range(5):
        clean.update_batch(3)
    assert clean.model_to_string() == pbst.model_to_string()
