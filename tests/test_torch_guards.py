"""The non-finite guard rails (guard_nonfinite) in the port, on the CPU.

The cases of the JAX package's tests/test_reliability.py TestGuards, run
against the port's reliability.guards and reliability.counters: the
finiteness check; a custom objective that puts a NaN in one gradient on
its third call, under warn, skip_iteration and rollback (5 iterations
complete, one trip, finite predictions) and raise (GuardError); a clean
run under warn writes guard_nonfinite=off's trees; an unknown policy is
refused. Then the port's warn, skip_iteration and rollback models on that
objective against the JAX package's (the portable grower in both: the
unpinned JAX booster's CPU path), values within 1e-4, and the post-growth
rail, which a non-finite leaf trips: the iteration is dropped and the
training and valid scores are restored exactly.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.reliability.counters import counters as jax_counters
from lightgbm_tpu_torch.reliability import counters, guards
from tests.conftest import make_binary
from tests.test_torch_efb import _assert_same_model
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 31, "verbosity": -1, "min_data_in_leaf": 5}
_POLICIES = ("warn", "skip_iteration", "rollback")


def _ds(n=300, f=5, seed=2, pkg=lgt):
    X, y = make_binary(n=n, f=f, seed=seed)
    return X, y, pkg.Dataset(X, label=y, params={"max_bin": 31})


def _nan_fobj_factory(bad_call, label):
    def fobj(preds, dataset):
        g = np.asarray(preds) - label
        h = np.ones_like(g)
        fobj.calls += 1
        if fobj.calls == bad_call:
            g = g.copy()
            g[0] = np.nan
        return g, h
    fobj.calls = 0
    return fobj


@pytest.fixture(autouse=True)
def _clean_counters():
    counters.reset()
    yield
    counters.reset()


def _port(params):
    return dict(PARAMS, device_type="cpu", **params)


def test_all_finite():
    a = torch.ones(4)
    assert guards.all_finite(a, a)
    assert guards.all_finite(None, a)
    assert guards.all_finite()
    b = a.clone()
    b[1] = float("inf")
    assert not guards.all_finite(a, b)
    assert not guards.all_finite(torch.tensor([float("nan")]))


@pytest.mark.parametrize("policy", _POLICIES)
def test_nonfatal_policies_complete(policy):
    X, y, ds = _ds()
    bst = lgt.train(_port({"guard_nonfinite": policy}), ds,
                    num_boost_round=5, fobj=_nan_fobj_factory(3, y))
    assert bst.current_iteration() == 5
    assert counters.get("guard_trips") == 1
    assert np.all(np.isfinite(bst.predict(X)))


def test_raise_policy():
    X, y, ds = _ds()
    with pytest.raises(guards.GuardError):
        lgt.train(_port({"guard_nonfinite": "raise"}), ds,
                  num_boost_round=5, fobj=_nan_fobj_factory(3, y))
    assert counters.get("guard_trips") == 1


def test_clean_run_never_trips():
    """The guard observes a healthy run and changes nothing: the trees of
    guard_nonfinite=off (one iteration a dispatch under the guard, the
    fused trainer without it)."""
    X, y, ds = _ds()
    bst = lgt.train(_port({"guard_nonfinite": "warn"}), ds,
                    num_boost_round=5)
    assert counters.get("guard_trips") == 0
    assert not bst.gbdt.fused_stats
    ref = lgt.train(_port({}), _ds()[2], num_boost_round=5)
    assert ref.gbdt.fused_stats
    tree_part = bst.model_to_string().split("end of parameters")[1]
    ref_part = ref.model_to_string().split("end of parameters")[1]
    assert tree_part == ref_part


def test_invalid_policy_rejected():
    X, y, ds = _ds()
    with pytest.raises(ValueError, match="guard_nonfinite"):
        lgt.train(_port({"guard_nonfinite": "explode"}), ds,
                  num_boost_round=1)
    assert guards.GUARD_POLICIES == ("off", "warn", "skip_iteration",
                                     "rollback", "raise")


@pytest.mark.parametrize("policy", _POLICIES)
def test_guarded_models_match_jax(policy):
    """The port's model under each policy equals the JAX package's on the
    same objective, both on the portable grower (use_pallas=false: the
    segment sums), and both count one trip."""
    X, y, ds = _ds()
    p = dict(PARAMS, guard_nonfinite=policy, use_pallas=False)
    bst = lgt.train(dict(p, device_type="cpu"), ds, num_boost_round=5,
                    fobj=_nan_fobj_factory(3, y))
    jax_counters.reset()
    jb = lgb.train(dict(p, pipeline=False), _ds(pkg=lgb)[2],
                   num_boost_round=5, fobj=_nan_fobj_factory(3, y))
    assert counters.get("guard_trips") == jax_counters.get("guard_trips") \
        == 1
    jax_counters.reset()
    assert bst.num_trees() == 5
    _assert_same_model(jb.model_to_string(), bst.model_to_string(), 1e-4)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("policy", ["skip_iteration", "rollback", "warn"])
def test_post_growth_rail_restores_scores(policy, monkeypatch):
    """A tree whose leaf value is non-finite trips the post-growth rail:
    skip_iteration and rollback drop the iteration and put the training
    and valid scores back bit for bit (skip_iteration keeps a zero tree in
    its slot); warn keeps it and logs."""
    X, y, ds = _ds()
    p = _port({"guard_nonfinite": policy})
    bst = lgt.Booster(p, ds)
    bst.add_valid(lgt.Dataset(X[:100], label=y[:100], reference=ds),
                  "valid")
    g = bst.gbdt
    bst.update()
    score0 = g.train_score.clone()
    valid0 = g.valid_scores[0].clone()
    orig = g._leaf_values

    def poisoned(tree, row_node):
        vals = orig(tree, row_node)
        return torch.where(row_node == row_node[0], float("nan"), vals)
    monkeypatch.setattr(g, "_leaf_values", poisoned)
    bst.update()
    assert counters.get("guard_trips") == 1
    if policy == "warn":
        assert g.current_iteration() == 2 and len(g.trees) == 2
        assert not torch.isfinite(g.train_score).all()
        return
    assert torch.equal(g.train_score, score0)
    assert torch.equal(g.valid_scores[0], valid0)
    if policy == "rollback":
        assert g.current_iteration() == 1 and len(g.trees) == 1
    else:
        assert g.current_iteration() == 2 and len(g.trees) == 2
        assert int(g.trees[1].num_leaves) == 1
        assert float(g.trees[1].leaf_value.abs().sum()) == 0.0
