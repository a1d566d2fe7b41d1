"""`level_pipeline` on the CPU.

The port reads level_pipeline and level_pipeline_lookahead and grows
every tree through Grower.grow (boosting/gbdt.py says why). Byte parity:
`level_pipeline=true` writes the model text of `level_pipeline=false`
once the `[level_pipeline*` echo lines are dropped, across objectives,
quantized gradients, CEGB and lookaheads 1, 2 and 4, by update() and by
train; growth_plan's schedule equals the JAX package's. Data from the
numpy seeds in each helper.
"""

import numpy as np
import pytest

from lightgbm_tpu.learner.grower_mxu import growth_plan as jgrowth_plan
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.learner.grower_mxu import growth_plan
from tests.test_torch_one_thread import one_thread  # noqa: F401

PARAMS = {"num_leaves": 15, "learning_rate": 0.2, "max_bin": 31,
          "verbosity": -1, "min_data_in_leaf": 5, "device_type": "cpu",
          "level_pipeline_lookahead": 2}


def _data(objective, seed=11, n=500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    if objective == "multiclass":
        y = rng.randint(0, 3, n).astype(np.float32)
    elif objective == "binary":
        y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float32)
    else:
        y = (X[:, 0] + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


def _strip(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[level_pipeline"))


def _updates(params, data, trees):
    """Booster after `trees` update() calls."""
    X, y = data
    bst = lgt.Booster(params, lgt.Dataset(X, label=y,
                                          params={"max_bin": 31}))
    for _ in range(trees):
        bst.update()
    return bst


CASES = {
    "regression": {"objective": "regression"},
    "binary": {"objective": "binary"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "binary_quantized": {"objective": "binary", "use_quantized_grad": True},
    "regression_quantized": {"objective": "regression",
                             "use_quantized_grad": True},
    "cegb": {"objective": "binary", "cegb_penalty_split": 0.5,
             "cegb_penalty_feature_coupled": [1.0, 0.5, 0.0, 2.0, 0.0]},
    # on _data("binary", seed=5) tree 1 runs 2 fix-up passes
    "fixups": {"objective": "binary", "min_data_in_leaf": 20},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_byte_identical_models(case):
    params = dict(PARAMS, **CASES[case])
    data = _data(params["objective"])
    off = _updates(dict(params, level_pipeline=False), data, 4)
    on = _updates(dict(params, level_pipeline=True), data, 4)
    assert _strip(on.model_to_string()) == _strip(off.model_to_string())


@pytest.mark.parametrize("lookahead", [1, 2, 4])
def test_lookahead_does_not_move_a_byte(lookahead):
    params = dict(PARAMS, **CASES["fixups"])
    data = _data("binary", seed=5)
    off = _updates(dict(params, level_pipeline=False), data, 3)
    on = _updates(dict(params, level_pipeline=True,
                       level_pipeline_lookahead=lookahead), data, 3)
    assert _strip(on.model_to_string()) == _strip(off.model_to_string())


def test_train_through_the_level_pipeline_equals_update():
    # iteration 0 of train grows through Grower.grow, the rest on the
    # fused trainer, as with level_pipeline=false
    params = dict(PARAMS, objective="binary", level_pipeline=True,
                  fused_block_size=3)
    X, y = _data("binary", seed=7)
    bst = lgt.train(params, lgt.Dataset(X, label=y,
                                        params={"max_bin": 31}), 7)
    ref = _updates(dict(params, level_pipeline=False), (X, y), 7)
    drop = ("[level_pipeline", "[fused_block_size", "[pipeline")
    assert [ln for ln in bst.model_to_string().splitlines()
            if not ln.startswith(drop)] == \
        [ln for ln in ref.model_to_string().splitlines()
         if not ln.startswith(drop)]


def test_growth_plan_and_stats_match_jax():
    for nl, over, gate, cap in ((31, 1.15, 0.9, 0), (7, 0.0, 0.0, 0),
                                (127, 0.0, 0.0, 5), (255, 1.2, 0.0, 0)):
        kw = dict(num_leaves=nl, overshoot=over, bridge_gate=gate,
                  tail_split_cap=cap)
        ours, theirs = growth_plan(**kw), jgrowth_plan(**kw)
        for key in ("schedule", "L_g", "s_fix", "k_fix"):
            assert getattr(ours, key) == getattr(theirs, key), (kw, key)
