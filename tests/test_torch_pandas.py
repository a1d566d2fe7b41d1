"""pandas category columns in the port, against the JAX package.

A DataFrame's category-dtype columns train as categorical features through
their category codes, as in the JAX package's _data_from_pandas
(lightgbm_tpu/basic.py:70-100): the model text carries the training
category lists (`pandas_categorical`), a valid set and a prediction encode
their frames through those lists, and unseen categories and NaN become
NaN. Both packages train the same frame (the JAX booster on its MXU growth
path in Pallas interpret mode, the path it takes on an accelerator; the
port on device_type=cpu) at the exact-mode bars of
tests/test_torch_train.py, and predict within 5e-5, unseen categories and
NaN included. Data: numpy seed 7, 2,000 rows of a numeric column, an
integer category column (0, 10, ..., 70) and a string one (8 categories
in a shuffled order), 4% NaN in each, binary, 7 leaves, 3 trees.
"""

import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_train import _assert_same_model, _trees

_PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
           "min_data_in_leaf": 5, "verbosity": -1}
_ROUNDS = 3
_WORDS = ["kiwi", "apple", "fig", "pear", "lime", "plum", "date", "yuzu"]


def _frame(n, seed, ints=tuple(range(0, 80, 10)), words=tuple(_WORDS)):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float64)
    ci = rng.randint(0, len(ints), n)
    cs = rng.randint(0, len(words), n)
    # every category moves the label its own way, so the trees split on them
    y = (x + 0.8 * np.sin(1.7 * ci) - 0.6 * np.cos(2.3 * cs) +
         0.3 * rng.randn(n) > 0).astype(np.float32)
    df = pd.DataFrame({
        "x": x,
        "ci": pd.Categorical(np.asarray(ints)[ci], categories=list(ints)),
        "cs": pd.Categorical(np.asarray(words)[cs],
                             categories=sorted(words, reverse=True))})
    # NaN cells in both category columns: NaN goes right of every
    # categorical split, so a split and its complement differ in training
    df.loc[rng.rand(n) < 0.04, "ci"] = np.nan
    df.loc[rng.rand(n) < 0.04, "cs"] = np.nan
    return df, y


def _jax_booster(df, y, valid=None):
    bst = lgb.Booster(dict(_PARAMS, pipeline=False),
                      lgb.Dataset(df, label=y, params=_PARAMS))
    g = bst.gbdt
    g._hist_impl = "mxu"           # the accelerator's growth path ...
    g._mxu_interpret = True        # ... in Pallas interpret mode
    if valid is not None:
        bst.add_valid(lgb.Dataset(valid[0], label=valid[1],
                                  reference=bst.train_set), "v")
    for _ in range(_ROUNDS):
        bst.update()
    return bst


def _torch_booster(df, y, valid=None):
    params = dict(_PARAMS, device_type="cpu")
    ds = lgt.Dataset(df, label=y, params=params)
    bst = lgt.Booster(params, ds)
    if valid is not None:
        bst.add_valid(ds.create_valid(valid[0], label=valid[1]), "v")
    for _ in range(_ROUNDS):
        bst.update()
    return bst


@pytest.fixture(scope="module")
def boosters():
    df, y = _frame(2000, 7)
    valid = _frame(600, 8)
    return df, y, valid, _jax_booster(df, y, valid), \
        _torch_booster(df, y, valid)


def _predict_frame():
    """Seen categories in another category order, unseen categories and
    NaN in both category columns."""
    df, _ = _frame(400, 9, ints=(70, 0, 30, 20, 10, 40, 60, 50, 99),
                   words=tuple(_WORDS) + ("mango",))
    df.loc[::17, "ci"] = np.nan
    df.loc[5::19, "cs"] = np.nan
    return df


def test_category_columns_train_as_categorical(boosters):
    _, _, _, b_jax, b_torch = boosters
    s_jax, s_torch = b_jax.model_to_string(), b_torch.model_to_string()
    cats = b_torch.train_set.binned.is_categorical
    assert list(np.asarray(cats)) == [False, True, True]
    # categorical splits (decision_type bit 0) on both category columns
    used = set()
    for t in _trees(s_torch):
        feats, types = t["split_feature"].split(), t["decision_type"].split()
        used |= {int(f) for f, d in zip(feats, types) if int(d) & 1}
    assert used == {1, 2}
    assert len(_trees(s_torch)) == _ROUNDS
    _assert_same_model(s_jax, s_torch)
    pc = [[0, 10, 20, 30, 40, 50, 60, 70], sorted(_WORDS, reverse=True)]
    assert b_torch._host_model().pandas_categorical == pc
    line = [ln for ln in s_torch.splitlines()
            if ln.startswith("pandas_categorical:")]
    assert line == [ln for ln in s_jax.splitlines()
                    if ln.startswith("pandas_categorical:")]


def test_predict_maps_categories_like_jax(boosters):
    df, _, _, b_jax, b_torch = boosters
    pf = _predict_frame()
    for raw in (True, False):
        np.testing.assert_allclose(b_torch.predict(pf, raw_score=raw),
                                   b_jax.predict(pf, raw_score=raw),
                                   rtol=1e-5, atol=5e-5)
    # unseen categories and NaN route as NaN: the same leaves as a frame
    # whose category cells are NaN outright
    nan_df = pf.copy()
    nan_df.loc[(pf["ci"] == 99).to_numpy(), "ci"] = np.nan
    nan_df.loc[(pf["cs"] == "mango").to_numpy(), "cs"] = np.nan
    np.testing.assert_array_equal(b_torch.predict(pf, pred_leaf=True),
                                  b_torch.predict(nan_df, pred_leaf=True))
    # the training frame itself scores as the booster's own scores
    np.testing.assert_allclose(b_torch.predict(df, raw_score=True),
                               b_torch.gbdt.train_score.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_valid_set_encodes_with_training_categories(boosters):
    _, _, (dfv, yv), b_jax, b_torch = boosters
    np.testing.assert_array_equal(
        np.asarray(b_torch._valid_data[0].binned.bins),
        np.asarray(b_jax._valid_data[0].binned.bins))
    ev_t = {(n, m): v for n, m, v, _ in b_torch.eval_valid()}
    ev_j = {(n, m): v for n, m, v, _ in b_jax.eval_valid()}
    assert ev_t.keys() == ev_j.keys()
    for k in ev_t:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_torch.gbdt._valid_score_host(0).ravel(),
                               b_torch.predict(dfv, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_pandas_categorical_round_trip(boosters):
    _, _, _, b_jax, b_torch = boosters
    pf = _predict_frame()
    s = b_torch.model_to_string()
    loaded = lgt.Booster(model_str=s)
    assert loaded._host_model().pandas_categorical == \
        b_torch._host_model().pandas_categorical
    assert loaded.model_to_string() == s
    np.testing.assert_array_equal(loaded.predict(pf), b_torch.predict(pf))
    # the JAX package reads the port's model text the same way
    jloaded = lgb.Booster(model_str=s)
    np.testing.assert_allclose(jloaded.predict(pf), b_torch.predict(pf),
                               rtol=1e-6, atol=1e-7)
    # a frame whose category columns do not match the model's is refused
    with pytest.raises(ValueError):
        b_torch.predict(pf.drop(columns=["cs"]).assign(
            cs=pf["cs"].astype(object)))
