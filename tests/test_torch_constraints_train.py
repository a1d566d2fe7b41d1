"""The booster with feature_fraction, feature_fraction_bynode and
extra_trees against the JAX package's (its MXU path in Pallas interpret
mode): cases of test_train_options_match_jax_package, whose body and
parameters are in tests/test_torch_constraints.py, in a file of their own
so that --dist loadfile spreads the JAX compiles."""

import pytest

from tests.test_torch_constraints import _TRAIN_OPTIONS, _train_option_case
from tests.test_torch_one_thread import one_thread  # noqa: F401

_IDS = ["feature_fraction", "bynode", "extra_trees"]


@pytest.mark.parametrize("extra", [_TRAIN_OPTIONS[k] for k in _IDS],
                         ids=_IDS)
def test_train_options_match_jax_package(extra):
    _train_option_case(extra)
