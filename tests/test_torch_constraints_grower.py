"""grow_tree_mxu with extra_trees and with every option together against
the JAX package (its grower in Pallas interpret mode): the cases of
tests/test_torch_constraints.py's test_grower_options_match_jax that run
in their own file, so that --dist loadfile spreads the JAX compiles."""

import pytest

from tests.test_torch_constraints import _grower_option_case
from tests.test_torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("name", ["extra_trees", "all"])
def test_grower_options_match_jax(name):
    _grower_option_case(name)
