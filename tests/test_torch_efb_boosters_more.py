"""The cases of tests/test_torch_efb_boosters.py's test_booster_matches_jax
named in its _MORE (the port's bundled booster against the JAX package's
and its own unbundled one), in a file of their own so that --dist
loadfile spreads the JAX interpret compiles."""

import pytest

from tests.test_torch_efb_boosters import _MORE, _booster_case
from tests.test_torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("name", _MORE)
def test_booster_matches_jax(name):
    _booster_case(name)
