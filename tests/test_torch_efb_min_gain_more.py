"""The cases of tests/test_torch_efb_min_gain.py's
test_min_gain_zero_parts_only_at_pure_nodes named in its _MORE (the EFB
boosters at min_gain_to_split 0 against the JAX package's, both split
finders refusing pure nodes' splits), in a file of their own so that
--dist loadfile spreads the JAX interpret compiles."""

import pytest

from tests.test_torch_efb_min_gain import (_MORE, _min_gain_case,  # noqa: F401
                                           refuse_zero_gain)
from tests.test_torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("name", _MORE)
def test_min_gain_zero_parts_only_at_pure_nodes(
        name, refuse_zero_gain):  # noqa: F811
    _min_gain_case(name, refuse_zero_gain)
