"""The 255-leaf cases of tests/test_torch_quantized.py's
test_quantized_grower_matches_jax_bit_for_bit (quantized growth against
the JAX grower in Pallas interpret mode, bit for bit), in a file of their
own so that --dist loadfile spreads the JAX interpret compiles."""

import pytest

from tests.test_torch_one_thread import one_thread  # noqa: F401
from tests.test_torch_quantized import _quantized_grower_case


@pytest.mark.parametrize("num_leaves,n,const_hess", [
    (255, 20000, 0.0), (255, 20000, 1.0)],
    ids=["255_leaves", "255_leaves_const_hess"])
def test_quantized_grower_matches_jax_bit_for_bit(num_leaves, n, const_hess):
    _quantized_grower_case(num_leaves, n, const_hess)
