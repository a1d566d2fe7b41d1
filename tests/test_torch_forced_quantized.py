"""Quantized forced splits in the port against the JAX package, on the
CPU: the MXU grower under test_torch_forced.py's nested spec with
use_quantized_grad against the JAX booster pinned to its MXU grower in
interpret mode (its quantized kernels: a compile of their own, so a file
of their own). The training loss is held within 1% of the JAX package's
(ROADMAP C2: the quantization noise differs); every tree applies the
spec's four splits at its threshold bins."""

import pytest

from tests.test_torch_forced import _jax_pinned, _spec_file, \
    check_forced_mxu_booster
from tests.test_torch_one_thread import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return _spec_file(tmp_path_factory.mktemp("forced"))


def test_forced_quantized_booster_matches_pinned_jax(spec_path):
    check_forced_mxu_booster(_jax_pinned(spec_path, True), spec_path, True)
