"""One intra-op torch thread for every port test module.

The port's tests run small tensors, and under pytest-xdist every worker's
torch threads would contend for the same cores: a test ran ~20x slower so
(tests/test_torch_multiclass.py, PR 13). Every tests/test_torch_*.py
module imports `one_thread` from here, so the pin covers its
module-scoped fixtures (reference models trained once a module) as well
as its tests, and the thread count comes back when the module ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_pins_torch():
    assert torch.get_num_threads() == 1
