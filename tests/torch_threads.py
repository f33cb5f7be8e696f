"""One PyTorch intra-op thread for a test module of the port.

The suite runs in several pytest-xdist workers at once on one host's
cores. PyTorch's CPU pool sizes itself to every core in each worker, and
its threads spin while they wait, so workers at full width oversubscribe
the cores and every step runs several times slower than on one thread. A
module imports the fixture below to run its tests on one thread; it
restores the width after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    width = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(width)
