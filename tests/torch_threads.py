"""One torch thread for a port test module's in-process work.

The port's tests run at tiny widths (hidden 32-64), where torch's
intra-op pool costs far more than it saves, and the suite's xdist
workers share the CPU besides.  Each ``tests/test_torch_*.py``
imports ``one_torch_thread``; it sets one thread for the module and
restores the count after it.  Spawned ranks and replicas set their own.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
