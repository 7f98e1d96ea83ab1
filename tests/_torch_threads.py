"""One torch intra-op thread for the port's CPU tests.

The suite runs under pytest-xdist, several workers to a machine, and the
port's CPU tests push many small tensors through torch.  With torch's
default of one intra-op thread per core in every worker, the workers'
thread teams oversubscribe the cores, and a test runs many times slower
than it does alone: the four discovery-mesh files took 347 s on four
workers with the default and 43 s with one thread each (8 cores).  Every
``test_torch_*.py`` imports ``one_thread``: an autouse, module-scoped
fixture that runs the module's tests on one intra-op thread and puts the
count back after them.  The sums a test compares run on the same thread
count, so no result it checks depends on it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
