"""One intra-op thread for the port's CPU tests.

The port's CPU path is many small torch operations.  With torch's
default thread count each worker of a parallel test run (`pytest -n`)
spins up a thread per core for every operation large enough to split,
and workers on a shared box then spend most of their time contending:
one final exponentiation took 177 s with six runs side by side instead
of 3 s.  A test file of the port imports `one_torch_thread`, an autouse
fixture that runs the file on one thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
