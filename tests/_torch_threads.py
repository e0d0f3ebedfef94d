"""A fixture for the port's CPU tests: one intra-op thread per test module.

The tier-1 run puts six pytest workers on the same cores; torch's intra-op
threads spin while they wait, and with more threads than cores every worker
slows down many times over.  Import ``one_torch_thread`` into a test module
to run its tests with one thread (restored after the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
