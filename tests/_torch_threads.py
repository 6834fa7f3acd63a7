"""Shared fixture of the port's parity tests.

The suite runs several pytest-xdist workers on a few cores. Each torch
process would start one OpenMP thread per core and each JAX process its
own pool, and the spinning threads oversubscribe the cores: the port's
tests ran about three times slower in the full suite than alone. Their
tensors are small, so they run torch on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
