"""The one-intra-op-thread fixture of the port's test files (imported by
name into each file, so that pytest applies it there)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run small tensors, where one intra-op thread does the
    same work in the same time; idle pool threads would only spin, taking
    cores from the other workers of the parallel tier-1 run.  The previous
    count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
