"""A fixture for port test modules that run torch on the CPU beside five
other test workers: torch's intra-op pool would take every core in each
worker, and the workers then wait on one another's threads."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread for the module's tests; the caller's count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
