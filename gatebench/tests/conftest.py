import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """The tiny runs are many small operations: more threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
