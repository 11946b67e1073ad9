"""One intra-op torch thread for the port's CPU tests.

These tests run small tensors, where PyTorch's intra-op thread pool costs
far more than it saves (a bf16 ``bmm`` of [8, 16, 64] x [8, 64, 128]
took 61 us on one thread and 4.4 ms on eight, on an 8-core CPU host),
and beside the other workers of an xdist run more threads only wait on
each other. A test module turns it on for its tests with

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Runs the test on one intra-op thread, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
