"""One intra-op CPU thread while a test module runs: the quick lane runs six
workers on the machine's cores, torch's default of a thread a core in each
oversubscribes them, and a step of many small ops then spends its time at
the thread pool's barriers (more so beside the engine's host threads). A
module takes the fixture by importing it:

    from tests.torch_threads import one_intra_op_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
