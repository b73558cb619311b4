"""The benchmark's CPU tests: one intra-op torch thread in each test
module, as the port's own tests keep (many tiny torch ops under several
pytest workers otherwise spend their time waiting on each other's thread
teams). No test here needs a card."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)
