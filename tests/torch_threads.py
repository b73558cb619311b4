"""One intra-op thread in every process of the port's CPU tests.

The port's CPU path is thousands of tiny torch ops, and each one forks and
joins torch's OpenMP team. Under ``pytest -n 6`` on an 8-core host, six
workers' teams of eight threads spend their time waiting on each other:
an 8-lane hub-row case that takes ~18 s alone ran past 300 s with five
copies of itself beside it, and 42 s with one thread each. So every
``tests/test_torch_*.py`` imports ``one_thread`` (an autouse fixture) and
builds the environment of every process it starts with ``child_env``;
``tests/test_torch_threads.py`` holds them to it. The package itself sets
no thread count: a user's process keeps torch's default.
"""
import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's fixtures and tests, and
    ``OMP_NUM_THREADS=1`` for the processes they spawn; both restored
    after the module."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def child_env(*, drop=(), **set_vars) -> dict:
    """The environment of a process that a port test starts: this
    process's, less the names in ``drop``, with ``set_vars`` and one
    intra-op thread (``OMP_NUM_THREADS=1``)."""
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(set_vars, OMP_NUM_THREADS="1")
    return env
