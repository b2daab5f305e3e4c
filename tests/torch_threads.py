"""A fixture that runs a test's torch CPU work on one thread.

Under pytest-xdist each worker is a process with its own OpenMP pool of
torch intra-op threads, one per core. Two pools that spin at the same
time over small tensors starve each other's barriers: two processes
solving the same small EF side by side each take ~20x their time
alone. A test that uses ``one_torch_thread`` runs torch on one thread,
and so do the processes it spawns (``OMP_NUM_THREADS``); the count and
the variable are restored afterwards, so the other tests of a worker
keep the default.
"""

import os

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
