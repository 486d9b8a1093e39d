"""A fixture that the port's test files import: under pytest-xdist with
several workers, torch's CPU operations run on one thread while a test
module runs.

The tier-1 run puts several xdist workers on one host, and torch starts
one OpenMP thread per core in each of them. On the small tensors of these
tests the oversubscribed threads spend their time waiting on each other:
an experiment that takes about a second in one worker took over a minute
with four workers side by side. One thread per worker keeps each test near
its single-worker time; a run in one process keeps torch's default. The
results are the same computations, summed in one thread's order.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    threads = torch.get_num_threads()
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
