"""The port's CPU tests under ``pytest -n``: torch's intra-op threads.

Each test module of the port imports :func:`torch_thread_share`, an
autouse fixture: while the module runs in a pytest-xdist worker, torch
runs its CPU ops on the worker's share of the cores (``cpus // workers``,
at least one) and gets its own count back after the module. With torch's
default (one thread per core) in every worker, several workers running
the port's tests at once oversubscribe the cores, and torch's OpenMP
threads spin waiting on each other: on 8 cores, five processes running
``tests/test_torch_pipeline.py -k "one_stage or tied"`` each took over 12
minutes for three of its five tests at the default, and 26 s for all five
at one thread apiece. Outside xdist the fixture changes nothing.
"""

import os

import pytest
import torch


def thread_share(cpus: int, workers: int) -> int:
    """Intra-op threads for one of ``workers`` processes on ``cpus``
    cores."""
    return max(1, cpus // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def torch_thread_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(thread_share(os.cpu_count() or 1, workers))
    yield
    torch.set_num_threads(before)


def test_thread_share():
    assert thread_share(8, 6) == 1
    assert thread_share(32, 6) == 5
    assert thread_share(8, 1) == 8
    assert thread_share(1, 6) == 1


def test_module_runs_on_its_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        assert torch.get_num_threads() == thread_share(os.cpu_count() or 1,
                                                       workers)
