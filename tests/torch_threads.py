"""PyTorch's intra-op threads in the port's CPU tests: each pytest-xdist
worker takes its share of the host's cores.

The suite runs in several worker processes (``-p xdist -n 6``). Left alone,
PyTorch's OpenMP pool opens one thread per core in every worker, so the
workers oversubscribe the host several times over, and the port's
PyTorch-heavy files run several times slower than with one thread each.
Every ``tests/test_torch_*.py`` imports this module right after ``torch``,
before its first torch operation. Without xdist the process keeps every
core.
"""
import os

import torch


def cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                      # not on Linux
        return os.cpu_count() or 1


WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, cores() // WORKERS)
torch.set_num_threads(THREADS)
