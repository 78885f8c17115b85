"""Torch's CPU thread count for the port's tests.

pytest-xdist starts several workers on one machine, and each torch
process would otherwise run one intra-op thread per core: six workers on
eight cores then run 48 threads that spin against each other. Every
``tests/test_torch_*.py`` imports this module first, which gives each
worker its share of the cores (at least one) and, where torch still
allows it, one inter-op thread. A run without xdist keeps every core.
"""

import os

import torch


def _threads() -> int:
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        cores = os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


THREADS = _threads()
torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # inter-op work already ran in this process
    pass
