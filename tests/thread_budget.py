"""The CPU thread budget of one pytest process. Importing this module
applies it; every tests/test_torch_*.py imports it right after torch.

Under pytest-xdist the workers share the host's cores. At torch's default
of one intra-op thread per core, six workers on eight cores run 48 OpenMP
threads, and the many small CPU ops of the port's tests spend most of
their time spinning against each other. Each worker instead gets
cores // workers threads, at least one; a serial run keeps every core.
"""
import os

import torch

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def apply_thread_budget(environ, cores):
    """Share `cores` out among xdist's workers (a serial run is one
    worker), set each of THREAD_VARS that `environ` lacks to that share,
    so that the processes a test spawns inherit it, and return torch's
    intra-op thread count. A value the caller set wins.

    Only an xdist worker writes `environ`: the controller spawns the
    workers with its own environment, where a value it wrote would pass
    for the caller's. A serial run leaves it as it is, since its budget
    is every core, which is the libraries' default."""
    workers = int(environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    budget = max(1, cores // workers)
    if "PYTEST_XDIST_WORKER" in environ:
        for var in THREAD_VARS:
            environ.setdefault(var, str(budget))
    return int(environ.get("OMP_NUM_THREADS", budget))


torch.set_num_threads(apply_thread_budget(os.environ,
                                          len(os.sched_getaffinity(0))))
