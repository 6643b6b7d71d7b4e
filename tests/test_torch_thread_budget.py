"""The thread budget that tests/thread_budget.py gives each pytest process
that runs the port's tests."""
import os

import pytest
import torch

from thread_budget import THREAD_VARS, apply_thread_budget


WORKER = {"PYTEST_XDIST_WORKER": "gw0"}


@pytest.mark.parametrize("environ, cores, threads, written", [
    # six xdist workers on eight cores: one thread each, for children too
    ({**WORKER, "PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1, "1"),
    ({**WORKER, "PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4, "4"),
    # more workers than cores still leaves one thread
    ({**WORKER, "PYTEST_XDIST_WORKER_COUNT": "6"}, 4, 1, "1"),
    # a serial run keeps every core and leaves the environment alone
    ({}, 8, 8, None),
    # the xdist controller only spawns: its environment must stay the
    # caller's, since the workers inherit it
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1, None),
], ids=["6_workers", "2_workers", "workers_over_cores", "serial",
        "controller"])
def test_budget_shares_cores(environ, cores, threads, written):
    environ = dict(environ)
    assert apply_thread_budget(environ, cores) == threads
    for var in THREAD_VARS:
        assert environ.get(var) == written


@pytest.mark.parametrize("environ", [
    {**WORKER, "PYTEST_XDIST_WORKER_COUNT": "6"}, {}],
    ids=["worker", "serial"])
def test_caller_threads_win(environ):
    environ = {**environ, "OMP_NUM_THREADS": "3", "MKL_NUM_THREADS": "2"}
    assert apply_thread_budget(environ, 8) == 3
    assert environ["OMP_NUM_THREADS"] == "3"
    assert environ["MKL_NUM_THREADS"] == "2"


def test_this_process_runs_its_budget():
    """torch in this process runs the budget (or the caller's
    OMP_NUM_THREADS), and under xdist the processes a test spawns inherit
    it through the environment."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == int(
        os.environ.get("OMP_NUM_THREADS", max(1, cores // workers)))
    if "PYTEST_XDIST_WORKER" in os.environ:
        for var in THREAD_VARS:
            assert var in os.environ
