"""Thread limits for the port's heavier CPU tests.

The suite runs in several pytest workers at once, each of whose torch
would otherwise start one intra-op thread per core, and the tests' tiny
ops then spend their time contending for the cores.  ``few_threads``
(autouse where a test module imports it) runs each test with one torch
thread and restores the count after; ``child_env`` gives a test's child
process the repository on PYTHONPATH and one OpenMP / MKL thread.
"""
import os
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def child_env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
