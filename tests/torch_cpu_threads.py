"""Imported first by every port test module (tests/test_torch_*.py):
torch's CPU ops run on the cores a test process has to itself.

The suite runs under pytest-xdist, several worker processes on one
machine. Each process's torch defaults to one intra-op thread a core,
so six workers start six threads a core, and OpenMP's waiting threads
take the cores from each other: a port train step test measured 103 s
with six copies running at once, 3 s with one thread each. A worker
therefore takes cores / workers threads (one process alone keeps them
all). Import order does not change what the tests compute; the few
tests that need a fixed summation order set one thread themselves.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
