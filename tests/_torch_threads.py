"""One share of the cores for torch in each pytest-xdist worker.

Each worker's torch would start one intra-op thread per core, so six
workers on eight cores run 48 threads that contend for them, and the
port's heaviest tests take minutes instead of seconds. Every
``tests/test_torch_*.py`` calls ``cap_torch_threads`` at import; every
worker collects every file, so the cap holds before any port test runs.
Only torch is capped (``torch.set_num_threads``, not ``OMP_NUM_THREADS``),
so numpy and XLA in the reference package's tests keep their threads.
Outside xdist it does nothing. Imports only ``os`` and ``torch``: the
card's machine, which runs ``test_torch_cuda.py``, has no JAX."""
import os

import torch


def cap_torch_threads() -> None:
    """In an xdist worker, torch's intra-op threads to the cores this
    process may run on over the number of workers, at least one."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
