"""One torch thread a pytest-xdist worker, for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module before ``torch`` and
before anything of the port. Under an xdist worker (``PYTEST_XDIST_WORKER``
set) it calls ``torch.set_num_threads(1)`` and sets ``OMP_NUM_THREADS=1``
where that is unset, so that the subprocesses the tests spawn (the port's
CLI, the native CLI, ranks) take one thread too.

Why: torch on the CPU starts an OpenMP team of one thread a core for any
op past its parallel grain (32,768 elements). The plain banded fill works
a row at a time on a batch's (B, 2W+1) lanes, past that grain in the wide
band tests (W 9,000 and 40,000), so every row op forks a team; six workers
on eight cores then run ~48 spinning threads against each other, and a
case that takes seconds alone takes minutes. With one thread a worker the
workers themselves are the parallelism.

A run outside xdist keeps torch's defaults: a user's thread count, and a
single file run with ``-o addopts=""``, are left as they are.
"""

import os

PINNED = bool(os.environ.get("PYTEST_XDIST_WORKER"))

if PINNED:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)
