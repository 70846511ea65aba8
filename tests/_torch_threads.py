"""Give each test process its share of the CPU's cores for torch's threads.

Under ``pytest -n W`` every worker process would otherwise run torch's
default of one intra-op thread a core, so W workers put W times as many busy
threads on the CPU as it has cores, and torch's spinning threads starve each
other: a torch test that takes 7 s alone took over ten minutes beside five
others. Every ``tests/test_torch_*.py`` imports this module first, and every
xdist worker collects every test file, so the first import pins the worker
for all the tests it runs, the torch code in the JAX package's test files
included. ``OMP_NUM_THREADS`` carries the same share to the processes a
test starts (the torch replicas that ``tests/test_weight_port.py`` builds in
a subprocess), unless the caller set it. Pytest does not collect this file
(its name does not start with ``test_``).
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
_SHARE = max(1, (os.cpu_count() or 1) // _WORKERS)
os.environ.setdefault("OMP_NUM_THREADS", str(_SHARE))
torch.set_num_threads(_SHARE)
try:
    # allowed only before the process's first inter-op parallel work
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass
