"""Launch a script on several CPU ranks of one gloo process group.

The port's scale-out paths (``torch.distributed``) are held to the JAX
package on the CPU by running them in ``n`` processes started here with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT`` on a free local port), each given its share
of the test worker's threads (``tests/_torch_threads.py``: the ranks of one
launch share one worker's cores). Pytest does not collect this file.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PREAMBLE = """
import os, sys
import torch
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
torch.set_num_interop_threads(1)
from smilify_tpu_torch.train.multihost import maybe_initialize_multihost
maybe_initialize_multihost(True, device="cpu")
import torch.distributed as dist
RANK, WORLD = dist.get_rank(), dist.get_world_size()
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(n: int, body: str, tmp_path, args=(), timeout: int = 600) -> list:
    """Run PREAMBLE + ``body`` + EPILOGUE in ``n`` ranks (``sys.argv[1:]`` =
    ``args``); returns each rank's stdout. Fails with every rank's output
    when one exits non-zero or the launch outlives ``timeout``."""
    script = Path(tmp_path) / f"ranks_{n}.py"
    script.write_text(PREAMBLE + body + EPILOGUE)
    share = max(1, int(os.environ.get("OMP_NUM_THREADS", "1")) // n)
    port = _free_port()
    procs, logs = [], [Path(tmp_path) / f"ranks_{n}.{r}.log" for r in range(n)]
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS=str(share),
                   PYTHONPATH=str(REPO))
        env.pop("JAX_PLATFORMS", None)
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(script), *map(str, args)],
                                          env=env, cwd=str(REPO), stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r} ---\n{o[-6000:]}" for r, o in enumerate(outs)))
    return outs
