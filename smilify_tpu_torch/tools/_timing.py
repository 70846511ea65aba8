"""Step timing by the slope of two chain lengths (port of ``tools/_timing.py``).

PyTorch returns from a CUDA call before the device has finished it, so a
host clock around a loop measures the enqueue unless the loop ends in a
synchronization. Every timed loop here is a dependent chain (each step
consumes the previous one's output, so no step can be skipped), ends in a
value fetch, and is measured at two chain lengths, so the slope cancels the
fixed cost of the fetch and of the first launch.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def _first_tensor(state):
    if isinstance(state, torch.Tensor):
        return state
    if dataclasses.is_dataclass(state):
        state = [getattr(state, f.name) for f in dataclasses.fields(state)]
    elif isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        for item in state:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def sync(state):
    """Synchronize with the device by fetching one scalar of the first tensor
    in ``state`` (a tensor, or a tuple, list, dict or dataclass holding
    tensors) to the host."""
    leaf = _first_tensor(state)
    if leaf is None:
        raise TypeError(f"no tensor in state of type {type(state).__name__}")
    float(leaf.detach().reshape(-1)[0])


def timeit_chain(step, state, n1=8, n2=32, warmup=2, repeats=3, target_s=1.0):
    """Steady-state seconds per iteration of a self-chained ``step``
    (state → state: each step's output feeds the next step's input).

    Two-point slope: time n1 and n2 dependent iterations, each window ended
    by a value fetch; (t2 − t1) / (n2 − n1) cancels the fetch's fixed cost.
    The pair is measured ``repeats`` times and the median slope returned.

    n1/n2 are lower bounds: a probe window of n1 iterations estimates the
    cost of one, and both are scaled up (by at most 64×) so that the n2 − n1
    gap covers about ``target_s`` seconds. The JAX package's version took
    40 ms off the probe as the guess of a tunneled TPU's sync cost; on a
    local card a value fetch costs microseconds, so that guess is gone.

    A window restarts from ``state``. Where ``step`` updates its state in
    place (a ``torch.optim`` optimizer over leaf tensors), ``state`` is the
    same object each time, so the windows are consecutive stretches of one
    chain rather than restarts.
    """
    for _ in range(warmup):
        state = step(state)
    sync(state)

    t0 = time.perf_counter()
    s = state
    for _ in range(n1):
        s = step(s)
    sync(s)
    per_est = max((time.perf_counter() - t0) / n1, 1e-6)
    scale = max(1, min(64, round(target_s / (per_est * (n2 - n1)))))
    n1, n2 = n1 * scale, n2 * scale

    slopes = []
    for _ in range(repeats):
        times = []
        for n in (n1, n2):
            s = state
            t0 = time.perf_counter()
            for _ in range(n):
                s = step(s)
            sync(s)
            times.append(time.perf_counter() - t0)
        slopes.append((times[1] - times[0]) / (n2 - n1))
    slopes.sort()
    return slopes[len(slopes) // 2]
