"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and no
    card is visible (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def set_float32_matmul(dev: torch.device) -> None:
    """TF32 off on a card: float32 is float32, as in the JAX package. Entry
    points call it, not library code: the benchmark's controls need TF32 on."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def device_constant(values, dtype, device) -> torch.Tensor:
    """The 1-D tensor ``values`` on ``device``. While the current stream
    captures a CUDA graph, :func:`filled`: the capture refuses
    ``torch.tensor``'s copy from host memory. Otherwise that copy, which
    costs the host less (on an H100, 20.9 µs a 6-vector against 70.5, and
    ~2% of a B=128 train step)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        return filled(values, dtype, device)
    return torch.tensor(values, dtype=dtype, device=device)


_SHARED = {}        # (values, dtype, device) → the tensor shared_constant made


def shared_constant(values, dtype, device) -> torch.Tensor:
    """:func:`device_constant`'s tensor, made once per (values, dtype,
    device) and kept, so that later calls, and CUDA graphs captured after
    the first, copy nothing from host memory (a blocking copy the card
    waits on). One tensor serves every caller: for a constant that is only
    read, never written nor returned as a result. While a graph captures,
    a constant not made yet is made inside the graph and not kept; while
    ``torch.export`` or ``torch.compile`` traces, each call makes its own
    (their tensors stand for values, and must not be kept)."""
    if torch.compiler.is_compiling():
        return device_constant(values, dtype, device)
    device = torch.device(device)
    key = (tuple(values), dtype, device)
    const = _SHARED.get(key)
    if const is None:
        const = device_constant(values, dtype, device)
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _SHARED[key] = const
    return const


def filled(values, dtype, device) -> torch.Tensor:
    """The 1-D tensor ``values`` made on ``device`` by one fill kernel a
    value, each rounded to ``dtype`` as ``torch.tensor`` rounds it."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array: how the
    host-side numpy modules read a spec's tensors."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def card_line() -> str:
    """Card 0's ``name, power limit`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (raises where nvidia-smi fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
