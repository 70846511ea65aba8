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
