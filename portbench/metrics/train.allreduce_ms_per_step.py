"""Rank 0's NCCL kernels' device ms a train step (the gradient all-reduces
and the global BatchNorm's statistics); nothing where no NCCL kernel ran."""

from portbench.readings import device_ms_per_step


def read(obs):
    return device_ms_per_step(obs, "nccl")
