"""Tracing, profiling and memory monitoring (port of
``smilify_tpu/utils/monitoring.py``).

Equivalents of the reference's ``PerformanceMonitor`` (fitter_3d/SDF_tests.py:18-61)
and ``MemoryMonitor`` (neuralSMIL/memory_optimization.py:17-64): device
memory comes from ``torch.cuda.memory_allocated`` for each visible card,
host memory from /proc/self/status (no psutil dependency).
:func:`profile_trace` captures a ``torch.profiler`` trace (CPU and, where a
card is visible, CUDA activity) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def host_memory_mb() -> float:
    """Resident set size of this process in MB (Linux: /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    raise RuntimeError("/proc/self/status has no VmRSS line")


def device_memory_stats() -> Dict[str, float]:
    """MB allocated by this process's tensors on each visible card
    (``torch.cuda.memory_allocated``), keyed ``cuda:<i>``; ``{}`` when no
    card is visible."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_allocated(i) / 1e6
            for i in range(torch.cuda.device_count())}


class PerformanceMonitor:
    """Section timers with a tabular report (reference SDF_tests.py:18-61)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._starts = {}

    def start(self, section: str):
        self._starts[section] = time.perf_counter()

    def end(self, section: str):
        if section in self._starts:
            self.totals[section] += time.perf_counter() - self._starts.pop(section)
            self.counts[section] += 1

    @contextlib.contextmanager
    def section(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    def report(self) -> str:
        lines = [f"{'section':30s} {'total s':>10s} {'count':>7s} {'mean ms':>10s}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:10.3f} {c:7d} {1000*t/max(c,1):10.2f}")
        mem = device_memory_stats()
        for dev, mb in mem.items():
            lines.append(f"device {dev}: {mb:.0f} MB in use")
        lines.append(f"host RSS: {host_memory_mb():.0f} MB")
        return "\n".join(lines)


class MemoryMonitor:
    """Periodic host+device memory snapshots (reference MemoryMonitor)."""

    def __init__(self):
        self.snapshots = []

    def snapshot(self, tag: str = ""):
        entry = {"tag": tag, "t": time.time(), "host_mb": host_memory_mb()}
        entry.update({f"dev_{i}": mb for i, mb in enumerate(device_memory_stats().values())})
        self.snapshots.append(entry)
        return entry

    def peak_host_mb(self) -> float:
        return max((s["host_mb"] for s in self.snapshots), default=0.0)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace_<pid>_<time>.json`` (Chrome trace format; Perfetto and
    chrome://tracing read it). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# memory/config recommendation (reference memory_optimization.py:270-291)
# ---------------------------------------------------------------------------

# The reference's rough per-sample activation footprints at 224² input (MB)
# and parameter footprints (MB), kept as the JAX package has them: estimates,
# not measurements on the card (chip_smoke.py phase 14 logs resnet50's
# measured peak beside them).
_BACKBONE_ACTIVATION_MB = {
    "resnet50": 95,
    "resnet101": 130,
    "resnet152": 165,
    "vit_base_patch16_224": 110,
    "vit_large_patch16_224": 260,
    "unet_resnet34": 140,
    "unet_resnet50": 210,
    "unet_efficientnet_b0": 130,
    "unet_efficientnet_b3": 170,
    "unet_efficientnet_b5": 260,
    "unet_small": 45,
}
_BACKBONE_PARAM_MB = {
    "resnet50": 100,
    "resnet101": 170,
    "resnet152": 230,
    "vit_base_patch16_224": 330,
    "vit_large_patch16_224": 1160,
    "unet_resnet34": 120,
    "unet_resnet50": 135,
    "unet_efficientnet_b0": 30,
    "unet_efficientnet_b3": 65,
    "unet_efficientnet_b5": 135,
    "unet_small": 20,
}


def recommend_batch_size(
    backbone: str,
    hbm_gb: float | None = None,
    input_resolution: int = 224,
    n_views: int = 1,
    safety: float = 0.6,
) -> dict:
    """Suggest a per-card batch size from the backbone's estimated memory
    footprint.

    ``hbm_gb`` defaults to the current card's memory
    (``torch.cuda.get_device_properties(...).total_memory``); with no card
    and no ``hbm_gb`` this raises. The footprints are the reference's
    estimates."""
    if hbm_gb is None:
        if not torch.cuda.is_available():
            raise RuntimeError("recommend_batch_size: no CUDA card to read the memory of; "
                               "pass hbm_gb")
        hbm_gb = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory / 1e9
    act = _BACKBONE_ACTIVATION_MB.get(backbone, 150) * (input_resolution / 224.0) ** 2
    par = _BACKBONE_PARAM_MB.get(backbone, 200)
    # params + optimizer state (adamw: 2 extra copies) + grads
    fixed = par * 4
    per_sample = act * n_views * 3  # activations kept for backward, rough 3x
    budget = hbm_gb * 1000 * safety - fixed
    bs = max(1, int(budget // per_sample))
    return {
        "backbone": backbone,
        "hbm_gb": hbm_gb,
        "recommended_batch_size": bs,
        "per_sample_mb": per_sample,
        "fixed_mb": fixed,
        "note": "estimates; use gradient_accumulation_steps beyond this",
    }
