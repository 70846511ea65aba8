"""Tracing, profiling and memory monitoring (port of
``smilify_tpu/utils/monitoring.py``).

The program's spans and counters: ``with span("fit.step"): ...`` around a
layer's call, ``count("raster.exact_fwd.launches")`` where work happens,
both recorded by the process's :class:`PerformanceMonitor` only inside
:func:`recording` or while a ``torch.profiler`` profile is active. Off,
:func:`span` returns one shared no-op and :func:`count` returns at once.
On, a span records its name, start, end and parent span; its self time is
its duration less what its child spans cover. On the card it also records
a pair of CUDA timing events on the current stream, whose interval is its
device-stream time (its kernels plus any wait for the host's launches),
folded into the totals once complete and resolved by :func:`summary`,
never synchronized while recording. Under a profiler each span also opens
a ``record_function`` range, so the profiler's trace (and
:func:`profile_trace`'s Chrome trace) carries it on the profiler's clock
beside the device's operations.

``MemoryMonitor`` is the reference's (neuralSMIL/memory_optimization.py:17-64):
device memory comes from ``torch.cuda.memory_allocated`` for each visible
card, host memory from /proc/self/status (no psutil dependency).
:func:`profile_trace` captures a ``torch.profiler`` trace (CPU and, where a
card is visible, CUDA activity) as a Chrome trace file.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, NamedTuple

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class SpanRecord(NamedTuple):
    """One finished span: its index, name, start and end
    (``time.perf_counter_ns``) and the index of the span open when it began
    (-1 at the top)."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int


class _NoSpan:
    """What :meth:`PerformanceMonitor.span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("monitor", "name", "index", "parent", "start", "child_ns", "events", "range")

    def __init__(self, monitor, name):
        self.monitor, self.name = monitor, name

    def __enter__(self):
        self.monitor._open_span(self)
        self.range = None
        if _profiler_enabled():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.events = self.monitor._event_pair()
        if self.events is not None:
            self.events[1].record(self.events[0])
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[2].record(self.events[0])
        if self.range is not None:
            self.range.__exit__(*exc)
        self.monitor._close_span(self, end)
        return False


class PerformanceMonitor:
    """Spans and counters, recorded only while :meth:`recording` is open
    or a ``torch.profiler`` profile is active (the reference's section
    timers, SDF_tests.py:18-61, grown into spans).

    One stack of open spans serves the process: a span opened on autograd's
    worker thread while the caller waits in ``backward()`` nests under the
    caller's span. Each name's count, host time, self time and device-stream
    time are summed as its spans finish; the last ``LOG_SPANS`` finished
    spans are kept in :attr:`log`."""

    LOG_SPANS = 4096
    FOLD_EVERY = 256        # pending event pairs before the completed ones are folded in

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._next = 0
        self._open = []
        self.reset()

    def reset(self) -> None:
        """Forget every finished span, the counters and the pending events."""
        with self._lock:
            self._totals = {}       # name -> [count, host ns, self ns]
            self._device_ms = {}    # name -> device-stream ms of the folded event pairs
            self._pending = []      # (name, (stream, start event, end event))
            self._counters = {}
            self.log = collections.deque(maxlen=self.LOG_SPANS)

    def span(self, name: str):
        """A context manager timing the block as ``name``; the shared no-op
        while nothing records."""
        if not self._depth and not _profiler_enabled():
            return _NO_SPAN
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` while recording."""
        if not self._depth and not _profiler_enabled():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Record spans and counters inside the block."""
        with self._lock:
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1

    def _open_span(self, s: _Span) -> None:
        with self._lock:
            s.index = self._next
            self._next += 1
            s.parent = self._open[-1] if self._open else None
            s.child_ns = 0
            self._open.append(s)

    def _close_span(self, s: _Span, end: int) -> None:
        ns = end - s.start
        with self._lock:
            self._open.remove(s)
            if s.parent is not None:
                s.parent.child_ns += ns
            t = self._totals.setdefault(s.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += ns - s.child_ns
            self.log.append(SpanRecord(s.index, s.name, s.start, end,
                                       -1 if s.parent is None else s.parent.index))
            if s.events is not None:
                self._pending.append((s.name, s.events))
                if len(self._pending) >= self.FOLD_EVERY:
                    self._fold(wait=False)

    def _event_pair(self):
        """(the current stream, start event, end event) for a span's
        device-stream time, or None off the card (and while the stream
        captures a graph)."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        return (torch.cuda.current_stream(), torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _fold(self, wait: bool) -> None:
        """Add the completed event pairs' ms to their names' totals; with
        ``wait``, every pair's (the events are resolved when read)."""
        pending = []
        for name, (stream, start, end) in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                pending.append((name, (stream, start, end)))
                continue
            self._device_ms[name] = self._device_ms.get(name, 0.0) + start.elapsed_time(end)
        self._pending = pending

    def summary(self) -> dict:
        """``{"spans": {name: {count, host_s, self_s, device_s}}, "counters":
        {name: n}}``; ``device_s`` is None for a name whose spans ran off the
        card."""
        with self._lock:
            self._fold(wait=True)
            spans = {name: {"count": c, "host_s": host / 1e9, "self_s": own / 1e9,
                            "device_s": (self._device_ms[name] / 1e3
                                         if name in self._device_ms else None)}
                     for name, (c, host, own) in self._totals.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def report(self) -> str:
        s = self.summary()
        lines = [f"{'span':30s} {'count':>7s} {'total s':>10s} {'self s':>10s} "
                 f"{'device s':>10s} {'mean ms':>10s}"]
        for name, v in sorted(s["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
            dev = "-" if v["device_s"] is None else f"{v['device_s']:.3f}"
            lines.append(f"{name:30s} {v['count']:7d} {v['host_s']:10.3f} {v['self_s']:10.3f} "
                         f"{dev:>10s} {1000 * v['host_s'] / v['count']:10.2f}")
        for name, n in sorted(s["counters"].items()):
            lines.append(f"{name:30s} {n:7d}")
        for dev, mb in device_memory_stats().items():
            lines.append(f"device {dev}: {mb:.0f} MB in use")
        lines.append(f"host RSS: {host_memory_mb():.0f} MB")
        return "\n".join(lines)


# the process's recorder: the program's spans and counters go here
MONITOR = PerformanceMonitor()
span = MONITOR.span
count = MONITOR.count
recording = MONITOR.recording
summary = MONITOR.summary
reset = MONITOR.reset


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
