"""Reading a traced window: ``torch.profiler`` over the device, then the
device's busy seconds (the union of its operations' intervals: NCCL's
overlap the compute's), its operations by name; and, from a second, short
trace of host and device, the idle gaps between device operations named by
the host operation that was running in each."""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def record(run, device, name_run=None) -> dict:
    """Profile ``run()`` with device activity only (host operations
    recorded would slow the host and widen the idle share) and read: busy_s,
    window_s (host clock, from the profiler's start to a synchronised
    end), ops {name: [seconds, count]}, n_ops. ``name_run()``, when given,
    runs again under a host and device trace, which names the idle gaps:
    idle {host operation running in the gap: seconds}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, _ = _events(prof)
    ops = defaultdict(lambda: [0.0, 0])
    for start, end, name in dev:
        ops[name][0] += (end - start) / 1e6
        ops[name][1] += 1
    busy, _ = _busy(dev)
    out = {"busy_s": busy / 1e6, "window_s": window_s, "ops": dict(ops), "n_ops": len(dev),
           "idle": {}}
    if name_run is not None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            name_run()
            torch.cuda.synchronize(device)
        dev, host = _events(prof)
        out["idle"] = _name_gaps(_busy(dev)[1], host)
    return out


def _events(prof):
    """(device events [(start, end, name)], host events by thread), in µs."""
    from torch.autograd import DeviceType

    dev, host = [], defaultdict(list)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((start, end, e.name))
        elif end > start:
            host[e.thread].append((start, end, e.name))
    return dev, host


def _busy(dev):
    """(µs in which some device operation ran, the gaps between them)."""
    busy, gaps, last = 0.0, [], None
    for start, end, _ in sorted(dev):
        if last is None or start > last:
            if last is not None:
                gaps.append((last, start))
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    return busy, gaps


def _name_gaps(gaps, host) -> dict:
    """{innermost host operation at each gap's middle: idle seconds}."""
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    best = [(float("inf"), "host: no operation")] * len(mids)
    for events in host.values():
        events.sort(key=lambda e: (e[0], -e[1]))
        stack, i = [], 0
        for j, (m, _) in enumerate(mids):
            while i < len(events) and events[i][0] <= m:
                while stack and stack[-1][1] < events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            if stack:
                s, e, name = stack[-1]
                if e - s < best[j][0]:
                    best[j] = (e - s, name)
    idle = defaultdict(float)
    for (_, length), (_, name) in zip(mids, best):
        idle[name] += length / 1e6
    return dict(idle)


def breakdown(t: dict) -> dict:
    """The ten device operations that took most time and the ten host
    operations that the device waited on longest (names cut at 160 letters)."""
    def top(d, key):
        return [[k[:160], key(v)] for k, v in sorted(d.items(), key=lambda kv: -key(kv[1]))[:10]]
    return {"device_ops": top(t["ops"], lambda v: v[0]), "idle_gaps": top(t["idle"], lambda v: v)}
