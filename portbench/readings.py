"""What the per-layer readers share. Each reads ``obs``, the driver's record
of a run with ``--trace 1``: ``window`` (the untraced window's seconds,
steps and items), ``trace`` (the traced window: busy_s, window_s, steps,
ops {device operation: [seconds, count]}, n_ops), ``work`` (the
benchmark's own counts a step or an item, and the peak they are held to)
and ``chips``. A reader returns None where it finds nothing to read."""

from __future__ import annotations


def idle_pct(obs):
    """The share of a step in which the device ran nothing: the traced
    steps' busy seconds (the union of their device operations, averaged
    over the cards) against the untraced window's seconds a step. The
    profiler's own cost lengthens the traced steps themselves by about half
    (a launch costs the host more while it is recorded), so their window
    would overstate the idle share."""
    t, w = obs.get("trace"), obs.get("window")
    if not t or not w or not t["steps"] or not w["steps"]:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (w["seconds"] / w["steps"]))


def ops_per_step(obs):
    t = obs.get("trace")
    return t["n_ops"] / t["steps"] if t and t["steps"] else None


def mfu(obs, per: str):
    """Share of the cards' peak: the work a step (``per='step'``) or an item
    times the untraced window's rate."""
    w, work = obs.get("window"), obs.get("work")
    if not w or not work or w["seconds"] <= 0:
        return None
    done = w["steps"] if per == "step" else w["items"]
    if not done:
        return None
    flops = work["flops_per_step"] if per == "step" else work["flops_per_item"]
    return 100.0 * flops * done / w["seconds"] / (obs["chips"] * work["peak_flops"])


def device_ms_per_step(obs, *names):
    """Device ms a traced step of the operations whose name holds any of ``names``."""
    t = obs.get("trace")
    if not t or not t["steps"]:
        return None
    secs = [v[0] for k, v in t["ops"].items() if any(n in k.lower() for n in names)]
    return 1e3 * sum(secs) / t["steps"] if secs else None
