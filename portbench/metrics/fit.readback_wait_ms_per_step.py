"""Host ms in the span ``fit.readback`` (``run_stage``'s read-back of a chunk's
losses, one a chunk) over the count of ``fit.step``: the host waiting on
the card, a step.

Read from the program's recorder (``smilify_tpu_torch.utils.monitoring``),
which records while the profiler runs: the spans of both traced runs (the
device-only run and the short named run), each slowed by the profiler, so
these are traced times, for comparing commits. Nothing where the program
records no such span."""


def read(obs):
    if "trace" not in obs:
        return None
    try:
        from smilify_tpu_torch.utils.monitoring import summary
    except ImportError:
        return None
    spans = summary()["spans"]
    step, wait = spans.get("fit.step"), spans.get("fit.readback")
    if not step or not wait:
        return None
    return 1e3 * wait["host_s"] / step["count"]
