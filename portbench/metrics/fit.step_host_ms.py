"""Host ms a fitter step spends in the span ``fit.step`` (``SmalFitter.run_stage``'s
step: forward, losses, backward and Adam enqueued), over the count of
``fit.step``: the host's enqueue of a step.

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
    step = spans.get("fit.step")
    if not step:
        return None
    return 1e3 * step["host_s"] / step["count"]
