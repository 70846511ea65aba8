"""Host ms a train step spends in the span ``train.step`` (``make_train_step``'s
step: forward, loss, backward and the optimizer enqueued), over the count
of ``train.step``.

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
    step = spans.get("train.step")
    if not step:
        return None
    return 1e3 * step["host_s"] / step["count"]
