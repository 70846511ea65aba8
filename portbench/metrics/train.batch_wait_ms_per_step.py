"""Host ms in the span ``data.batch`` (``DeviceDataCache.batch``: the index
array's copy to the card, which waits for the card, and the gathers) over
the count of ``train.step``.

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
    step, batch = spans.get("train.step"), spans.get("data.batch")
    if not step or not batch:
        return None
    return 1e3 * batch["host_s"] / step["count"]
