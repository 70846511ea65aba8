"""Device-stream ms of the span ``raster.setup`` (the work-list raster's face
packing and per-tile lists, ``topk`` included) over the count of
``fit.step``: the interval between its CUDA events, the set-up's kernels
plus any wait for their launches.

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
    step, setup = spans.get("fit.step"), spans.get("raster.setup")
    if not step or not setup or setup["device_s"] is None:
        return None
    return 1e3 * setup["device_s"] / step["count"]
