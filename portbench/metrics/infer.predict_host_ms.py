"""Host ms a batch of inference spends in the spans ``infer.predict``
(``run_inference.predictor``'s forward and decode) and
``infer.smil_forward`` (``forward_model``), over the count of
``infer.predict``.

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
    predict = spans.get("infer.predict")
    if not predict:
        return None
    smil = spans.get("infer.smil_forward", {"host_s": 0.0})
    return 1e3 * (predict["host_s"] + smil["host_s"]) / predict["count"]
