"""What the multi-view cell's span readers share (``readings.py`` holds
the others')."""

from __future__ import annotations


def span_device_ms_per_step(obs, name: str):
    """Device-stream ms of the span ``name`` over the count of
    ``train.step``, from the program's recorder, in a traced run; None
    where either span is missing or has no device time."""
    if "trace" not in obs:
        return None
    try:
        from smilify_tpu_torch.utils.monitoring import summary
    except ImportError:
        return None
    spans = summary()["spans"]
    step, span = spans.get("train.step"), spans.get(name)
    if not step or not span or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / step["count"]
