"""Device-stream ms in the span ``model.backbone`` (the ViT's forward over every view image of the step (its backward runs in ``train.backward``)) over the count of ``train.step``.

Read from the program's recorder (``smilify_tpu_torch.utils.monitoring``),
which records while the profiler runs: each span's pair of CUDA events,
their interval on the stream (its kernels and the stream's wait for their
launches), over both traced runs (the device-only run and the short named
run). Nothing where the program records no such span or ran off the card."""

from portbench.readings_mv import span_device_ms_per_step


def read(obs):
    return span_device_ms_per_step(obs, "model.backbone")
