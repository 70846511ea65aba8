"""CUDA-graph replays of the train step (counter ``train.graph.replays``,
``make_train_step``'s step replayed as one graph) over the count of the
span ``train.step``: 1.0 where every step replays its graph, 0.0 where the
step runs eagerly (a step that waits on the host, several ranks).

Read from the program's recorder (``smilify_tpu_torch.utils.monitoring``),
which records while the profiler runs: the steps of both traced runs.
Nothing where the program counts no ``train.graph.*`` (it replays no
graph of the step) or records no ``train.step``."""


def read(obs):
    if "trace" not in obs:
        return None
    try:
        from smilify_tpu_torch.utils.monitoring import summary
    except ImportError:
        return None
    s = summary()
    step = s["spans"].get("train.step")
    counters = s["counters"]
    if not step or not any(k.startswith("train.graph.") for k in counters):
        return None
    return counters.get("train.graph.replays", 0) / step["count"]
