"""CUDA graphs of the port's steps: a call's kernels captured once per
input signature and replayed, so a step that the host would issue more
slowly than the card runs it costs the host one launch.

:class:`Replayer` holds the graphs of one function (the serving path's
predictor, the train step): a key's first call runs eagerly (cuDNN's
choices, lazy set-up, the allocator); with ``check_syncs`` its second
also runs eagerly, under torch's sync debug mode, and a key whose call
waits on the host (a read-back, a copy from pageable memory) runs eagerly
from then on; the next call captures the graph and replays it, later ones
copy their inputs into the graph's and replay. The same kernels run on
the same numbers either way. On the CPU every call runs eagerly.
"""

from __future__ import annotations

import warnings

import torch
from torch.utils import _pytree as pytree

from smilify_tpu_torch.utils import monitoring

# what torch's sync debug mode warns with (c10/cuda/CUDAFunctions.cpp)
_SYNC_WARNING = "called a synchronizing CUDA operation"
_SYNCS = "synchronizes"     # a key whose eager call waited on the host


def graph_key(inputs) -> tuple:
    """Whether a call may replay another's CUDA graph: the same names and
    the same device, shape and dtype of every input tensor (``inputs``, a
    dict of tensors)."""
    return tuple((k, x.device, tuple(x.shape), x.dtype) for k, x in inputs.items())


class Graphed:
    """``fn(inputs)`` → tensors (in tuples, lists and dicts), captured once
    into a CUDA graph over static copies of ``inputs`` (a dict of tensors).
    A call copies its inputs into them, replays, and returns clones of the
    static outputs, so what a caller keeps is never overwritten by a later
    call. Dropping it frees the graph and its memory pool."""

    def __init__(self, fn, inputs):
        self.inputs = {k: x.clone() for k, x in inputs.items()}
        self.graph = torch.cuda.CUDAGraph()
        # autocast's cast cache off while capturing: a cast cached outside
        # the graph's memory pool could be freed under the graph
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            device = next(iter(inputs.values())).device
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(device)):
                self.outputs = fn(self.inputs)
        finally:
            torch.set_autocast_cache_enabled(cache)

    def __call__(self, inputs):
        for k, x in inputs.items():
            self.inputs[k].copy_(x)
        self.graph.replay()
        return pytree.tree_map(torch.clone, self.outputs)


def _eager_syncs(fn, inputs):
    """``(fn(inputs), whether the call waited on the host)``: the call runs
    under torch's sync debug mode, which warns at every synchronizing CUDA
    call (a read-back, a blocking copy, a stream or event wait); other
    warnings pass on as they were."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(inputs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = [w for w in seen if _SYNC_WARNING in str(w.message)]
    for w in seen:
        if w not in syncs:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return out, bool(syncs)


class Replayer:
    """``fn(inputs)`` (``inputs`` a dict of tensors on one device) run
    through a CUDA graph per :func:`graph_key`, as the module says.
    Counted while recording: ``<counters>.eager`` (every call run eagerly),
    ``<counters>.captures`` (every graph captured) and
    ``<counters>.replays`` (every replay, a capturing call's included)."""

    def __init__(self, fn, counters: str, check_syncs: bool = False):
        self.fn, self.counters, self.check_syncs = fn, counters, check_syncs
        self.graphs = {}    # graph_key → eager calls so far, _SYNCS, or its Graphed

    def eager(self, inputs):
        monitoring.count(self.counters + ".eager")
        return self.fn(inputs)

    def __call__(self, inputs):
        device = next(iter(inputs.values())).device
        if device.type != "cuda":
            return self.eager(inputs)
        key = graph_key(inputs)
        seen = self.graphs.get(key, 0)
        if seen == 0 or seen == _SYNCS:
            self.graphs[key] = seen or 1
            return self.eager(inputs)
        if seen == 1 and self.check_syncs:
            # the call after the first, where lazy set-up no longer copies
            monitoring.count(self.counters + ".eager")
            out, synced = _eager_syncs(self.fn, inputs)
            self.graphs[key] = _SYNCS if synced else 2
            return out
        with torch.cuda.device(device):
            if not isinstance(seen, Graphed):
                monitoring.count(self.counters + ".captures")
                seen = self.graphs[key] = Graphed(self.fn, inputs)
            monitoring.count(self.counters + ".replays")
            return seen(inputs)
