"""Training support (port of ``smilify_tpu/train/trainer.py``).

What the regressors' serving path needs: :class:`TrainState` and the
checkpoints (``<name>.pt`` holding the model's state dict beside the JAX
package's ``<name>.meta.json``: epoch, step, the full config and the
history), the pinned-memory :class:`StagingCollator`, the seeded dataset
splits and :class:`SubsetDataset`, and :class:`DeviceDataCache`. The train
step, the epoch runner and the host pipeline come with the trainers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device

# numpy dtype → the 32-bit one JAX's default mode stores (the JAX cache's columns)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


class DeviceDataCache:
    """An entire (small) dataset resident in device memory; each batch is a
    gather on the device driven by a small host index array.

    Columns are every numeric field of the samples, stacked. Images (the
    ``image_keys``) are stored as uint8 (lossless for JPEG-decoded data, a
    quarter of float32's bytes: 1,600 samples of 4 views at 96² are 177 MB)
    and converted to float in :meth:`batch`, so a step moves only a
    batch-size index array from the host. 64-bit columns are stored in 32
    bits, as the JAX package's cache stores them.

    One device only: the data-parallel form (a batch split over cards) comes
    with the multi-device trainers. On-the-fly augmentation needs the host
    pipeline.
    """

    def __init__(self, dataset, device="cuda", image_keys=("image", "images")):
        self.device = resolve_device(device)
        first = dataset[0]
        keys = [k for k, v in first.items()
                if isinstance(v, (np.ndarray, int, float, np.generic))
                and np.asarray(v).dtype.kind in "fiub"]
        stacked = {k: [] for k in keys}
        for i in range(len(dataset)):
            s = dataset[i]
            for k in keys:
                stacked[k].append(np.asarray(s[k]))
        cols = {}
        for k in keys:
            arr = np.stack(stacked[k])
            if k in image_keys and arr.dtype == np.float32:
                arr = np.round(arr * 255.0).astype(np.uint8)
            cols[k] = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
        self.n = len(dataset)
        self._image_keys = tuple(k for k in image_keys if k in cols)
        self.arrays = {k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}
        self.bytes = sum(t.numel() * t.element_size() for t in self.arrays.values())

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """The samples ``idx`` as a dict of device tensors, images as float in [0, 1]."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        b = {k: torch.index_select(v, 0, i) for k, v in self.arrays.items()}
        for k in self._image_keys:
            if b[k].dtype == torch.uint8:
                # times the float32 reciprocal, as XLA compiles the JAX cache's
                # division (true division rounds 126 of the 256 levels apart)
                b[k] = b[k].to(torch.float32) * (1.0 / 255.0)
        return b

    def iterate(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, fraction: float = 1.0):
        """Full batches over the cache (drop_last): the index sequence of the
        JAX cache for the same ``rng``."""
        idx = rng.permutation(self.n) if shuffle else np.arange(self.n)
        if fraction < 1.0:
            idx = idx[: max(1, int(self.n * fraction))]
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            yield self.batch(idx[i: i + batch_size])


# ---------------------------------------------------------------------------
# train state and checkpoints
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """``model_state`` is the model's ``state_dict()`` (parameters and
    BatchNorm statistics); ``opt_state`` the optimizer's, once the trainers
    keep one."""

    model_state: Dict[str, torch.Tensor]
    opt_state: Any = None
    epoch: int = 0
    step: int = 0
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg, name: str = "checkpoint") -> str:
    """``<ckpt_dir>/<name>.pt`` (model and optimizer state) and
    ``<ckpt_dir>/<name>.meta.json`` (epoch, step, the full config, the last
    50 history entries), as the JAX package writes its meta file. Returns
    the checkpoint's path, ``<ckpt_dir>/<name>``, which
    ``cli.run_inference.discover_checkpoint`` and :func:`load_checkpoint` take."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    model_state = {k: v.detach().cpu() for k, v in state.model_state.items()}
    torch.save({"model": model_state, "opt_state": state.opt_state}, path + ".pt")
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": state.epoch, "step": state.step, "config": cfg.to_dict(),
                   "history": state.history[-50:]}, f, indent=2, default=str)
    return path


def load_checkpoint(path: str):
    """(payload ``{"model": state dict, "opt_state": ...}`` on the CPU, meta
    dict) of the checkpoint at ``path`` (``<dir>/<name>``, without extension)."""
    payload = torch.load(path + ".pt", map_location="cpu", weights_only=False)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return payload, meta


# ---------------------------------------------------------------------------
# pinned staging buffers
# ---------------------------------------------------------------------------


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class StagingCollator:
    """Collate into a ring of ``depth`` persistent host buffers, pinned when
    a card is present, so that :meth:`to_device` copies them with
    ``non_blocking=True``.

    A batch aliases its ring slot, and a non-blocking copy reads the slot
    after the call has returned: rewriting the slot before that copy ends
    would corrupt the batch on the device without a trace. So
    :meth:`to_device` records a CUDA event behind its copies, and collating
    into that slot again first waits for the event (the copy only, not the
    work that consumes it). Returned host batches stay valid until
    ``depth − 1`` further batches have been collated. A batch whose keys,
    shapes or dtypes differ from the first one's (a ragged last batch) is
    stacked into fresh tensors instead."""

    def __init__(self, depth: int = 4):
        self.depth = depth
        self.pin = torch.cuda.is_available()
        self._ring: List[Dict[str, torch.Tensor]] = []
        self._slot = 0
        self._events: Dict[int, torch.cuda.Event] = {}

    def __call__(self, samples) -> Dict[str, torch.Tensor]:
        cols = {k: [np.asarray(s[k]) for s in samples] for k in samples[0].keys()}
        n = len(samples)
        if not self._ring:
            self._shapes = {k: (n,) + c[0].shape for k, c in cols.items()}
            self._dtypes = {k: c[0].dtype for k, c in cols.items()}
            self._ring = [
                {k: torch.empty(self._shapes[k], dtype=_torch_dtype(self._dtypes[k]),
                                pin_memory=self.pin) for k in self._shapes}
                for _ in range(self.depth)]
        ok = set(cols) == set(self._shapes) and all(
            (n,) + c[0].shape == self._shapes[k] and c[0].dtype == self._dtypes[k]
            for k, c in cols.items())
        if not ok:
            return {k: torch.from_numpy(np.stack(c)) for k, c in cols.items()}
        event = self._events.pop(self._slot, None)
        if event is not None:
            event.synchronize()   # the copy out of this slot has ended
        bufs = self._ring[self._slot]
        self._slot = (self._slot + 1) % self.depth
        for k, c in cols.items():
            host = bufs[k].numpy()
            for j, a in enumerate(c):
                host[j] = a
        return bufs

    def to_device(self, host_batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
        """``host_batch`` on ``device``; from a ring slot onto a card the
        copies are non-blocking and guarded by an event on the slot."""
        device = torch.device(device)
        out = {k: v.to(device, non_blocking=self.pin) for k, v in host_batch.items()}
        if device.type == "cuda":
            for s, bufs in enumerate(self._ring):
                if bufs is host_batch:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(device))
                    self._events[s] = event
        return out


# ---------------------------------------------------------------------------
# dataset splits
# ---------------------------------------------------------------------------


def split_dataset(n: int, ratios: Tuple[float, float, float], seed: int):
    """Seeded train/val/test index split."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    return idx[:n_train], idx[n_train:n_train + n_val], idx[n_train + n_val:]


def split_dataset_grouped(groups: np.ndarray, ratios: Tuple[float, float, float], seed: int):
    """Sample-level split over per-item group ids (expand_all_views: all
    views of a sample stay in one split, so no view leaks across)."""
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    tr_g, va_g, te_g = split_dataset(len(uniq), ratios, seed)
    idx = np.arange(len(groups))
    return tuple(idx[np.isin(groups, list(set(uniq[g])))] for g in (tr_g, va_g, te_g))


def split_dataset_per_group(groups: np.ndarray, ratios: Tuple[float, float, float], seed: int):
    """Split within each group and concatenate: every group contributes to
    every split (the 'per_dataset' strategy for combined datasets)."""
    groups = np.asarray(groups)
    tr, va, te = [], [], []
    for g in np.unique(groups):
        idx = np.nonzero(groups == g)[0]
        t, v, e = split_dataset(len(idx), ratios, seed + int(g))
        tr.append(idx[t])
        va.append(idx[v])
        te.append(idx[e])
    return np.concatenate(tr), np.concatenate(va), np.concatenate(te)


class SubsetDataset:
    """Index-subset view of a map-style dataset; forwards ``set_epoch`` /
    ``epoch`` (the per-epoch augmentation seed) to the wrapped dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)

    @property
    def epoch(self):
        return getattr(self.dataset, "epoch", None)
