"""Training support (port of ``smilify_tpu/train/trainer.py``).

This slice ports :class:`DeviceDataCache`; the trainers, the host pipeline
and the checkpoints follow with the neural models.
"""

from __future__ import annotations

from typing import Dict

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
