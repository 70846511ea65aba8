"""Pre-decoded sample cache for host-side datasets (port of
``smilify_tpu/data/cache.py``).

JPEG decode and crop dominate a host-side input pipeline. Training epochs
revisit every sample, so decoding each sample ONCE and serving subsequent
epochs from RAM removes that overhead (the reference's "10-12x faster data
loading" preprocessed-HDF5 claim, neuralSMIL/README.md:309, one level
further up the hierarchy).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np


def _nbytes(sample) -> int:
    if isinstance(sample, dict):
        return sum(_nbytes(v) for v in sample.values())
    if isinstance(sample, np.ndarray):
        return sample.nbytes
    return sys.getsizeof(sample)


class DecodedSampleCache:
    """Map-style dataset wrapper that memoizes decoded samples in RAM.

    ``max_bytes`` bounds the cache; once full, further samples pass through
    undecorated (no eviction — training access is uniform-random, so an LRU
    would thrash). ``eager=True`` materializes everything up front.

    NOTE: wrap the *clean* dataset and put augmentation wrappers OUTSIDE the
    cache — augmentation must resample per epoch.
    """

    def __init__(self, dataset, max_bytes: Optional[int] = 2 << 30, eager: bool = False):
        self.dataset = dataset
        self.max_bytes = max_bytes
        self._cache = {}
        self._bytes = 0
        self._full = False
        if eager:
            for i in range(len(dataset)):
                self[i]

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        # Only consulted for attributes missing on the wrapper itself.
        # Guard against recursion during unpickling: pickle probes dunders
        # (__setstate__ et al.) before __dict__ is restored, when
        # ``self.dataset`` does not exist yet.
        try:
            dataset = object.__getattribute__(self, "__dict__")["dataset"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(dataset, name)

    def cache_info(self):
        return {"cached": len(self._cache), "bytes": self._bytes, "full": self._full}

    def __getitem__(self, idx: int):
        idx = int(idx)
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        sample = self.dataset[idx]
        if not self._full:
            n = _nbytes(sample)
            if self.max_bytes is None or self._bytes + n <= self.max_bytes:
                self._cache[idx] = sample
                self._bytes += n
            else:
                self._full = True
        return sample
