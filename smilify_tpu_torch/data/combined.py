"""Unified dataset dispatch + multi-dataset mixing (port of
``smilify_tpu/data/combined.py``).

Equivalents of the reference's ``UnifiedSMILDataset.from_path`` auto-dispatch
(smil_datasets.py:147-228) and ``CombinedSMILDataset`` (combined_dataset.py:15):
mix several datasets with per-dataset sampling weights and per-dataset
available-label masks (so samples from label-poor datasets only supervise the
losses they can).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

DEFAULT_AVAILABLE_LABELS = {
    "pose": True,
    "betas": True,
    "trans": True,
    "camera": True,
    "scale_trans": True,
    "keypoints_2d": True,
    "keypoints_3d": True,
    "silhouette": True,
}


def open_dataset(path: str, joint_names=None, **kwargs):
    """Auto-dispatch on path contents (reference UnifiedSMILDataset.from_path)."""
    from smilify_tpu_torch.data.hdf5_dataset import (
        MultiViewHDF5Dataset,
        SingleViewHDF5Dataset,
        detect_dataset_type,
    )

    kind = detect_dataset_type(path)
    if kind == "replicant_raw":
        from smilify_tpu_torch.data.replicant import ReplicantDataset

        if joint_names is None:
            raise ValueError("replicant_raw datasets need joint_names")
        return ReplicantDataset(path, joint_names, **kwargs)
    if "multiview" in kind:
        mv_kwargs = {k: v for k, v in kwargs.items() if k in
                     ("num_views_to_use", "view_sampling", "seed", "world_scale")}
        return MultiViewHDF5Dataset(path, **mv_kwargs)
    return SingleViewHDF5Dataset(path)


class CombinedDataset:
    """Weighted mixture of datasets with availability-label masks.

    ``__getitem__`` flat-indexes the concatenation; ``sampling_weights()``
    returns per-sample weights implementing the reference's weighted sampler
    (combined_dataset.py:254): each dataset's total probability mass is
    proportional to its configured weight.
    Samples gain an ``availability`` dict of {label: bool} used by the loss
    engine's availability masks.
    """

    def __init__(self, entries: List[Dict]):
        """entries: [{dataset, weight, available_labels, name}, ...]"""
        self.datasets = []
        self.weights = []
        self.labels = []
        self.names = []
        for e in entries:
            self.datasets.append(e["dataset"])
            self.weights.append(float(e.get("weight", 1.0)))
            self.labels.append(dict(DEFAULT_AVAILABLE_LABELS, **(e.get("available_labels") or {})))
            self.names.append(e.get("name", f"dataset_{len(self.names)}"))
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return d, idx - int(self.offsets[d])

    def __getitem__(self, idx: int):
        d, local = self._locate(idx)
        sample = dict(self.datasets[d][local])
        sample["availability"] = dict(self.labels[d])
        sample["dataset_name"] = self.names[d]
        return sample

    @property
    def group_ids(self) -> np.ndarray:
        """Dataset id per flat sample index (for per-dataset split strategies)."""
        out = np.zeros(len(self), np.int64)
        for d in range(len(self.datasets)):
            out[self.offsets[d] : self.offsets[d + 1]] = d
        return out

    def sampling_weights(self) -> np.ndarray:
        """Per-sample weights: dataset weight spread over its samples."""
        w = np.zeros(len(self))
        for d, ds in enumerate(self.datasets):
            n = len(ds)
            if n:
                w[self.offsets[d] : self.offsets[d + 1]] = self.weights[d] / n
        return w / w.sum()

    def sample_indices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return rng.choice(len(self), size=n, p=self.sampling_weights())


def build_combined_from_config(cfg, joint_names=None):
    """MultiDatasetConfig entries → CombinedDataset (reference MultiDatasetEntry)."""
    entries = []
    for e in cfg.multi_dataset.datasets:
        if not e.get("enabled", True):
            continue
        ds = open_dataset(e["path"], joint_names=joint_names)
        entries.append({
            "dataset": ds,
            "weight": e.get("weight", 1.0),
            "available_labels": e.get("available_labels"),
            "name": e.get("name", e["path"]),
        })
    if not entries:
        raise ValueError("multi_dataset enabled but no enabled entries")
    return CombinedDataset(entries)
