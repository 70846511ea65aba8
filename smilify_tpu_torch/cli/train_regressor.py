"""Single-view regressor training CLI (port of
``smilify_tpu/cli/train_regressor.py``), partial.

This slice ports what inference and benchmarking share with training:
:func:`parse_set_overrides` (the ``--set a.b=c`` surface) and
:func:`build_dataset` (a config's data path → dataset). The training entry
point ``main`` comes with the trainers.
"""

from __future__ import annotations

import json


def parse_set_overrides(pairs):
    """``["a.b=1", "c.d=x"]`` → ``{"a.b": 1, "c.d": "x"}`` (values parsed as
    JSON where they parse)."""
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        out[key] = val
    return out


def build_dataset(cfg, spec):
    """(dataset, kind) for ``cfg.dataset.data_path``: a replicAnt folder, a
    single- or multi-view HDF5 store (a multi-view store read one view an
    item for a single-view config), or the weighted multi-dataset mix."""
    from smilify_tpu_torch.data.hdf5_dataset import (
        MultiViewHDF5Dataset,
        SingleViewHDF5Dataset,
        detect_dataset_type,
    )
    from smilify_tpu_torch.data.replicant import ReplicantDataset

    res = cfg.model.input_resolution or 224
    if cfg.multi_dataset.enabled:
        from smilify_tpu_torch.data.combined import build_combined_from_config

        return build_combined_from_config(cfg, joint_names=spec.joint_names), "combined"
    path = cfg.dataset.data_path
    kind = detect_dataset_type(path)
    if kind == "replicant_raw":
        return ReplicantDataset(path, spec.joint_names, image_size=res), kind
    if kind.endswith("multiview") or kind == "sleap_multiview":
        if cfg.mode == "multi_view":
            return MultiViewHDF5Dataset(
                path, num_views_to_use=cfg.multiview.num_views_to_use, seed=cfg.training.seed,
            ), kind
        return MultiViewHDF5Dataset(
            path,
            return_single_view=True,
            camera_centric=cfg.dataset.frame_convention == "camera_centric",
            expand_all_views=cfg.dataset.expand_all_views,
            seed=cfg.training.seed,
        ), kind
    return SingleViewHDF5Dataset(path), kind
