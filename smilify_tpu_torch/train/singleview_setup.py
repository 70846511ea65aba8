"""Shared glue for single-view regressor training, the twin of
``train/multiview_setup.py``: the ``apply_fn`` and the supervision targets
that the trainer CLI, the benches and the tests drive.
"""

from __future__ import annotations

import torch


def make_target_fn(spec, ignored_idx):
    """``target_dict(batch)``: the supervision targets of a batch, as the
    JAX trainer assembles them (the model's leading betas, cam_rot as 3×3,
    fov as a scalar a sample, visibility with the ignored joints zeroed)."""

    def target_dict(batch):
        targets = {name: batch[name] for name in (
            "global_rot", "joint_rot", "betas", "trans", "fov", "cam_rot", "cam_trans",
            "keypoints_3d", "silhouette") if name in batch}
        # a dataset made with a wider PCA space than the model's: the shared
        # leading components only
        if "betas" in targets and targets["betas"].shape[-1] != spec.n_betas:
            targets["betas"] = targets["betas"][..., : spec.n_betas]
        if "cam_rot" in targets and targets["cam_rot"].shape[-1] == 9:
            targets["cam_rot"] = targets["cam_rot"].reshape(targets["cam_rot"].shape[:-1] + (3, 3))
        if "fov" in targets and targets["fov"].ndim > 1:
            targets["fov"] = targets["fov"][..., 0]
        if "keypoints_2d" in batch:
            targets["keypoints_2d"] = batch["keypoints_2d"]
            vis = batch.get("keypoint_visibility")
            if vis is not None and ignored_idx:
                keep = torch.ones(vis.shape[-1], dtype=vis.dtype, device=vis.device)
                keep[list(ignored_idx)] = 0.0
                vis = vis * keep
            targets["kp_visibility"] = vis
        return targets

    return target_dict


def make_singleview_apply_fn(rcfg, spec):
    """``apply_fn(model, batch, train) -> preds`` for ``make_train_step`` /
    ``make_eval_step``: the decoded predictions and the IEF history of
    ``batch["image"]`` (``models/predict.py::decoded``)."""
    from smilify_tpu_torch.models.predict import decoded

    def apply_fn(model, batch, train):
        preds, history = decoded(model, rcfg, spec, batch)
        preds["ief_history"] = history
        return preds

    return apply_fn
