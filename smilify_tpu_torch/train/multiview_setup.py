"""Shared glue for multi-view regressor training (port of
``smilify_tpu/train/multiview_setup.py``): the ``apply_fn`` / ``loss_fn``
builders that the trainer CLI, the benches and the tests drive, including
the ground-truth camera initialization of the camera head's delta mode.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from smilify_tpu_torch.core.rotations import matrix_to_rotation_6d

# OpenCV (x right, y down) → the port's axes (x left, y up): a 180° turn about z
_RZ180 = (-1.0, -1.0, 1.0)


def batch_to_view_cams(batch: Dict[str, torch.Tensor], image_size: Tuple[int, int]):
    """The batch's OpenCV cameras (``camera_extrinsics_R`` (B, V, 3, 3),
    ``camera_extrinsics_t`` (B, V, 3), ``camera_intrinsics`` (B, V, 3, 3)) in
    the port's convention, as ``render.cameras.camera_from_opencv`` converts
    one: {view_cam_rot (B, V, 3, 3), view_cam_trans (B, V, 3), view_fov (B, V)},
    the targets of ``compute_multiview_batch_loss``."""
    H, _ = image_size
    R_cv, t_cv, K_cv = (batch[k] for k in ("camera_extrinsics_R", "camera_extrinsics_t",
                                          "camera_intrinsics"))
    flip = torch.tensor(_RZ180, dtype=R_cv.dtype, device=R_cv.device)
    R = (R_cv * flip[:, None]).transpose(-1, -2)
    T = t_cv * flip
    half_h = torch.full_like(K_cv[..., 1, 1], H / 2.0)
    fov = 2.0 * torch.atan2(half_h, K_cv[..., 1, 1]) * (180.0 / math.pi)
    return {"view_cam_rot": R, "view_cam_trans": T, "view_fov": fov}


def gt_camera_init(batch: Dict[str, torch.Tensor], image_size: Tuple[int, int]):
    """The ground-truth cameras in the camera head's raw parameterization
    (fov, rot6d, trans), for its delta mode."""
    cams = batch_to_view_cams(batch, image_size)
    return {"fov": cams["view_fov"], "rot6d": matrix_to_rotation_6d(cams["view_cam_rot"]),
            "trans": cams["view_cam_trans"]}


def make_multiview_apply_fn(rcfg, spec, image_size: Tuple[int, int]):
    """``apply_fn(model, batch, train) -> preds`` for ``make_train_step`` /
    ``make_eval_step``: the decoded predictions and the IEF history
    (``models/predict.py::decoded``). With the camera head's delta mode on,
    the batch's cameras initialize it."""
    from smilify_tpu_torch.models.predict import decoded

    def apply_fn(model, batch, train):
        gt_cams = None
        if rcfg.camera_delta_mode and "camera_extrinsics_R" in batch:
            gt_cams = gt_camera_init(batch, image_size)
        preds, hist = decoded(model, rcfg, spec, batch, gt_cameras=gt_cams)
        preds["ief_history"] = hist
        return preds

    return apply_fn


def make_multiview_loss_fn(spec, rcfg, weights: Dict[str, float], image_size: Tuple[int, int],
                           joint_importance=None, ignored_joint_indices=None):
    """``loss_fn(preds, batch) -> (total, components)``. ``joint_importance``:
    optional (K,) per-joint weights; ``ignored_joint_indices`` drops those
    joints from the 2D supervision."""
    from smilify_tpu_torch.models.multiview import compute_multiview_batch_loss

    H, W = image_size

    def loss_fn(preds, batch):
        gt_cams = batch_to_view_cams(batch, image_size)
        vis = batch["keypoint_visibility"]
        if ignored_joint_indices:
            keep = torch.ones(vis.shape[-1], dtype=vis.dtype, device=vis.device)
            keep[list(ignored_joint_indices)] = 0.0
            vis = vis * keep
        kp = batch["keypoints_2d"]
        targets = {
            "global_rot": batch["global_rot"],
            "joint_rot": batch["joint_rot"],
            "betas": batch["betas"][..., : spec.n_betas],
            "trans": batch["trans"],
            # stored pixel (x, y); the loss takes normalized (y, x)
            "keypoints_2d": kp.flip(-1) / torch.tensor([H, W], dtype=torch.float32,
                                                       device=kp.device),
            "kp_visibility": vis,
            "keypoints_3d": batch["keypoints_3d"],
            **gt_cams,
        }
        return compute_multiview_batch_loss(
            spec, rcfg, preds, targets, batch["view_mask"], dict(weights),
            image_size=image_size, joint_importance=joint_importance)

    return loss_fn
