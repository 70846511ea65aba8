"""What a trainer shows of itself each visualization epoch (port of
``smilify_tpu/train/train_viz.py``):

  * collages of a few samples: the image with the ground-truth keypoints,
    with the predicted keypoints, the hard-Phong render of the predicted
    body overlaid, and the render alone (PNG through ``utils/image_io.py``);
  * a scatter of predicted against ground-truth 3D keypoints (matplotlib,
    where it imports);
  * the IEF head's health: the norms of its estimates' updates, iteration
    by iteration, and a PCK@5px on the visualization batch.

One eval forward a visualization epoch feeds all three.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.render.cameras import default_camera


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ief_delta_norms(history: List) -> Dict[str, float]:
    """Root-mean-square of each IEF iteration's change of the running
    estimate: {"ief_<group>_delta_iter<i>": norm} for a history of dicts,
    {"ief_delta_iter<i>": norm} for flat (B, total) estimates. A healthy head
    shows shrinking deltas; exploding or zero deltas are the failures."""
    out: Dict[str, float] = {}
    for i in range(1, len(history)):
        prev, cur = history[i - 1], history[i]
        if isinstance(cur, dict):
            for k in cur:
                d = _np(cur[k]) - _np(prev[k])
                out[f"ief_{k}_delta_iter{i}"] = float(np.sqrt((d ** 2).mean()))
        else:
            d = _np(cur) - _np(prev)
            out[f"ief_delta_iter{i}"] = float(np.sqrt((d ** 2).mean()))
    return out


def _body_forward(spec, preds, idx):
    """Posed vertices and joints of decoded sample ``idx`` (model space + trans)."""
    theta = torch.cat([preds["global_rot"][idx][None, None, :], preds["joint_rot"][idx][None]],
                      dim=1)
    log_scales = preds.get("log_beta_scales")
    joint_trans = preds.get("betas_trans")
    out = smil_forward(spec, preds["betas"][idx][None], theta,
                       log_scales=None if log_scales is None else log_scales[idx][None],
                       joint_trans=None if joint_trans is None else joint_trans[idx][None])
    trans = preds["trans"][idx]
    return out.verts[0] + trans, out.joints[0] + trans


def _sample_camera(preds, batch, i, multiview: bool, device):
    """(camera, the view shown, gt keypoints (x, y) or normalized (y, x), visibility)."""
    cam = default_camera(device=device)
    if multiview:
        vm = _np(batch["view_mask"][i])
        v = int(np.nonzero(vm)[0][0]) if vm.any() else 0
        cam = cam.replace(R=preds["view_cam_rot"][i, v], T=preds["view_cam_trans"][i, v],
                          fov=preds["view_fov"][i, v])
        return cam, v, _np(batch["keypoints_2d"][i, v]), _np(batch["keypoint_visibility"][i, v]), vm
    cam = cam.replace(R=preds["cam_rot"][i], T=preds["cam_trans"][i], fov=preds["fov"][i])
    gt = _np(batch["keypoints_2d"][i])
    vis = _np(batch["keypoint_visibility"][i]) if "keypoint_visibility" in batch \
        else np.ones(gt.shape[:1])
    return cam, None, gt, vis, None


def _quick_pck(spec, preds, batch, image_size, multiview: bool, thr_px: float = 5.0):
    """PCK@5px of the predicted joints projected through the predicted
    cameras on the visualization batch; None when no keypoint is visible."""
    H, W = image_size
    device = preds["global_rot"].device
    hits, total = 0, 0
    for i in range(int(preds["global_rot"].shape[0])):
        _, joints3d = _body_forward(spec, preds, i)
        cam, _, gt_xy, vis, vm = _sample_camera(preds, batch, i, multiview, device)
        if multiview and not vm.any():
            continue
        vis = vis > 0
        if not vis.any():
            continue
        if np.nanmax(np.abs(gt_xy)) <= 1.5:
            # normalized (y, x) convention → pixel (x, y)
            gt_xy = np.stack([gt_xy[:, 1] * W, gt_xy[:, 0] * H], axis=-1)
        yx = _np(cam.project_points_yx(joints3d, (H, W)))
        K = min(len(yx), len(gt_xy))
        err = np.linalg.norm(yx[:K, ::-1] - gt_xy[:K], axis=-1)
        hits += int((err[vis[:K]] < thr_px).sum())
        total += int(vis[:K].sum())
    return (hits / total) if total else None


def render_epoch_collages(spec, preds: Dict, batch: Dict, image_size, out_dir: str, epoch: int,
                          max_samples: int = 4, multiview: bool = True) -> List[str]:
    """Collage PNGs, one a sample: ground-truth keypoints, predicted
    keypoints, the Phong render of the predicted body over the image, the
    render alone. Returns their paths."""
    from smilify_tpu_torch.render.phong import render_phong
    from smilify_tpu_torch.utils.image_io import write_png
    from smilify_tpu_torch.utils.visualization import draw_joints

    H, W = image_size
    device = preds["global_rot"].device
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(min(max_samples, int(preds["global_rot"].shape[0]))):
        verts, joints3d = _body_forward(spec, preds, i)
        cam, v, gt_kp, gt_vis, _ = _sample_camera(preds, batch, i, multiview, device)
        img = _np(batch["images"][i, v] if multiview else batch["image"][i])
        kp_yx = _np(cam.project_points_yx(joints3d, (H, W)))
        pv = cam.world_to_view(verts)
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        shaded = _np(render_phong(verts, pv, ndc, spec.faces, (H, W)))
        if gt_kp.size and np.nanmax(np.abs(gt_kp)) <= 1.5:
            gt_yx = gt_kp * np.asarray([H, W], dtype=gt_kp.dtype)   # normalized (y, x)
        else:
            gt_yx = gt_kp[:, ::-1]                                   # pixel (x, y)
        collage = np.concatenate([draw_joints(img, gt_yx, gt_vis),
                                  draw_joints(img, kp_yx, np.ones(len(kp_yx))),
                                  shaded * 0.6 + img * 0.4, shaded], axis=1)
        path = os.path.join(out_dir, f"epoch{epoch:04d}_sample{i}.png")
        write_png(path, (np.clip(collage, 0, 1) * 255).astype(np.uint8))
        paths.append(path)
    return paths


def plot_3d_keypoints(pred_joints, gt_joints: Optional[np.ndarray], out_path: str,
                      title: str = "3D keypoints") -> Optional[str]:
    """Predicted (red) against ground-truth (green) 3D keypoints; returns
    the path, or None where matplotlib does not import (the card's machine)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    p = _np(pred_joints)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], c="red", s=12, label="pred")
    if gt_joints is not None:
        g = np.asarray(gt_joints)
        nz = ~np.all(g == 0, axis=-1)
        ax.scatter(g[nz, 0], g[nz, 1], g[nz, 2], c="green", s=12, label="gt")
        for a, b in zip(p[nz], g[nz]):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="gray", lw=0.5)
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


def epoch_visualization(spec, apply_fn, model, batch: Dict, image_size, out_root: str,
                        epoch: int, multiview: bool = True, max_samples: int = 4,
                        viz_dir: str = "visualizations") -> Dict[str, float]:
    """One eval forward of ``model`` on a host batch (numpy, as collated
    from the dataset) → collages and the 3D plot under ``out_root/viz_dir``;
    returns the IEF delta norms and the PCK for the trainer's history."""
    from smilify_tpu_torch.train.trainer import narrow_floats

    device = next(model.parameters()).device
    dev_batch = narrow_floats({k: torch.as_tensor(np.asarray(v)).to(device)
                               for k, v in batch.items()})
    was_training = model.training
    model.eval()
    with torch.no_grad():
        preds = apply_fn(model, dev_batch, False)
        metrics = ief_delta_norms(preds.get("ief_history") or [])
        pck = _quick_pck(spec, preds, batch, image_size, multiview=multiview)
        if pck is not None:
            metrics["ief_val_pck5"] = pck
        out_dir = os.path.join(out_root, viz_dir)
        render_epoch_collages(spec, preds, batch, image_size, out_dir, epoch,
                              max_samples=max_samples, multiview=multiview)
        _, joints3d = _body_forward(spec, preds, 0)
    gt = batch.get("keypoints_3d")
    plot_3d_keypoints(joints3d, None if gt is None else np.asarray(gt[0]),
                      os.path.join(out_dir, f"epoch{epoch:04d}_kp3d.png"), title=f"epoch {epoch}")
    model.train(was_training)
    return metrics
