"""Multi-view session → HDF5 preprocessing (port of
``smilify_tpu/data/preprocess_multiview.py``; the resize and the
undistortion import OpenCV where they run, as the JPEG writer that follows
them does).

Equivalent of the reference ``sleap_data/preprocess_sleap_multiview_dataset.py``
(and the replicAnt multi-view preprocessor sharing its schema): per frame and
camera — undistort image + keypoints, crop (default / centred / bbox_crop),
adjust intrinsics for the crop, JPEG-encode — then group synchronized frames
across cameras under a canonical camera order and write the shared multi-view
HDF5 (writer in :mod:`smilify_tpu_torch.data.hdf5_dataset`).

Crop semantics replicate _preprocess_image (:1203-1290): ``centred`` takes the
central square, ``bbox_crop`` a 1.05× square around the visible keypoints
clamped to the frame, ``default`` anisotropic resize. Intrinsics updates:
crop subtracts the offset from the principal point; resize scales
focal/principal by the factor (``:1310``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class CropResult:
    image: np.ndarray          # (R, R, 3) float [0, 1] (or (R, R[, C]))
    keypoints: np.ndarray      # (K, 2) pixel xy in the output image
    K_new: np.ndarray          # (3, 3) adjusted intrinsics
    offset: Tuple[float, float]
    scale: Tuple[float, float]


def crop_and_resize(
    image: np.ndarray,
    keypoints_xy: np.ndarray,
    K: np.ndarray,
    target_resolution: int,
    mode: str = "default",
) -> CropResult:
    import cv2

    H, W = image.shape[:2]
    if mode == "centred":
        crop = min(H, W)
        y0 = (H - crop) // 2
        x0 = (W - crop) // 2
        img = image[y0 : y0 + crop, x0 : x0 + crop]
        s = target_resolution / crop
        sy = sx = s
    elif mode == "bbox_crop":
        valid = keypoints_xy[np.isfinite(keypoints_xy).all(axis=1)]
        valid = valid[(valid[:, 0] > 0) & (valid[:, 1] > 0)]
        if len(valid) == 0:
            return crop_and_resize(image, keypoints_xy, K, target_resolution, "default")
        x_min, y_min = valid.min(axis=0)
        x_max, y_max = valid.max(axis=0)
        cx, cy = (x_min + x_max) / 2, (y_min + y_max) / 2
        size = max(x_max - x_min, y_max - y_min) * 1.05
        half = size / 2
        x_start, x_end = cx - half, cx + half
        y_start, y_end = cy - half, cy + half
        if x_start < 0:
            x_end = min(W, x_end - x_start)
            x_start = 0
        if x_end > W:
            x_start = max(0, x_start - (x_end - W))
            x_end = W
        if y_start < 0:
            y_end = min(H, y_end - y_start)
            y_start = 0
        if y_end > H:
            y_start = max(0, y_start - (y_end - H))
            y_end = H
        y0, x0 = int(y_start), int(x_start)
        # ceil the crop ends so keypoints on the bbox edge stay inside
        img = image[y0 : int(np.ceil(y_end)), x0 : int(np.ceil(x_end))]
        s = target_resolution / max(img.shape[:2])
        sy = sx = s
        crop = None
    else:  # default
        y0 = x0 = 0
        img = image
        sy = target_resolution / H
        sx = target_resolution / W

    if mode == "centred":
        pass
    img_r = cv2.resize(img, (target_resolution, target_resolution))
    if img_r.dtype != np.float32:
        img_r = img_r.astype(np.float32)
    if img_r.max() > 1.5:
        img_r = img_r / 255.0

    kp = keypoints_xy.astype(np.float64).copy()
    kp[:, 0] = (kp[:, 0] - x0) * sx
    kp[:, 1] = (kp[:, 1] - y0) * sy

    K_new = K.astype(np.float64).copy()
    K_new[0, 0] *= sx
    K_new[1, 1] *= sy
    K_new[0, 2] = (K[0, 2] - x0) * sx
    K_new[1, 2] = (K[1, 2] - y0) * sy
    return CropResult(img_r, kp, K_new, (y0, x0), (sy, sx))


def undistort_view(image: np.ndarray, keypoints_xy: np.ndarray, K: np.ndarray, dist: np.ndarray):
    """cv2 undistortion of both image and keypoints (reference :969)."""
    import cv2

    if not np.any(dist):
        return image, keypoints_xy
    img_u = cv2.undistort(image, K, dist)
    finite = np.isfinite(keypoints_xy).all(axis=1)
    kp_u = keypoints_xy.copy()
    if finite.any():
        und = cv2.undistortPoints(
            keypoints_xy[finite].reshape(-1, 1, 2).astype(np.float64), K, dist, P=K
        ).reshape(-1, 2)
        kp_u[finite] = und
    return img_u, kp_u


def filter_outlier_3d(points3d: np.ndarray, max_abs: float = 10.0, zscore: float = 4.0):
    """Zero out implausible 3D keypoints (reference outlier filtering :895):
    values beyond max_abs or beyond ``zscore`` robust deviations are reset to
    the (0,0,0) no-GT sentinel."""
    out = points3d.copy()
    nz = ~np.all(out == 0, axis=-1)
    if nz.sum() < 3:
        return out
    pts = out[nz]
    med = np.median(pts, axis=0)
    mad = np.median(np.abs(pts - med), axis=0) + 1e-9
    bad = (np.abs(pts - med) / mad > zscore).any(axis=1) | (np.abs(pts) > max_abs).any(axis=1)
    idx = np.nonzero(nz)[0][bad]
    out[idx] = 0.0
    return out


def preprocess_session_frames(
    frames: List[Dict],
    canonical_camera_order: Sequence[str],
    target_resolution: int,
    crop_mode: str = "default",
    undistort: bool = True,
    min_views_per_sample: int = 2,
) -> List[Dict]:
    """Synchronized per-frame camera groups → padded multi-view samples.

    Each input frame dict: {camera_name: {image (H,W,3) uint8, keypoints_xy
    (K,2), scores (K,), K (3,3), dist (k,), R (3,3), t (3,)}} plus optional
    'frame_idx', 'keypoints_3d', 'session_name'.
    Returns sample dicts for :func:`write_multiview_hdf5`.
    """
    cam_to_id = {c: i for i, c in enumerate(canonical_camera_order)}
    samples = []
    for frame in frames:
        views = {k: v for k, v in frame.items() if isinstance(v, dict) and "image" in v}
        if len(views) < min_views_per_sample:
            continue
        images, kp2d, kpv, Ks, Rs, ts, sizes, cam_ids, names = [], [], [], [], [], [], [], [], []
        for cam in canonical_camera_order:
            if cam not in views:
                continue
            v = views[cam]
            img, kp = v["image"], np.asarray(v["keypoints_xy"], np.float64)
            K = np.asarray(v["K"], np.float64)
            if undistort and v.get("dist") is not None:
                img, kp = undistort_view(img, kp, K, np.asarray(v["dist"]))
            res = crop_and_resize(img, kp, K, target_resolution, crop_mode)
            scores = np.asarray(v.get("scores", np.ones(len(kp))), np.float32)
            inb = (
                np.isfinite(res.keypoints).all(axis=1)
                & (res.keypoints[:, 0] >= 0) & (res.keypoints[:, 0] < target_resolution)
                & (res.keypoints[:, 1] >= 0) & (res.keypoints[:, 1] < target_resolution)
            )
            vis = scores * inb
            images.append((np.clip(res.image, 0, 1) * 255).astype(np.uint8))
            kp2d.append(np.nan_to_num(res.keypoints).astype(np.float32))
            kpv.append(vis.astype(np.float32))
            Ks.append(res.K_new.astype(np.float32))
            Rs.append(np.asarray(v["R"], np.float32))
            ts.append(np.asarray(v["t"], np.float32))
            sizes.append([target_resolution, target_resolution])
            cam_ids.append(cam_to_id[cam])
            names.append(cam)
        if len(images) < min_views_per_sample:
            continue
        kp3d = frame.get("keypoints_3d")
        if kp3d is not None:
            kp3d = filter_outlier_3d(np.nan_to_num(np.asarray(kp3d, np.float32)))
        samples.append({
            "images": images,
            "camera_indices": cam_ids,
            "camera_names": names,
            "keypoints_2d": np.stack(kp2d),
            "keypoint_visibility": np.stack(kpv),
            "camera_intrinsics": np.stack(Ks),
            "camera_extrinsics_R": np.stack(Rs),
            "camera_extrinsics_t": np.stack(ts),
            "image_sizes": np.asarray(sizes, np.int32),
            "keypoints_3d": kp3d,
            "session_name": frame.get("session_name", "session"),
            "frame_idx": frame.get("frame_idx", len(samples)),
        })
    return samples
