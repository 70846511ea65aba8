"""Canonical-camera-frame math (host-side numpy; port of
``smilify_tpu/data/canonical_frame.py``).

Behavioral equivalent of the reference ``multiview_common/canonical_frame.py``:
pick the lowest-index valid camera as the world origin, express every other
camera and the 3D keypoints relative to it, with an exact inverse. OpenCV
column-vector convention throughout: ``X_cam = R @ X_world + t``.

The (0, 0, 0) sentinel for joints without ground-truth 3D is preserved
exactly (reference canonical_frame.py:100-105).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def canonicalize_sample(
    R: np.ndarray, t: np.ndarray, kp3d: np.ndarray, view_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Re-anchor world coordinates at the lowest-index valid camera.

    Returns (R_new, t_new, kp3d_new, R_0, t_0, canonical_view).
    """
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    kp3d = np.asarray(kp3d, dtype=np.float64)
    view_mask = np.asarray(view_mask, dtype=bool)

    valid = np.nonzero(view_mask)[0]
    if valid.size == 0:
        raise ValueError("canonicalize_sample: view_mask has no True entries")
    v0 = int(valid[0])
    R0, t0 = R[v0].copy(), t[v0].copy()

    R_new = R.copy()
    t_new = t.copy()
    for v in valid:
        R_new[v] = R[v] @ R0.T
        t_new[v] = t[v] - R_new[v] @ t0

    kp3d_new = kp3d.copy()
    nonzero = ~np.all(kp3d == 0.0, axis=1)
    kp3d_new[nonzero] = kp3d[nonzero] @ R0.T + t0
    return R_new, t_new, kp3d_new, R0, t0, v0


RZ_180 = np.diag([-1.0, -1.0, 1.0])


def camera_from_opencv_np(R_cv: np.ndarray, t_cv: np.ndarray, K_cv: np.ndarray,
                          image_size) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Numpy twin of :func:`smilify_tpu_torch.render.cameras.camera_from_opencv`
    for host-side dataset code (no device work inside loader threads).

    Returns (R_row (3,3), T (3,), fov_deg, aspect)."""
    H, W = image_size
    Rz180 = RZ_180
    R_p3d = Rz180 @ np.asarray(R_cv, np.float64)
    t_p3d = Rz180 @ np.asarray(t_cv, np.float64)
    fx, fy = float(K_cv[0, 0]), float(K_cv[1, 1])
    fov = 2.0 * np.degrees(np.arctan2(H / 2.0, fy))
    aspect = (fy / fx) * (W / H)
    return R_p3d.T, t_p3d, float(fov), float(aspect)


def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """(3,) axis-angle → (3, 3) rotation matrix in float64, as
    ``cv2.Rodrigues(rvec)[0]`` (which the card's machine lacks)."""
    return Rotation.from_rotvec(np.asarray(rvec, np.float64).reshape(3)).as_matrix()


def matrix_to_rodrigues(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix → (3,) axis-angle in float64, as
    ``cv2.Rodrigues(R)[0].reshape(3)``."""
    return Rotation.from_matrix(np.asarray(R, np.float64)).as_rotvec()


def rotate_axis_angle_left(aa: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Compose a rotation matrix on the left of an axis-angle: aa(M @ R(aa))."""
    R = rodrigues_to_matrix(aa)
    return matrix_to_rodrigues(np.asarray(M, np.float64) @ R)


def recanonicalize_single_view(R_cv: np.ndarray, t_cv: np.ndarray, kp3d: np.ndarray):
    """Re-express ONE chosen camera as the world origin (camera-at-origin).

    The single-view-from-multiview convention (reference
    ``canonical_frame.recanonicalize_single_view`` used at
    ``sleap_multiview_dataset.py:717``): anchor the world on the sampled view,
    then rotate by Rz(180°) so the resulting OpenCV camera ``(Rz180, 0)`` maps
    to the renderer-identity camera ``(R=I, T=0)`` through the OpenCV→renderer
    conversion. 3D keypoints land in the frame the trainer's mesh
    (``verts + trans``) lives in; (0,0,0) sentinels are preserved.

    Returns ``(kp3d_view, R_cv_out, t_cv_out, M, b)`` where ``M = Rz180 @ R0``
    and ``b = Rz180 @ t0`` move world-frame root pose into the view frame:
    ``root_loc' = M @ root_loc + b``, ``global_rot' = M ∘ global_rot``.
    """
    R1 = np.asarray(R_cv, np.float64).reshape(1, 3, 3)
    t1 = np.asarray(t_cv, np.float64).reshape(1, 3)
    _R_c, _t_c, kp3d_c, R0, t0, _ = canonicalize_sample(
        R1, t1, kp3d, np.array([True])
    )
    kp3d_view = kp3d_c.copy()
    nonzero = ~np.all(kp3d_c == 0.0, axis=1)
    kp3d_view[nonzero] = kp3d_c[nonzero] @ RZ_180.T
    M = RZ_180 @ R0
    b = RZ_180 @ t0
    return kp3d_view, RZ_180.copy(), np.zeros(3), M, b


def decanonicalize_points(kp3d_can: np.ndarray, R0: np.ndarray, t0: np.ndarray) -> np.ndarray:
    """Inverse transform: X_world = R0ᵀ (X_can − t0); zero sentinels preserved."""
    out = kp3d_can.copy().astype(np.float64)
    nonzero = ~np.all(kp3d_can == 0.0, axis=1)
    out[nonzero] = (kp3d_can[nonzero] - t0) @ R0
    return out


def project_world_to_pixel(X_world: np.ndarray, R: np.ndarray, t: np.ndarray, K: np.ndarray) -> np.ndarray:
    """OpenCV pinhole projection: (N, 3) world → (N, 2) pixel (x, y)."""
    Xc = X_world @ R.T + t
    uv = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-12)
    return uv @ K[:2, :2].T + K[:2, 2]


def cam_center_world(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -R.T @ t


def kp2d_norm_yx_to_pixel_xy(kp2d_norm_yx: np.ndarray, img_W: int, img_H: int) -> np.ndarray:
    """Normalized (y, x) in [0, 1] → pixel (x, y)."""
    return np.stack([kp2d_norm_yx[..., 1] * img_W, kp2d_norm_yx[..., 0] * img_H], axis=-1)


def infer_world_scale(t: np.ndarray, view_mask: np.ndarray, threshold: float = 50.0) -> float:
    """mm→m heuristic: median camera distance > 50 means millimetre units
    (reference canonical_frame.py:349)."""
    norms = np.linalg.norm(np.asarray(t)[np.asarray(view_mask, bool)], axis=-1)
    if norms.size and np.median(norms) > threshold:
        return 0.001
    return 1.0
