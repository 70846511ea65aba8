"""SLEAP multi-camera toolchain: calibration IO, DLT triangulation, camera
refinement, reprojection generation (port of ``smilify_tpu/data/sleap.py``;
the Rodrigues rotation is scipy's, the point undistortion imports OpenCV).

Host-side numpy equivalents of the reference's
``sleap_data/{sleap_3d_loader, triangulate_3d_points, refine_camera_params,
generate_reprojections}.py``:
  * anipose ``calibration.toml`` reader (per-camera K, distortion, rodrigues
    R, t) and ``points3d.h5`` writer/reader;
  * linear DLT triangulation from ≥min_views 2D observations with confidence
    thresholding (triangulate_3d_points.py);
  * alternating camera refinement: triangulate → per-camera 10-parameter
    (axis-angle R, t, f, cx, cy) reprojection optimization → repeat
    (refine_camera_params.py:1-18);
  * ideal-pinhole reprojection generation (generate_reprojections.py);
  * OpenCV→our-camera conversion lives in render.cameras.camera_from_opencv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from smilify_tpu_torch.data.canonical_frame import rodrigues_to_matrix


@dataclass
class CameraCalibration:
    name: str
    size: Tuple[int, int]              # (W, H)
    matrix: np.ndarray                 # (3, 3) K
    distortions: np.ndarray            # (k,) OpenCV distortion coeffs
    rotation: np.ndarray               # (3,) rodrigues
    translation: np.ndarray            # (3,)

    @property
    def R(self) -> np.ndarray:
        return rodrigues_to_matrix(self.rotation)

    @property
    def P(self) -> np.ndarray:
        """(3, 4) projection matrix K [R|t]."""
        return self.matrix @ np.concatenate([self.R, self.translation.reshape(3, 1)], axis=1)

    def project(self, pts3d: np.ndarray) -> np.ndarray:
        """(N, 3) world → (N, 2) ideal-pinhole pixels (no distortion)."""
        pc = pts3d @ self.R.T + self.translation
        return pc[:, :2] / np.maximum(pc[:, 2:3], 1e-12) * np.diag(self.matrix)[:2] + self.matrix[:2, 2]

    def undistort_points(self, pts2d: np.ndarray) -> np.ndarray:
        import cv2

        if not np.any(self.distortions):
            return pts2d
        und = cv2.undistortPoints(
            pts2d.reshape(-1, 1, 2).astype(np.float64), self.matrix, self.distortions, P=self.matrix
        )
        return und.reshape(-1, 2)


def load_calibration_toml(path: str) -> List[CameraCalibration]:
    """Read an anipose-style calibration.toml."""
    import tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    cams = []
    for key in sorted(k for k in data if k.startswith("cam")):
        c = data[key]
        cams.append(
            CameraCalibration(
                name=c.get("name", key),
                size=tuple(c["size"]),
                matrix=np.asarray(c["matrix"], np.float64),
                distortions=np.asarray(c.get("distortions", [0, 0, 0, 0, 0]), np.float64),
                rotation=np.asarray(c["rotation"], np.float64),
                translation=np.asarray(c["translation"], np.float64),
            )
        )
    return cams


def save_calibration_toml(path: str, cams: List[CameraCalibration]):
    lines = []
    for i, c in enumerate(cams):
        lines.append(f"[cam_{i}]")
        lines.append(f'name = "{c.name}"')
        lines.append(f"size = [{c.size[0]}, {c.size[1]}]")
        lines.append("matrix = [" + ", ".join(str(list(row)) for row in c.matrix.tolist()) + "]")
        lines.append(f"distortions = {c.distortions.tolist()}")
        lines.append(f"rotation = {c.rotation.tolist()}")
        lines.append(f"translation = {c.translation.tolist()}")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def triangulate_point_dlt(P_list: List[np.ndarray], uv_list: List[np.ndarray]) -> np.ndarray:
    """Linear DLT from ≥2 views: rows u·P₃−P₁, v·P₃−P₂, SVD null vector."""
    A = []
    for P, (u, v) in zip(P_list, uv_list):
        A.append(u * P[2] - P[0])
        A.append(v * P[2] - P[1])
    A = np.asarray(A)
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    return X[:3] / X[3]


def triangulate_frames(
    points2d: np.ndarray,
    scores: np.ndarray,
    cams: List[CameraCalibration],
    min_views: int = 2,
    min_confidence: float = 0.3,
    undistort: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """(F, V, K, 2) 2D tracks + (F, V, K) confidences → (F, K, 3) + validity.

    NaN 2D entries and low-confidence detections are excluded; joints seen by
    fewer than min_views cameras get NaN (reference triangulate_3d_points).
    """
    F, V, K, _ = points2d.shape
    Ps = [c.P for c in cams]
    out = np.full((F, K, 3), np.nan, np.float64)
    valid = np.zeros((F, K), bool)
    und = [None] * V
    for f in range(F):
        for k in range(K):
            P_list, uv_list = [], []
            for v in range(V):
                uv = points2d[f, v, k]
                if not np.all(np.isfinite(uv)) or scores[f, v, k] < min_confidence:
                    continue
                if undistort:
                    uv = cams[v].undistort_points(uv[None])[0]
                P_list.append(Ps[v])
                uv_list.append(uv)
            if len(P_list) >= min_views:
                out[f, k] = triangulate_point_dlt(P_list, uv_list)
                valid[f, k] = True
    return out, valid


def write_points3d_h5(path: str, points3d: np.ndarray, metadata: Optional[Dict] = None):
    from smilify_tpu_torch.utils import hdf5_io

    with hdf5_io.File(path, "w") as f:
        f.create_dataset("points3d", data=points3d.astype(np.float64))
        for k, v in (metadata or {}).items():
            f.attrs[k] = v


def read_points3d_h5(path: str) -> np.ndarray:
    from smilify_tpu_torch.utils import hdf5_io

    with hdf5_io.File(path, "r") as f:
        return f["points3d"][:]


# ---------------------------------------------------------------------------
# camera refinement (alternating optimization)
# ---------------------------------------------------------------------------


def reprojection_error(cams: List[CameraCalibration], points3d, points2d, scores, min_conf=0.3):
    """Mean pixel reprojection error over confident observations."""
    errs = []
    F, V, K, _ = points2d.shape
    for v, cam in enumerate(cams):
        for f in range(F):
            ok = (
                np.isfinite(points3d[f]).all(axis=1)
                & np.isfinite(points2d[f, v]).all(axis=1)
                & (scores[f, v] >= min_conf)
            )
            if ok.any():
                uv = cam.project(points3d[f][ok])
                errs.append(np.linalg.norm(uv - points2d[f, v][ok], axis=1))
    return float(np.concatenate(errs).mean()) if errs else np.inf


def refine_cameras(
    points2d: np.ndarray,
    scores: np.ndarray,
    cams: List[CameraCalibration],
    n_outer: int = 3,
    min_views: int = 2,
    min_confidence: float = 0.3,
    verbose: bool = False,
) -> Tuple[List[CameraCalibration], float]:
    """Alternate triangulation and per-camera 10-parameter refinement
    (axis-angle R (3), t (3), f (1 shared fx=fy... 2), cx, cy) against the
    reprojection error — reference refine_camera_params.py.
    """
    from scipy.optimize import least_squares

    cams = [CameraCalibration(c.name, c.size, c.matrix.copy(), c.distortions.copy(),
                              c.rotation.copy(), c.translation.copy()) for c in cams]
    err = None
    for it in range(n_outer):
        pts3d, valid = triangulate_frames(points2d, scores, cams, min_views, min_confidence)

        for v, cam in enumerate(cams):
            obs3d, obs2d = [], []
            F = points2d.shape[0]
            for f in range(F):
                ok = (
                    valid[f]
                    & np.isfinite(points2d[f, v]).all(axis=1)
                    & (scores[f, v] >= min_confidence)
                )
                if ok.any():
                    obs3d.append(pts3d[f][ok])
                    obs2d.append(points2d[f, v][ok])
            if not obs3d:
                continue
            X = np.concatenate(obs3d)
            U = np.concatenate(obs2d)

            def pack(c):
                return np.concatenate([
                    c.rotation, c.translation,
                    [c.matrix[0, 0], c.matrix[1, 1], c.matrix[0, 2], c.matrix[1, 2]],
                ])

            def unpack(p, c):
                K = c.matrix.copy()
                K[0, 0], K[1, 1], K[0, 2], K[1, 2] = p[6], p[7], p[8], p[9]
                return CameraCalibration(c.name, c.size, K, c.distortions, p[:3].copy(), p[3:6].copy())

            def residual(p, c=cam):
                cc = unpack(p, c)
                return (cc.project(X) - U).ravel()

            res = least_squares(residual, pack(cam), method="lm", max_nfev=200)
            cams[v] = unpack(res.x, cam)

        err = reprojection_error(cams, pts3d, points2d, scores, min_confidence)
        if verbose:
            print(f"refine iter {it}: mean reprojection error {err:.4f} px")
    return cams, err


def generate_reprojections(
    points3d: np.ndarray, cams: List[CameraCalibration]
) -> np.ndarray:
    """(F, K, 3) → ideal-pinhole (F, V, K, 2) reprojections (undistorted 2D
    supervision; reference generate_reprojections.py)."""
    F, K, _ = points3d.shape
    V = len(cams)
    out = np.full((F, V, K, 2), np.nan, np.float64)
    for v, cam in enumerate(cams):
        for f in range(F):
            ok = np.isfinite(points3d[f]).all(axis=1)
            if ok.any():
                out[f, v, ok] = cam.project(points3d[f][ok])
    return out
