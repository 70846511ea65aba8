"""AMASS-compatible animation export (port of
``smilify_tpu/utils/animation_export.py``; host-side numpy).

Equivalent of the reference ``neuralSMIL/animation_export.py`` (schema v1.1):
records per-frame SMIL parameters and writes an AMASS-style ``.npz``
(poses as flattened axis-angle, trans, betas) plus a JSON sidecar with
metadata. Rotations are normalized to axis-angle on write regardless of the
recording representation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

SCHEMA_VERSION = "1.1"


class AnimationRecorder:
    """Accumulate per-frame parameters and export (reference AnimationRecorder:40)."""

    def __init__(self, model_name: str = "SMIL", fps: float = 30.0):
        self.model_name = model_name
        self.fps = fps
        self.frames: List[Dict[str, np.ndarray]] = []

    def add_frame(
        self,
        global_rot: np.ndarray,
        joint_rot: np.ndarray,
        trans: np.ndarray,
        betas: Optional[np.ndarray] = None,
        log_beta_scales: Optional[np.ndarray] = None,
        betas_trans: Optional[np.ndarray] = None,
    ):
        """Rotations may be axis-angle (…, 3), matrices (…, 3, 3) or 6D (…, 6)."""
        self.frames.append(
            {
                "global_rot": self._to_axis_angle(np.asarray(global_rot)),
                "joint_rot": self._to_axis_angle(np.asarray(joint_rot)),
                "trans": np.asarray(trans, np.float32),
                "betas": None if betas is None else np.asarray(betas, np.float32),
                "log_beta_scales": None if log_beta_scales is None else np.asarray(log_beta_scales, np.float32),
                "betas_trans": None if betas_trans is None else np.asarray(betas_trans, np.float32),
            }
        )

    @staticmethod
    def _to_axis_angle(rot: np.ndarray) -> np.ndarray:
        import torch

        from smilify_tpu_torch.core.rotations import matrix_to_axis_angle, rotation_6d_to_axis_angle

        if rot.shape[-1] == 3 and (rot.ndim == 1 or rot.shape[-2:] != (3, 3)):
            return rot.astype(np.float32)
        t = torch.as_tensor(np.asarray(rot, np.float32))
        if rot.shape[-2:] == (3, 3):
            return matrix_to_axis_angle(t).numpy()
        if rot.shape[-1] == 6:
            return rotation_6d_to_axis_angle(t).numpy()
        raise ValueError(f"unrecognized rotation shape {rot.shape}")

    def export(self, out_path: str, extra_metadata: Optional[Dict] = None) -> str:
        """Write <out_path>.npz (AMASS layout) + <out_path>.json sidecar."""
        if not self.frames:
            raise ValueError("no frames recorded")
        N = len(self.frames)
        P = self.frames[0]["joint_rot"].reshape(-1).shape[0] // 3

        poses = np.zeros((N, 3 + P * 3), np.float32)
        trans = np.zeros((N, 3), np.float32)
        for i, fr in enumerate(self.frames):
            poses[i, :3] = fr["global_rot"].reshape(3)
            poses[i, 3:] = fr["joint_rot"].reshape(-1)
            trans[i] = fr["trans"].reshape(3)

        betas = self.frames[0]["betas"]
        payload = {
            "poses": poses,
            "trans": trans,
            "betas": betas if betas is not None else np.zeros(10, np.float32),
            "mocap_framerate": np.asarray(self.fps, np.float32),
            "gender": np.asarray("neutral"),
        }
        # Per-frame betas (reference sidecar schema: the Blender importer reads
        # `betas_per_frame` for per-frame shape keyframes when present,
        # SMIL_processing_addon.py:3502). Clip-averaged `betas` above stays the
        # AMASS-compatible static entry (frame 0 by convention).
        if all(f["betas"] is not None for f in self.frames):
            betas_pf = np.stack([f["betas"] for f in self.frames])
            if not np.allclose(betas_pf, betas_pf[0]):
                payload["betas_per_frame"] = betas_pf
        if self.frames[0]["log_beta_scales"] is not None:
            payload["log_beta_scales"] = np.stack([f["log_beta_scales"] for f in self.frames])
        if self.frames[0]["betas_trans"] is not None:
            payload["betas_trans"] = np.stack([f["betas_trans"] for f in self.frames])

        npz_path = out_path if out_path.endswith(".npz") else out_path + ".npz"
        np.savez(npz_path, **payload)

        sidecar = {
            "schema_version": SCHEMA_VERSION,
            "model_name": self.model_name,
            "num_frames": N,
            "num_pose_joints": P,
            "fps": self.fps,
            "rotation_format": "axis_angle",
            "exported": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        sidecar.update(extra_metadata or {})
        with open(os.path.splitext(npz_path)[0] + ".json", "w") as f:
            json.dump(sidecar, f, indent=2)
        return npz_path


def load_animation(npz_path: str):
    """Round-trip loader: returns dict with poses/trans/betas (+ sidecar)."""
    data = dict(np.load(npz_path, allow_pickle=True))
    sidecar_path = os.path.splitext(npz_path)[0] + ".json"
    sidecar = {}
    if os.path.exists(sidecar_path):
        with open(sidecar_path) as f:
            sidecar = json.load(f)
    return data, sidecar


class PredictionSmoother:
    """Temporal moving-average smoothing of per-frame parameter trajectories
    (reference run_multiview_inference.py PredictionSmoother:71-120)."""

    def __init__(self, window: int = 5):
        if window < 1 or window % 2 == 0:
            raise ValueError("window must be odd and >= 1")
        self.window = window

    def smooth(self, trajectory: np.ndarray) -> np.ndarray:
        """(N, ...) → same shape; centered moving average with edge clamping."""
        N = trajectory.shape[0]
        half = self.window // 2
        out = np.empty_like(trajectory)
        for i in range(N):
            lo, hi = max(0, i - half), min(N, i + half + 1)
            out[i] = trajectory[lo:hi].mean(axis=0)
        return out

    def smooth_rotations(self, rots_aa: np.ndarray) -> np.ndarray:
        """Rotation-aware trajectory smoothing: axis-angles → rotation
        matrices, chordal-L2 window mean, projection back onto SO(3) via SVD
        (the reference smooths rotations in rotation space instead of naively
        averaging axis-angle vectors, run_multiview_inference.py:71-120).

        Accepts (N, 3) or (N, P, 3); same shape out."""
        from scipy.spatial.transform import Rotation

        shape = rots_aa.shape
        aa = rots_aa.reshape(shape[0], -1, 3)          # (N, P, 3)
        N, P = aa.shape[:2]
        mats = Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(N, P, 3, 3)
        mean = self.smooth(mats)                       # windowed matrix mean
        u, _, vt = np.linalg.svd(mean)
        det = np.linalg.det(u @ vt)
        u[..., :, -1] *= np.sign(det)[..., None]       # keep det=+1
        proj = u @ vt
        out = Rotation.from_matrix(proj.reshape(-1, 3, 3)).as_rotvec()
        return out.reshape(shape).astype(rots_aa.dtype)

    # axis-angle parameter names smoothed in rotation space; 3×3-matrix
    # camera rotations are window-averaged then re-projected onto SO(3)
    ROTATION_KEYS = ("global_rot", "joint_rot")
    MATRIX_KEYS = ("cam_rot", "view_cam_rot")

    def smooth_params(self, params: Dict[str, np.ndarray], keys=None) -> Dict[str, np.ndarray]:
        keys = keys or list(params)
        out = {}
        for k, v in params.items():
            if k not in keys:
                out[k] = v
            elif k in self.ROTATION_KEYS:
                out[k] = self.smooth_rotations(v)
            elif k in self.MATRIX_KEYS:
                mean = self.smooth(v)
                u, _, vt = np.linalg.svd(mean)
                det = np.linalg.det(u @ vt)
                u[..., :, -1] *= np.sign(det)[..., None]
                out[k] = (u @ vt).astype(v.dtype)
            else:
                out[k] = self.smooth(v)
        return out
