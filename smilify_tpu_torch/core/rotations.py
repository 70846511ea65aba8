"""Rotation representations (port of ``smilify_tpu/core/rotations.py``).

Only what the fitter path needs: Rodrigues with its ``eps`` bias and the
intrinsic-ZYX euler → axis-angle helper used for fitter initialization.
Functions work on the trailing dimensions and broadcast over leading ones.
"""

from __future__ import annotations

import numpy as np
import torch


def rodrigues(theta: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrix (..., 3, 3).

    The angle is the norm of ``theta + eps`` (a per-component bias that also
    makes the zero pose differentiable), and the axis is ``theta/angle``."""
    angle = torch.linalg.vector_norm(theta + eps, dim=-1, keepdim=True)  # (..., 1)
    r = theta / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    outer = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return cos * eye + (1.0 - cos) * outer + sin * skew(r)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _matrix_to_axis_angle_np(R: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(3, 3) rotation → axis-angle (3,), through the best-conditioned of the
    four quaternion candidates, in float32 like the JAX helper it mirrors."""
    R = np.asarray(R, np.float32)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    one, two, four = np.float32(1), np.float32(2), np.float32(4)

    def _sqrt(x):
        return np.sqrt(np.maximum(x, np.float32(1e-12)))

    qw0 = _sqrt(one + tr) / two
    qx1 = _sqrt(one + m00 - m11 - m22) / two
    qy2 = _sqrt(one - m00 + m11 - m22) / two
    qz3 = _sqrt(one - m00 - m11 + m22) / two
    cands = np.array([
        [qw0, (m21 - m12) / (four * qw0), (m02 - m20) / (four * qw0), (m10 - m01) / (four * qw0)],
        [(m21 - m12) / (four * qx1), qx1, (m01 + m10) / (four * qx1), (m02 + m20) / (four * qx1)],
        [(m02 - m20) / (four * qy2), (m01 + m10) / (four * qy2), qy2, (m12 + m21) / (four * qy2)],
        [(m10 - m01) / (four * qz3), (m02 + m20) / (four * qz3), (m12 + m21) / (four * qz3), qz3],
    ], np.float32)
    scores = np.array([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], np.float32)
    q = cands[int(np.argmax(scores))]
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    w = np.clip(q[0], -1.0, 1.0)
    xyz = q[1:]
    norm_sq = np.sum(xyz * xyz)
    if norm_sq < eps * eps:
        return (2.0 * xyz).astype(np.float32)
    sin_half = np.sqrt(norm_sq)
    angle = np.float32(2.0) * np.arctan2(sin_half, w)
    return (xyz / sin_half * angle).astype(np.float32)


def euler_zyx_to_axis_angle(euler_xyz) -> np.ndarray:
    """Intrinsic R = Rz(e[2]) @ Ry(e[1]) @ Rx(e[0]) converted to axis-angle.
    Host-side numpy (used for fitter init constants)."""
    ex, ey, ez = float(euler_xyz[0]), float(euler_xyz[1]), float(euler_xyz[2])

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return _matrix_to_axis_angle_np(rz(ez) @ ry(ey) @ rx(ex))
