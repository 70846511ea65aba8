"""Rotation representations (port of ``smilify_tpu/core/rotations.py``).

Axis-angle ↔ rotation matrix ↔ quaternion ↔ 6D (Zhou et al., pytorch3d's
row convention), with the robust 6D wrapper the regressors decode through,
Rodrigues with its ``eps`` bias and the intrinsic-ZYX euler → axis-angle
helper used for fitter initialization. Functions work on the trailing
dimensions and broadcast over leading ones. Where a branch guards a
singular point (zero angle, a degenerate 6D vector), the unsafe operand is
replaced as well as the result (a double ``torch.where``), so the branch not
taken leaks no NaN into the gradient.
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


def axis_angle_to_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Numerically clean Rodrigues with a Taylor fallback near zero angle
    (R ≈ I + skew(theta)); the double where keeps gradients finite at 0."""
    norm_sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = norm_sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    r = torch.where(small, torch.zeros_like(theta), theta / angle)
    angle = torch.where(small, torch.zeros_like(angle), angle)
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    outer = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    R = cos * eye + (1.0 - cos) * outer + sin * skew(r)
    return torch.where(small[..., None], eye + skew(theta), R)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → unit quaternion (..., 4) (w, x, y, z) with w ≥ 0: the
    best-conditioned of the four standard candidates, chosen without
    data-dependent control flow."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw0 = _sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = _sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = _sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = _sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)              # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_axis_angle(q: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., 4) (w, x, y, z) → axis-angle (..., 3); ≈ 2·xyz below ``eps``
    (the identity, which is the regressor heads' initial estimate)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm_sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = norm_sq < eps * eps
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    return torch.where(small, 2.0 * xyz, xyz / sin_half * angle)


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → axis-angle (..., 3) via the quaternion."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R), eps=eps)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → 6D: the first two ROWS flattened (pytorch3d convention)."""
    return R[..., :2, :].reshape(*R.shape[:-2], 6)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D → rotation matrix by Gram-Schmidt (pytorch3d convention)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), 1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.vector_norm(a2p, dim=-1, keepdim=True), 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_rotation_6d(aa: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(aa))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def robust_rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """NaN/Inf-guarded 6D → matrix: non-finite entries become 0 and a first
    column of norm < 1e-6 falls back to the identity."""
    d6 = torch.nan_to_num(d6, nan=0.0, posinf=0.0, neginf=0.0)
    norm1 = torch.linalg.vector_norm(d6[..., :3], dim=-1, keepdim=True)
    ident6 = torch.tensor([1.0, 0, 0, 0, 1.0, 0], dtype=d6.dtype, device=d6.device).expand_as(d6)
    return rotation_6d_to_matrix(torch.where(norm1 < 1e-6, ident6, d6))


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
