"""Perspective cameras with PyTorch3D-compatible conventions (port of
``smilify_tpu/render/cameras.py``).

* view space: +X left, +Y up, +Z into the screen; world→view is the row-vector
  transform ``X_view = X_world @ R + T``.
* NDC: square-image range [-1, 1] on both axes, +X left / +Y up; a point at
  view-space (x, y, z) maps to ``x_ndc = x / (aspect · tan(fov/2) · z)``,
  ``y_ndc = y / (tan(fov/2) · z)``.
* screen: ``x_screen = (W−1)/2 − (min(W,H)/2)·x_ndc``, pixel (0,0) = top-left
  center.
* the fitter consumes projected joints in (row=y, col=x) order.

``fov`` may carry leading axes that broadcast against the points' leading
axes (e.g. one fov per frame of shape (N, 1) for points (N, V, 3)): the
batched counterpart of the JAX package's vmap over cameras.

The geometry here (projection matrices, the OpenCV conversion, DLT
triangulation) is float32 with full-precision matmuls, as the JAX package's
``Precision.HIGHEST``: on the card, callers keep
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from smilify_tpu_torch._device import resolve_device

DEFAULT_ZNEAR = 0.001
DEFAULT_ZFAR = 1000.0

# look_at_view_transform(dist=2.7, elev=0, azim=0): camera at (0,0,2.7) looking
# at the origin with +Y up → R = diag(-1, 1, -1), T = (0, 0, 2.7).
DEFAULT_R = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))
DEFAULT_T = (0.0, 0.0, 2.7)


@dataclass(frozen=True)
class FoVCamera:
    """A FoV perspective camera."""

    R: torch.Tensor                   # (3, 3) world→view rotation (row-vector convention)
    T: torch.Tensor                   # (3,)   world→view translation
    fov: torch.Tensor                 # (...)  vertical field of view, degrees
    aspect_ratio: torch.Tensor        # ()     w/h pixel-aspect of the intrinsics
    znear: float = DEFAULT_ZNEAR
    zfar: float = DEFAULT_ZFAR

    def replace(self, **kw) -> "FoVCamera":
        return dataclasses.replace(self, **kw)

    def world_to_view(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) world → view."""
        return torch.matmul(points, self.R) + self.T

    def view_to_ndc(self, pts_view: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
        """(..., 3) view → NDC (x, y, z_depth)."""
        fov_rad = self.fov * (math.pi / 180.0)
        tan_half = torch.tan(fov_rad / 2.0)
        x, y, z = pts_view[..., 0], pts_view[..., 1], pts_view[..., 2]
        w = z
        if eps is not None:
            w = torch.sign(z) * torch.clamp_min(torch.abs(z), eps)
        sx = 1.0 / (tan_half * self.aspect_ratio)
        sy = 1.0 / tan_half
        zn, zf = self.znear, self.zfar
        x_ndc = sx * x / w
        y_ndc = sy * y / w
        z_ndc = (zf / (zf - zn)) - (zf * zn / (zf - zn)) / w
        return torch.stack([x_ndc, y_ndc, z_ndc], dim=-1)

    def transform_points_ndc(self, points: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
        return self.view_to_ndc(self.world_to_view(points), eps=eps)

    def transform_points_screen(
        self, points: torch.Tensor, image_size: Tuple[int, int], eps: Optional[float] = None
    ) -> torch.Tensor:
        """(..., 3) world → screen (x_px, y_px, z_depth); image_size = (H, W)."""
        ndc = self.transform_points_ndc(points, eps=eps)
        H, W = image_size
        s = min(W, H) / 2.0
        x = (W - 1.0) / 2.0 - s * ndc[..., 0]
        y = (H - 1.0) / 2.0 - s * ndc[..., 1]
        return torch.stack([x, y, ndc[..., 2]], dim=-1)

    def project_points_yx(
        self, points: torch.Tensor, image_size: Tuple[int, int], eps: Optional[float] = None
    ) -> torch.Tensor:
        """World points → (row, col) pixel coordinates — the fitter's keypoint
        convention (the reference renderer swaps to (y, x))."""
        scr = self.transform_points_screen(points, image_size, eps=eps)
        return scr[..., [1, 0]]

    def projection_matrix(self) -> torch.Tensor:
        """Column-vector 4×4 perspective matrix K with p_clip = K @ p_view."""
        tan_half = torch.tan(self.fov * (math.pi / 180.0) / 2.0)
        zn, zf = self.znear, self.zfar
        K = torch.zeros((4, 4), dtype=self.R.dtype, device=self.R.device)
        K[0, 0] = 1.0 / (tan_half * self.aspect_ratio)
        K[1, 1] = 1.0 / tan_half
        K[2, 2] = zf / (zf - zn)
        K[2, 3] = -(zf * zn) / (zf - zn)
        K[3, 2] = 1.0
        return K

    def full_projection_matrix(self) -> torch.Tensor:
        """Column-vector 4×4 world→clip matrix: P = K @ [Rᵀ | Tᵀ]."""
        E = torch.zeros((4, 4), dtype=self.R.dtype, device=self.R.device)
        E[:3, :3] = self.R.T
        E[:3, 3] = self.T
        E[3, 3] = 1.0
        return torch.matmul(self.projection_matrix(), E)

    def camera_center(self) -> torch.Tensor:
        """World-space camera position: −T @ Rᵀ."""
        return -torch.matmul(self.T, self.R.T)


def default_camera(fov=60.0, aspect_ratio: float = 1.0, dtype=torch.float32,
                   device="cuda") -> FoVCamera:
    """The reference renderer's initial camera; ``fov`` may be a float or a
    tensor of per-frame fovs (kept as given, so gradients reach it)."""
    dev = resolve_device(device)
    fov_t = fov if isinstance(fov, torch.Tensor) else torch.tensor(fov, dtype=dtype, device=dev)
    return FoVCamera(
        R=torch.tensor(DEFAULT_R, dtype=dtype, device=dev),
        T=torch.tensor(DEFAULT_T, dtype=dtype, device=dev),
        fov=fov_t,
        aspect_ratio=torch.tensor(aspect_ratio, dtype=dtype, device=dev),
    )


def camera_from_opencv(
    R_cv: torch.Tensor,
    t_cv: torch.Tensor,
    K_cv: torch.Tensor,
    image_size: Tuple[int, int],
    znear: float = DEFAULT_ZNEAR,
    zfar: float = DEFAULT_ZFAR,
) -> FoVCamera:
    """Convert an OpenCV-convention camera to :class:`FoVCamera`.

    OpenCV: x right, y down, z forward, column vectors (X_cam = R X_w + t).
    Ours/PyTorch3D: x left, y up, z forward, row vectors — a 180° rotation
    about z. The FoV is derived from fy (vertical); aspect_ratio absorbs
    fx≠fy. Differentiable wrt all three tensors.
    """
    H, W = image_size
    Rz180 = torch.diag(torch.tensor([-1.0, -1.0, 1.0], dtype=R_cv.dtype, device=R_cv.device))
    # column-vector view rotation in p3d axes, then transpose to row convention
    R_p3d = torch.matmul(Rz180, R_cv)
    t_p3d = torch.matmul(Rz180, t_cv)
    fx, fy = K_cv[0, 0], K_cv[1, 1]
    half_h = torch.tensor(H / 2.0, dtype=K_cv.dtype, device=K_cv.device)
    fov = 2.0 * torch.atan2(half_h, fy) * (180.0 / math.pi)
    # pixel-aspect (fy / fx) · (W / H), so that the x_ndc scaling matches fx
    aspect = (fy / fx) * (W / H)
    return FoVCamera(R=R_p3d.T, T=t_p3d, fov=fov, aspect_ratio=aspect, znear=znear, zfar=zfar)


def triangulate_dlt(
    points_2d_ndc: torch.Tensor,
    proj_matrices: torch.Tensor,
    view_mask: torch.Tensor,
    damping: float = 1e-4,
) -> torch.Tensor:
    """Differentiable DLT triangulation with Tikhonov-damped normal equations.

    For each joint, stack per-view rows ``x·P₄ − P₁`` and ``y·P₄ − P₂``
    (clip-space row form), solve the damped least-squares system and return
    world-space points. Gradients flow to both the 2D points and the camera
    matrices.

    Leading batch axes are solved in one call (the JAX package's
    ``jax.vmap`` of the same function).

    Args:
      points_2d_ndc: (..., V_views, K, 2) per-view NDC xy coordinates.
      proj_matrices: (..., V_views, 4, 4) column-vector world→clip matrices.
      view_mask: (..., V_views) or (..., V_views, K) boolean/float validity.
      damping: Tikhonov λ added to AᵀA.

    Returns:
      (..., K, 3) triangulated world points.
    """
    K_j = points_2d_ndc.shape[-2]
    if view_mask.ndim == points_2d_ndc.ndim - 2:
        view_mask = view_mask[..., None].expand(*view_mask.shape, K_j)
    w = view_mask.to(points_2d_ndc.dtype)                     # (..., V, K)

    P1 = proj_matrices[..., 0, :]                               # (..., V, 4)
    P2 = proj_matrices[..., 1, :]
    P4 = proj_matrices[..., 3, :]
    x = points_2d_ndc[..., 0]                                   # (..., V, K)
    y = points_2d_ndc[..., 1]

    rows_x = x[..., None] * P4[..., None, :] - P1[..., None, :]    # (..., V, K, 4)
    rows_y = y[..., None] * P4[..., None, :] - P2[..., None, :]
    A = torch.cat([rows_x * w[..., None], rows_y * w[..., None]], dim=-3)   # (..., 2V, K, 4)
    A = A.transpose(-3, -2)                                     # (..., K, 2V, 4)

    # homogeneous solve: split A = [M | b] with X_h = (X, 1)
    M = A[..., :3]
    b = -A[..., 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    AtA = torch.einsum("...kva,...kvb->...kab", M, M) + damping * eye
    Atb = torch.einsum("...kva,...kv->...ka", M, b)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]
