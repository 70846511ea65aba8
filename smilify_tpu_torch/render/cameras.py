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
