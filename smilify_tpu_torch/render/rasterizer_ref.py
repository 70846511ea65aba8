"""Plain-PyTorch all-faces soft-silhouette rasterizer — the differentiable
oracle (port of ``smilify_tpu/render/rasterizer_ref.py``).

Per pixel, with the signed squared NDC-xy distance d_f to face f (negative
inside) and σ = 1e-4:

    S = Σ_f softplus(−d_f / σ),   alpha = 1 − exp(−S),

the exact, order-independent log-space form of SoftRas's
``1 − ∏_f (1 − sigmoid(−d_f/σ))`` over every face. Differentiable by
autograd; face chunks are checkpointed so the (H, W, chunk) distance
intermediates are recomputed in the backward pass instead of stored.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

SIGMA = 1e-4  # reference BlendParams(sigma=1e-4)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) in the form ``max(x, 0) + log1p(e^−|x|)`` (no threshold
    switch, unlike ``torch.nn.functional.softplus``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def pixel_ndc_grid(image_size, dtype, device):
    """Pixel-center NDC coordinates; (H, W, 2) with [..., 0]=x_ndc, [..., 1]=y_ndc.

    PyTorch3D NDC: +X left, +Y up; pixel (0, 0) is top-left. The shorter side
    spans [-1, 1] and the longer side proportionally more."""
    H, W = image_size
    s = min(H, W)
    ys = (torch.arange(H, dtype=dtype, device=device) * 2.0 + 1.0 - H) / s
    xs = (torch.arange(W, dtype=dtype, device=device) * 2.0 + 1.0 - W) / s
    yg, xg = torch.meshgrid(-ys, -xs, indexing="ij")
    return torch.stack([xg, yg], dim=-1)


def _point_segment_sq(px, py, ax, ay, bx, by):
    """Squared distance from point to segment."""
    ex, ey = bx - ax, by - ay
    dx, dy = px - ax, py - ay
    # per-face reciprocal, as in the kernels
    seg_rinv = 1.0 / torch.clamp_min(ex * ex + ey * ey, 1e-12)
    t = torch.clamp((dx * ex + dy * ey) * seg_rinv, 0.0, 1.0)
    rx = dx - t * ex
    ry = dy - t * ey
    return rx * rx + ry * ry


def signed_distance_to_faces(pix, tri):
    """Signed squared distance between pixels (..., 2) and triangles
    (..., 3, 2) (broadcasting); negative inside."""
    px, py = pix[..., 0], pix[..., 1]
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]

    d_ab = _point_segment_sq(px, py, ax, ay, bx, by)
    d_bc = _point_segment_sq(px, py, bx, by, cx, cy)
    d_ca = _point_segment_sq(px, py, cx, cy, ax, ay)
    d = torch.minimum(torch.minimum(d_ab, d_bc), d_ca)

    # inside test via edge cross products (winding-agnostic)
    c0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    c1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    c2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    return torch.where(inside, -d, d)


def _chunk_S(pix, verts_ndc, f_idx, f_valid, sigma, znear):
    tri = verts_ndc[f_idx]                                   # (C, 3, 3)
    ok = f_valid & torch.any(tri[..., 2] > znear, dim=-1)
    d = signed_distance_to_faces(pix[:, :, None, :], tri[None, None, :, :, :2])  # (H, W, C)
    contrib = torch.where(ok, softplus(-d / sigma), torch.zeros_like(d))
    return contrib.sum(dim=-1)


def soft_silhouette_ref(
    verts_ndc: torch.Tensor,
    faces: torch.Tensor,
    image_size,
    sigma: float = SIGMA,
    face_chunk: int = 512,
    znear: float = 0.0,
) -> torch.Tensor:
    """Render a soft silhouette from NDC-space vertices.

    Args:
      verts_ndc: (V, 3) vertices in NDC (x, y) + view-space depth z.
      faces: (F, 3) int triangle indices.
      image_size: (H, W).
      sigma: blur parameter.
      face_chunk: faces processed per step (memory control).
      znear: faces whose every vertex has z <= znear are culled.

    Returns (H, W) alpha in [0, 1]. Differentiable wrt verts_ndc.
    """
    pix = pixel_ndc_grid(image_size, dtype=verts_ndc.dtype, device=verts_ndc.device)
    F = faces.shape[0]
    pad = (-F) % face_chunk
    faces_p = torch.nn.functional.pad(faces.long(), (0, 0, 0, pad))
    valid = torch.arange(F + pad, device=faces.device) < F
    S = torch.zeros(tuple(image_size), dtype=verts_ndc.dtype, device=verts_ndc.device)
    for lo in range(0, F + pad, face_chunk):
        S = S + checkpoint(
            _chunk_S, pix, verts_ndc, faces_p[lo:lo + face_chunk],
            valid[lo:lo + face_chunk], sigma, znear, use_reentrant=False,
        )
    return 1.0 - torch.exp(-S)
