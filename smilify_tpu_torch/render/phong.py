"""Hard z-buffer rasterization + Phong shading for visualization (port of
``smilify_tpu/render/phong.py``).

The reference's hard Phong color renderer (``smal_fitter/p3d_renderer.py:54-70``:
faces_per_pixel=1, blur 0, one point light at (0, 0, 3), per-vertex constant
texture color). A visualization path with no gradient: plain PyTorch ops,
no kernel of its own.

Top-1 face selection is a streaming argmin over face chunks: for each pixel
the loop keeps (best_z, best_face, barycentrics). A chunk's intermediates are
(H, W, C) planes — 1 MiB per face of the chunk at 512² — so ``face_chunk``
bounds the peak memory: at the default 128 about 0.13 GiB a plane, ~1 GiB in
all. The result does not depend on the chunk: ties go to the lowest face id
either way. Shading is PyTorch3D-style Phong with ambient/diffuse/specular =
(0.5, 0.3, 0.2) white light defaults.
"""

from __future__ import annotations

import torch

from smilify_tpu_torch.render.rasterizer_ref import pixel_ndc_grid

MESH_COLOR = (0.0, 172.0 / 255.0, 223.0 / 255.0)  # reference config.MESH_COLOR
FACE_CHUNK = 128


def _barycentrics(px, py, tri):
    """Barycentric components of points (px, py) in triangles ``tri``
    (..., 3, ≥2), as a tuple of three arrays (the JAX version's arithmetic)."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    w0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / den
    w1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / den
    w2 = 1.0 - w0 - w1
    return w0, w1, w2


@torch.no_grad()
def rasterize_hard(verts_ndc, faces, image_size, face_chunk=FACE_CHUNK, znear=1e-3):
    """Top-1 rasterization.

    Args:
      verts_ndc: (V, 3) NDC xy + view-space z.
      faces: (F, 3) integer.
    Returns:
      pix_face: (H, W) int32 face id (−1 for background)
      bary: (H, W, 3) barycentric coordinates
      zbuf: (H, W) view z of the hit (inf for background)
    """
    H, W = image_size
    dev, dtype = verts_ndc.device, verts_ndc.dtype
    pix = pixel_ndc_grid(image_size, dtype, dev)
    px, py = pix[..., 0, None], pix[..., 1, None]
    faces = faces.long()

    zbuf = torch.full((H, W), float("inf"), dtype=dtype, device=dev)
    fid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((H, W, 3), dtype=dtype, device=dev)
    for start in range(0, faces.shape[0], face_chunk):
        idx = torch.arange(start, min(start + face_chunk, faces.shape[0]), device=dev)
        tri = verts_ndc[faces[idx]]                          # (C, 3, 3)
        w0, w1, w2 = _barycentrics(px, py, tri[None, None, :, :, :2])   # 3x (H, W, C)
        inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
        z = w0 * tri[:, 0, 2] + w1 * tri[:, 1, 2] + w2 * tri[:, 2, 2]
        hit = inside & (z > znear)
        z_masked = torch.where(hit, z, torch.full_like(z, float("inf")))
        best_c = torch.argmin(z_masked, dim=-1, keepdim=True)   # the first minimum
        best_z = z_masked.gather(-1, best_c)[..., 0]
        best_w = torch.stack([w.gather(-1, best_c)[..., 0] for w in (w0, w1, w2)], -1)
        best_c = best_c[..., 0]
        better = best_z < zbuf
        zbuf = torch.where(better, best_z, zbuf)
        fid = torch.where(better, idx[best_c].to(torch.int32), fid)
        bary = torch.where(better[..., None], best_w, bary)
    return fid, bary, zbuf


def _unit(x):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


@torch.no_grad()
def render_phong(
    verts_world,
    verts_view,
    verts_ndc,
    faces,
    image_size,
    color=MESH_COLOR,
    light_location=(0.0, 0.0, 3.0),
    ambient=0.5,
    diffuse=0.3,
    specular=0.2,
    shininess=64.0,
    background=(1.0, 1.0, 1.0),
    face_chunk=FACE_CHUNK,
):
    """Hard Phong render; returns an (H, W, 3) float image in [0, 1] on the
    vertices' device.

    Lighting is computed in view space with a point light (PyTorch3D
    PointLights defaults scaled by the reference's renderer setup).
    ``verts_world`` is unused, as in the JAX version.
    """
    faces = faces.long()
    fid, bary, _ = rasterize_hard(verts_ndc, faces, image_size, face_chunk)
    hit = fid >= 0
    fid_s = torch.clamp_min(fid, 0).long()

    tri_view = verts_view[faces[fid_s]]                      # (H, W, 3, 3)
    pos = torch.einsum("hwv,hwvc->hwc", bary, tri_view)

    # per-face normals in view space
    v0, v1, v2 = (verts_view[faces[:, k]] for k in range(3))
    n = _unit(torch.linalg.cross(v1 - v0, v2 - v0))[fid_s]
    # flip normals toward the camera (camera looks along +z; pixel→camera is −pos)
    view_dir = _unit(-pos)
    n = torch.where(torch.sum(n * view_dir, dim=-1, keepdim=True) < 0, -n, n)

    light = torch.as_tensor(light_location, dtype=pos.dtype, device=pos.device)
    l_dir = _unit(light - pos)

    diff = torch.clamp_min(torch.sum(n * l_dir, dim=-1), 0.0)
    h = _unit(l_dir + view_dir)
    spec = torch.clamp_min(torch.sum(n * h, dim=-1), 0.0) ** shininess

    base = torch.as_tensor(color, dtype=pos.dtype, device=pos.device)
    shade = (ambient + diffuse * diff[..., None]) * base + specular * spec[..., None]
    bg = torch.as_tensor(background, dtype=pos.dtype, device=pos.device)
    img = torch.where(hit[..., None], shade, bg)
    return torch.clamp(img, 0.0, 1.0)
