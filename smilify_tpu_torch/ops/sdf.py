"""Spatial Diameter Function (SDF): ray-cast computation + distance loss
(port of ``smilify_tpu/ops/sdf.py``).

  * :func:`compute_sdf` — per-surface-point "diameter" by casting rays into the
    mesh within a hemisphere around −normal and taking the farthest hit within
    [0.001, 0.2]·bbox_diagonal (reference ``fitter_3d/SDF_tests.py:253-384``),
    vectorized Möller–Trumbore over (rays × faces) in chunks of points and of
    faces;
  * :func:`smooth_sdf` — kNN mean smoothing (``SDF_tests.py:387-416``);
  * :func:`assign_vertex_sdf` — inverse-distance-weighted kNN transfer to mesh
    vertices, min-max normalized (``SDF_tests.py:775-820``);
  * :func:`sdf_distance` — z-score-normalized, SDF-similarity-soft-weighted
    bidirectional KNN distance between point clouds
    (``fitter_3d/utils.py:973-1262``), the differentiable registration loss.

The random draws (sample uniforms, ray directions) come from a
``torch.Generator`` and are kept apart from the deterministic parts
(:func:`sdf_from_draws`, :func:`directions_in_hemisphere`), so that a caller
can feed any draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from smilify_tpu_torch.ops.knn import gather_neighbors, knn_points
from smilify_tpu_torch.ops.mesh_ops import points_from_uniforms, sample_uniforms


# ---------------------------------------------------------------------------
# ray casting
# ---------------------------------------------------------------------------


def ray_triangle_intersect(origins, directions, v0, v1, v2, eps: float = 1e-6):
    """Batched Möller–Trumbore: rays (R, 3) × triangles (F, 3) → (R, F)
    intersection distances with +inf where no hit."""
    e1 = v1 - v0  # (F, 3)
    e2 = v2 - v0
    h = torch.linalg.cross(directions[:, None, :].expand(-1, e2.shape[0], -1),
                           e2[None, :, :].expand(directions.shape[0], -1, -1))  # (R, F, 3)
    a = torch.sum(e1[None] * h, dim=-1)  # (R, F)
    f = 1.0 / torch.where(torch.abs(a) < eps, torch.full_like(a, float("inf")), a)
    s = origins[:, None, :] - v0[None]  # (R, F, 3)
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1[None, :, :].expand_as(s))
    v = f * torch.sum(directions[:, None, :] * q, dim=-1)
    t = f * torch.sum(e2[None] * q, dim=-1)
    hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


def directions_in_hemisphere(normals, d):
    """Gaussian draws ``d`` (B, R, 3) → unit directions in the hemisphere
    opposite each normal (B, 3) (reference generate_random_directions_batch,
    SDF_tests.py:225-251)."""
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    dots = torch.sum(d * (-normals[:, None, :]), dim=-1)
    return torch.where(dots[..., None] < 0, -d, d)


def hemisphere_directions(normals, num_rays: int,
                          generator: Optional[torch.Generator] = None):
    """Random unit directions (B, num_rays, 3) in the hemisphere opposite each
    normal, drawn from ``generator``."""
    d = torch.randn((normals.shape[0], num_rays, 3), generator=generator,
                    device=normals.device, dtype=normals.dtype)
    return directions_in_hemisphere(normals, d)


@torch.no_grad()
def sdf_from_draws(verts, faces, r, u, d, point_chunk: int = 64, face_chunk: int = 4096):
    """:func:`compute_sdf` at given draws: sample uniforms ``r`` (S,), ``u``
    (S, 2) and Gaussian ray draws ``d`` (S, R, 3). Returns (sample_points
    (S, 3), diameters (S,)). Rays are cast ``point_chunk`` points at a time
    against ``face_chunk`` faces at a time (the farthest hit is a max, so the
    chunking does not change it)."""
    faces = faces.long()
    bbox_diag = torch.linalg.norm(verts.max(dim=0).values - verts.min(dim=0).values)
    min_thr = bbox_diag * 0.001
    max_thr = bbox_diag * 0.2
    offset = bbox_diag * 1e-4

    sampled = points_from_uniforms(verts, faces, r, u, return_normals=True)
    pts, normals = sampled.points, sampled.normals
    dirs = directions_in_hemisphere(normals, d)      # (S, R, 3)
    origins = pts + normals * offset                 # offset along +normal as in the reference
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))

    S, R = dirs.shape[:2]
    diam = []
    for p in range(0, S, point_chunk):
        o = torch.repeat_interleave(origins[p:p + point_chunk], R, dim=0)
        dd = dirs[p:p + point_chunk].reshape(-1, 3)
        # farthest hit per ray, ignoring inf (no-hit)
        t_max = torch.full((o.shape[0],), float("-inf"), dtype=verts.dtype, device=verts.device)
        for f in range(0, faces.shape[0], face_chunk):
            t = ray_triangle_intersect(o, dd, v0[f:f + face_chunk], v1[f:f + face_chunk],
                                       v2[f:f + face_chunk])
            t_hit = torch.where(torch.isinf(t), torch.full_like(t, float("-inf")), t)
            t_max = torch.maximum(t_max, t_hit.max(dim=-1).values)
        valid = (t_max > min_thr) & (t_max < max_thr)
        t_max = t_max.reshape(-1, R)
        valid = valid.reshape(-1, R)
        count = torch.sum(valid, dim=1)
        mean_d = (torch.sum(torch.where(valid, t_max, torch.zeros_like(t_max)), dim=1)
                  / torch.clamp_min(count, 1))
        diam.append(torch.where(count > 0, mean_d, min_thr))
    return pts, torch.cat(diam)


def compute_sdf(verts, faces, generator: Optional[torch.Generator] = None,
                num_samples: int = 1000, num_rays: int = 30, point_chunk: int = 64,
                face_chunk: int = 4096):
    """Spatial diameter at sampled surface points, drawing from ``generator``.

    Returns (sample_points (N, 3), diameters (N,)). A ray's measurement is the
    farthest intersection; it is valid when inside (0.001, 0.2) ×
    bbox_diagonal; a point's diameter is the mean of its valid rays (min
    threshold when none) — reference semantics, vectorized.
    """
    r, u = sample_uniforms(num_samples, generator, verts.device)
    d = torch.randn((num_samples, num_rays, 3), generator=generator, device=verts.device,
                    dtype=verts.dtype)
    return sdf_from_draws(verts, faces, r, u, d, point_chunk, face_chunk)


def smooth_sdf(points, values, k: int = 100):
    """kNN mean smoothing of SDF values (SDF_tests.py:387-416)."""
    k = min(k, points.shape[0])
    res = knn_points(points, points, K=k)
    return torch.mean(values[res.idx], dim=-1)


def assign_vertex_sdf(verts, sample_points, diameters, k: int = 10):
    """IDW kNN transfer of diameters to vertices, min-max normalized to [0, 1]."""
    res = knn_points(verts, sample_points, K=k)
    w = 1.0 / (torch.sqrt(torch.clamp_min(res.dists, 0.0)) + 1e-6)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    v_sdf = torch.sum(diameters[res.idx] * w, dim=-1)
    lo, hi = v_sdf.min(), v_sdf.max()
    return torch.where(hi > lo, (v_sdf - lo) / (hi - lo), torch.zeros_like(v_sdf))


# ---------------------------------------------------------------------------
# SDF distance loss
# ---------------------------------------------------------------------------


def _zscore(v, eps: float = 1e-8):
    mean = v.mean(dim=-1, keepdim=True)
    return (v - mean) / torch.clamp_min(v.std(dim=-1, correction=0, keepdim=True), eps)


def _sdf_distance_single(x, y, x_sdf, y_sdf, k, temperature=0.1):
    res = knn_points(x, y, K=k)
    y_sdf_nn = gather_neighbors(y_sdf[..., None], res.idx)[..., 0]  # (..., P1, k)
    sdf_diffs = torch.abs(x_sdf[..., None] - y_sdf_nn)
    # soft-min over neighbors by SDF similarity (differentiable argmin)
    w = torch.softmax(-sdf_diffs / temperature, dim=-1)
    return torch.mean(torch.sum(w * res.dists, dim=-1), dim=-1)


def sdf_distance(x, y, x_sdf, y_sdf, k: int = 8, single_directional: bool = False,
                 normalize_sdf: bool = True):
    """SDF-weighted bidirectional point-cloud distance (utils.py:1127-1262).
    Single clouds: (P, 3) points and (P,) values; batched: (B, P, 3) and
    (B, P), one distance a cloud."""
    if normalize_sdf:
        x_sdf = _zscore(x_sdf)
        y_sdf = _zscore(y_sdf)
    fwd = _sdf_distance_single(x, y, x_sdf, y_sdf, k)
    if single_directional:
        return fwd
    return fwd + _sdf_distance_single(y, x, y_sdf, x_sdf, k)
