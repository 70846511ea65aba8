"""Mesh losses and sampling of 3D registration (port of
``smilify_tpu/ops/mesh_ops.py``): chamfer_distance, mesh_edge_loss,
mesh_laplacian_smoothing (uniform), mesh_normal_consistency,
sample_points_from_meshes, compute_thinness_scores — the PyTorch3D ops the
reference's registration uses (``fitter_3d/trainer.py:3-9,371-435``), in
plain PyTorch.

Topology-derived index arrays (edges, adjacency) are computed on the host
once per mesh topology by the ``*_from_faces`` helpers (numpy, copied from
the JAX module) and passed in, as int tensors or as
:class:`~smilify_tpu_torch.ops.gather.RowIndex` tables with their inverse.
Every gather on a loss's backward path goes through ``ops/gather.py``, whose
backward adds in an order fixed by the indices: a registration is the same
from run to run on the card. Sampling is split in two: the draws
(:func:`sample_uniforms`, from a ``torch.Generator``) and the deterministic
:func:`points_from_uniforms`, so that a caller can feed it any uniforms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smilify_tpu_torch.ops.gather import RowIndex, gather_rows, take_rows
from smilify_tpu_torch.ops.knn import gather_neighbors, knn_points


# ---------------------------------------------------------------------------
# topology helpers (host, numpy)
# ---------------------------------------------------------------------------


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """(F, 3) → unique undirected edges (E, 2), sorted pairs."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def laplacian_neighbors_from_faces(faces: np.ndarray, n_verts: int, max_degree: int = 16):
    """Uniform-Laplacian neighbor table: (V, max_degree) int32 + (V,) degree."""
    nbrs = [[] for _ in range(n_verts)]
    for a, b in edges_from_faces(faces):
        nbrs[a].append(b)
        nbrs[b].append(a)
    deg = np.array([len(n) for n in nbrs], dtype=np.int32)
    md = int(max(max_degree, deg.max() if len(deg) else 1))
    table = np.zeros((n_verts, md), dtype=np.int32)
    for i, n in enumerate(nbrs):
        table[i, : len(n)] = n
    return table, deg


def face_adjacency_from_faces(faces: np.ndarray):
    """Pairs of faces sharing an edge, with their opposite vertices.

    Returns (P, 4) int32 rows [v_shared0, v_shared1, v_opp_a, v_opp_b] for the
    normal-consistency loss.
    """
    f = np.asarray(faces)
    edge_map = {}
    pairs = []
    for tri in f:
        for k in range(3):
            a, b = int(tri[k]), int(tri[(k + 1) % 3])
            opp = int(tri[(k + 2) % 3])
            key = (min(a, b), max(a, b))
            if key in edge_map:
                opp0 = edge_map[key][2]
                pairs.append([key[0], key[1], opp0, opp])
            else:
                edge_map[key] = (a, b, opp)
    if not pairs:
        return np.zeros((0, 4), dtype=np.int32)
    return np.asarray(pairs, dtype=np.int32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _masked_mean(d, mask):
    """Mean of ``d`` (..., N) over its last axis, over the ``mask``-ed entries."""
    if mask is None:
        return torch.mean(d, dim=-1)
    m = mask.to(d.dtype)
    return torch.sum(d * m, dim=-1) / torch.clamp_min(torch.sum(m, dim=-1), 1.0)


def chamfer_distance(x, y, x_mask=None, y_mask=None) -> torch.Tensor:
    """Symmetric mean squared chamfer distance between point sets.

    Matches pytorch3d.loss.chamfer_distance defaults (mean over points, sum of
    the two directions). Takes (N, 3)/(M, 3) or batched (B, N, 3) (masks
    (B, N) / (B, M)), whose per-cloud distances are averaged.
    """
    d_xy = knn_points(x, y, K=1, x_mask=x_mask, y_mask=y_mask).dists[..., 0]
    d_yx = knn_points(y, x, K=1, x_mask=y_mask, y_mask=x_mask).dists[..., 0]
    return torch.mean(_masked_mean(d_xy, x_mask) + _masked_mean(d_yx, y_mask))


def mesh_edge_loss(verts, edges, target_length: float = 0.0) -> torch.Tensor:
    """Mean squared deviation of edge lengths from target (pytorch3d semantics)."""
    ends = gather_rows(verts, edges)  # (..., E, 2, 3)
    lengths = torch.linalg.norm(ends[..., 0, :] - ends[..., 1, :], dim=-1)
    return torch.mean((lengths - target_length) ** 2)


def mesh_laplacian_smoothing(verts, nbr_table, degree) -> torch.Tensor:
    """Uniform Laplacian smoothing: mean ‖L·v‖ (pytorch3d method='uniform')."""
    nbrs = gather_rows(verts, nbr_table)  # (..., V, max_deg, 3)
    md = nbr_table.shape[-1]
    deg = degree.to(verts.dtype)
    mask = (torch.arange(md, device=verts.device)[None, :] < degree[:, None]).to(verts.dtype)
    mean_nbr = torch.sum(nbrs * mask[..., None], dim=-2) / torch.clamp_min(deg[:, None], 1.0)
    lap = mean_nbr - verts
    lap = torch.where(degree[:, None] > 0, lap, torch.zeros_like(lap))
    return torch.mean(torch.linalg.norm(lap, dim=-1))


def mesh_normal_consistency(verts, adjacency) -> torch.Tensor:
    """Mean (1 − cos) between normals of edge-adjacent faces (pytorch3d form).

    ``adjacency`` rows are [shared0, shared1, opp_a, opp_b] from
    :func:`face_adjacency_from_faces`.
    """
    if adjacency.shape[0] == 0:
        return torch.zeros((), dtype=verts.dtype, device=verts.device)
    s0, s1, oa, ob = gather_rows(verts, adjacency).unbind(-2)
    e = s1 - s0
    na = torch.linalg.cross(e, oa - s0)
    nb = torch.linalg.cross(ob - s0, e)  # opposite winding so aligned normals agree
    cos = torch.sum(na * nb, dim=-1) / torch.clamp_min(
        torch.linalg.norm(na, dim=-1) * torch.linalg.norm(nb, dim=-1), 1e-12
    )
    return torch.mean(1.0 - cos)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


class SampledPoints(NamedTuple):
    points: torch.Tensor    # (S, 3)
    normals: torch.Tensor   # (S, 3)
    face_idx: torch.Tensor  # (S,)


def sample_uniforms(num_samples: int, generator: Optional[torch.Generator] = None,
                    device="cpu", batch=()):
    """The draws of one :func:`sample_points_from_meshes` call: ``r``
    (*batch, S) for the face choice and ``u`` (*batch, S, 2) for the point in
    the face, uniform in [0, 1)."""
    r = torch.rand((*batch, num_samples), generator=generator, device=device)
    u = torch.rand((*batch, num_samples, 2), generator=generator, device=device)
    return r, u


def points_from_uniforms(verts, faces, r, u, return_normals: bool = False,
                         face_mask: Optional[torch.Tensor] = None):
    """Area-weighted surface points of the mesh (``verts`` (V, 3), ``faces``
    (F, 3)) at the uniforms ``r`` (S,) and ``u`` (S, 2); or of a batch of
    meshes: ``verts`` (B, V, 3), ``faces`` (F, 3) shared or (B, F, 3), ``r``
    (B, S), ``u`` (B, S, 2), ``face_mask`` (B, F). Shared faces may come as
    a :class:`~smilify_tpu_torch.ops.gather.RowIndex` of the (F, 3) faces.

    The face is chosen by inverse CDF (cumsum of the areas + searchsorted):
    face i owns the half-open interval [cdf[i-1], cdf[i]), so zero-area
    (padded, degenerate or ``face_mask``-ed) faces are never chosen.
    Differentiable wrt ``verts`` (the face choice is detached; barycentric
    interpolation carries gradients)."""
    if isinstance(faces, RowIndex):
        corners = gather_rows(verts, faces)                       # (..., F, 3, 3)
    else:
        faces = faces.long().expand(*verts.shape[:-2], *faces.shape[-2:])
        corners = take_rows(verts, faces.flatten(-2)).unflatten(-2, faces.shape[-2:])
    v0, v1, v2 = corners.unbind(-2)
    cross = torch.linalg.cross(v1 - v0, v2 - v0)
    areas = 0.5 * torch.linalg.norm(cross, dim=-1)
    if face_mask is not None:
        areas = areas * face_mask.to(areas.dtype)
    probs = areas / torch.clamp_min(areas.sum(-1, keepdim=True), 1e-12)

    cdf = torch.cumsum(probs.detach(), dim=-1)
    fidx = torch.searchsorted(cdf, (r * cdf[..., -1:]).contiguous(), right=True)
    fidx = torch.clamp(fidx, 0, faces.shape[-2] - 1)
    su = torch.sqrt(u[..., 0:1])
    w0 = 1.0 - su
    w1 = su * (1.0 - u[..., 1:2])
    w2 = su * u[..., 1:2]
    pts = w0 * take_rows(v0, fidx) + w1 * take_rows(v1, fidx) + w2 * take_rows(v2, fidx)
    if not return_normals:
        return pts
    n = cross / torch.clamp_min(torch.linalg.norm(cross, dim=-1, keepdim=True), 1e-12)
    return SampledPoints(points=pts, normals=take_rows(n, fidx), face_idx=fidx)


def sample_points_from_meshes(verts, faces, num_samples: int,
                              generator: Optional[torch.Generator] = None,
                              return_normals: bool = False,
                              face_mask: Optional[torch.Tensor] = None):
    """Area-weighted uniform surface sampling (pytorch3d
    ``sample_points_from_meshes`` semantics), drawing from ``generator``
    (on the vertices' device)."""
    r, u = sample_uniforms(num_samples, generator, verts.device)
    return points_from_uniforms(verts, faces, r, u, return_normals, face_mask)


def compute_thinness_scores(verts, faces, n_neighbors: int = 50) -> torch.Tensor:
    """Per-face 'thinness' score: normal-direction variation among the
    n_neighbors nearest face centers (reference
    ``fitter_3d/utils.py:361`` compute_thinness_scores).

    score_f = 1 − mean_k |n_f · n_k| over the K nearest neighbor faces.
    Takes (V, 3) or batched (B, V, 3) with shared faces.
    """
    faces = faces.long()
    v0, v1, v2 = (verts[..., faces[:, k], :] for k in range(3))
    centers = (v0 + v1 + v2) / 3.0
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)

    K = min(n_neighbors + 1, centers.shape[-2])   # +1: nearest neighbor is self
    nn_idx = knn_points(centers, centers, K=K).idx[..., 1:]   # drop self
    dots = torch.abs(torch.sum(gather_neighbors(n, nn_idx) * n[..., None, :], dim=-1))
    return 1.0 - torch.mean(dots, dim=-1)
