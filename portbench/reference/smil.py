"""The SMIL body model and the FoV camera in plain PyTorch.

The procedural mesh is the rule of SMILify-on-TPU's ``toy_model_spec``
(an elongated sphere of ``V_side``² vertices and 2(V_side−1)² faces skinned
to a chain of J joints, shape directions from a seed); at (55, 55, 5) it has
the width of SMILy_STICK (V=3025, F=5832, J=55, B=5).

The forward is SMIL's linear blend skinning as published (SMPL, Loper et
al. 2015, with SMAL/SMIL's per-joint log scales and translation offsets):
shape and pose blend shapes, joints regressed from the shaped template,
Rodrigues rotations, the kinematic chain walked joint by joint, skinning
with the rest-pose-relative transforms, keypoints regressed from the posed
vertices. The camera is PyTorch3D's FoV perspective camera
(``look_at_view_transform(dist=2.7)``) with its NDC and screen conventions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CAMERA_R = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))
CAMERA_T = (0.0, 0.0, 2.7)
ZNEAR, ZFAR = 0.001, 1000.0
UNREAL_Y_FLIP = (1.0, -1.0, 1.0)


def procedural_mesh(V_side: int, J: int, B: int, shape_seed) -> dict:
    """The mesh, joints, skinning and shape space as float64/int numpy arrays."""
    n = V_side
    u, w = np.meshgrid(np.linspace(0.15, np.pi - 0.15, n), np.linspace(0, 2 * np.pi, n))
    verts = 0.3 * np.stack([np.sin(u) * np.cos(w), np.sin(u) * np.sin(w), np.cos(u)],
                           -1).reshape(-1, 3)
    verts[:, 0] *= 2.0
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a, b = (i * n + j).reshape(-1), (i * n + j + 1).reshape(-1)
    c, d = ((i + 1) * n + j).reshape(-1), ((i + 1) * n + j + 1).reshape(-1)
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 1).reshape(-1, 3)
    joints = np.zeros((J, 3))
    joints[:, 0] = np.linspace(-0.5, 0.5, J)
    dist = np.linalg.norm(verts[:, None] - joints[None], axis=-1)
    weights = np.exp(-8.0 * dist)
    weights = weights / weights.sum(axis=1, keepdims=True)
    rng = np.random.default_rng(shape_seed)
    return {
        "v_template": verts, "faces": faces.astype(np.int64),
        "shapedirs": rng.standard_normal((B, 3 * verts.shape[0])) * 0.02,
        "posedirs": np.zeros((9 * (J - 1), 3 * verts.shape[0])),
        "J_regressor": weights / weights.sum(axis=0, keepdims=True),
        "weights": weights, "joints_rest": joints,
        "shape_mean_betas": np.zeros(B), "shape_cov": np.eye(B),
        "parents": np.asarray([0] + list(range(J - 1)), np.int64),
    }


def to_torch(mesh: dict, device) -> dict:
    """The mesh's float arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i" else torch.float32,
                               device=device) for k, v in mesh.items()}


def rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → (..., 3, 3), with SMPL's ``theta + 1e-8`` in the angle."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    k = theta / angle
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(k.shape + (3,))
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return c * eye + (1 - c) * k[..., :, None] * k[..., None, :] + s * K


def smil_forward(m: dict, betas, theta, trans=None, log_scales=None, joint_trans=None):
    """Posed vertices (N, V, 3) and keypoints (N, J, 3) of betas (N, B) and
    axis-angle theta (N, J, 3); ``trans`` (N, 3) moves both."""
    N, J = theta.shape[0], theta.shape[1]
    V = m["v_template"].shape[0]
    shaped = m["v_template"] + (betas @ m["shapedirs"][: betas.shape[1]]).reshape(N, V, 3)
    rest = torch.einsum("nvc,vj->njc", shaped, m["J_regressor"])
    R = rodrigues(theta)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    posed = shaped + ((R[:, 1:] - eye).reshape(N, -1) @ m["posedirs"]).reshape(N, V, 3)
    scale = torch.exp(log_scales) if log_scales is not None else torch.ones_like(rest)
    offset = (joint_trans * torch.tensor(UNREAL_Y_FLIP, device=R.device)
              if joint_trans is not None else torch.zeros_like(rest))
    parents = m["parents"].tolist()
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device).expand(N, 1, 4)
    world = []
    for j in range(J):
        if j == 0:
            rot, loc = R[:, 0], rest[:, 0]
        else:
            p = parents[j]
            # diag(1/s_parent) · R · diag(s_joint): the parent's scale cancelled
            rot = R[:, j] / scale[:, p, :, None] * scale[:, j, None, :]
            loc = rest[:, j] - rest[:, p] + offset[:, j]
        local = torch.cat([torch.cat([rot, loc[..., None]], -1), bottom], 1)
        world.append(local if j == 0 else world[parents[j]] @ local)
    G = torch.stack(world, 1)                                                  # (N, J, 4, 4)
    moved = G[..., :3, 3] - torch.einsum("njab,njb->nja", G[..., :3, :3], rest)
    A = torch.cat([G[..., :3, :3], moved[..., None]], -1)                      # (N, J, 3, 4)
    T = torch.einsum("vj,njab->nvab", m["weights"], A)
    verts = torch.einsum("nvab,nvb->nva", T[..., :3], posed) + T[..., 3]
    if trans is not None:
        verts = verts + trans[:, None]
    joints = torch.einsum("nvc,vj->njc", verts, m["J_regressor"])
    return verts, joints


def to_view(points, R=None, T=None):
    """World → camera view space, ``X @ R + T`` (row vectors)."""
    if R is None:
        R = torch.tensor(CAMERA_R, device=points.device)
        T = torch.tensor(CAMERA_T, device=points.device)
    return points @ R + T


def to_ndc(view, fov, eps=None):
    """View space → NDC (x, y) with fov in degrees broadcast over the points'
    leading axes; ``eps`` keeps |z| from 0."""
    tan_half = torch.tan(fov * (math.pi / 360.0))
    z = view[..., 2]
    if eps is not None:
        z = torch.sign(z) * torch.clamp_min(z.abs(), eps)
    return torch.stack([view[..., 0] / (tan_half * z), view[..., 1] / (tan_half * z)], -1)


def ndc_to_yx(ndc, H, W):
    """NDC (x, y) → (row, col) pixel coordinates, PyTorch3D's screen convention."""
    s = min(H, W) / 2.0
    return torch.stack([(H - 1) / 2.0 - s * ndc[..., 1], (W - 1) / 2.0 - s * ndc[..., 0]], -1)
