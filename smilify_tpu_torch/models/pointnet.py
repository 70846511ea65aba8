"""Point cloud → SMIL parameter regression, PointNet and PointNet++ (port of
``smilify_tpu/models/pointnet.py``).

Networks that regress SMIL pose and shape from sampled surface point clouds,
trained self-supervised on random SMIL configurations with parameter,
joint-position and chamfer losses.

  * PointNet: a per-point MLP (Linear + LayerNorm + ReLU) and a max pool;
  * PointNet++ (SSG/MSG): farthest-point sampling and radius grouping
    set-abstraction layers, the groups padded to a fixed size and masked.

Every function takes a batch ``(B, N, 3)`` of clouds, where the JAX package
maps its single-cloud functions over the batch with ``vmap``. The modules
carry the Flax names (``Dense_0``, ``LayerNorm_0``, ``encoder_batched/sa1``...),
so ``models/weight_port.py::state_dict_from_flax`` fills them from the JAX
package's parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.models.backbones import FLAX_LN_EPS, flax_init_
from smilify_tpu_torch.models.transformer_decoder import identity_init_for_group

# ---------------------------------------------------------------------------
# sampling and grouping
# ---------------------------------------------------------------------------


def farthest_point_sampling(pts: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, N, 3) → (B, n_samples) indices, each cloud starting at point 0
    and adding the point farthest from those taken (the first on ties)."""
    B, N, _ = pts.shape
    rows = torch.arange(B, device=pts.device)
    min_d = torch.full((B, N), float("inf"), dtype=pts.dtype, device=pts.device)
    last = torch.zeros(B, dtype=torch.long, device=pts.device)
    idx = [last]
    for _ in range(n_samples - 1):
        d = torch.sum((pts - pts[rows, last][:, None, :]) ** 2, dim=-1)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx.append(last)
    return torch.stack(idx, dim=1)


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, ...) → (B, ..., D)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(*flat.shape, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def radius_group(pts: torch.Tensor, centers: torch.Tensor, radius: float, k: int):
    """The up to ``k`` nearest points within ``radius`` of each center,
    nearest first (lower index first on ties): (grouped (B, C, k, 3)
    coordinates relative to the center, mask (B, C, k)); padded slots hold
    point 0 and mask 0."""
    d2 = (torch.sum(centers ** 2, -1, keepdim=True) + torch.sum(pts ** 2, -1)[:, None, :]
          - 2.0 * torch.matmul(centers, pts.transpose(-1, -2)))            # (B, C, N)
    key = torch.where(d2 <= radius * radius, d2, torch.full_like(d2, float("inf")))
    near, order = torch.sort(key, dim=-1, stable=True)
    mask = torch.isfinite(near[..., :k])
    idx = torch.where(mask, order[..., :k], torch.zeros_like(order[..., :k]))
    grouped = _gather_points(pts, idx) - centers[:, :, None, :]
    return grouped, mask.to(pts.dtype)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def _dense_norm_stack(module: nn.Module, dims: Sequence[int], start: int = 0) -> None:
    """``Dense_i`` / ``LayerNorm_i`` pairs (Flax's auto-names) from dims[0] through dims[1:]."""
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        setattr(module, f"Dense_{start + j}", nn.Linear(a, b))
        setattr(module, f"LayerNorm_{start + j}", nn.LayerNorm(b, eps=FLAX_LN_EPS))


def _run_stack(module: nn.Module, x: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    for j in range(start, start + n):
        x = F.relu(getattr(module, f"LayerNorm_{j}")(getattr(module, f"Dense_{j}")(x)))
    return x


class PointNetEncoder(nn.Module):
    """Classic PointNet: a shared per-point MLP and a global max pool."""

    def __init__(self, widths: Sequence[int] = (64, 128, 1024)):
        super().__init__()
        self.widths = tuple(widths)
        _dense_norm_stack(self, (3,) + self.widths)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:     # (B, N, 3) → (B, D)
        return _run_stack(self, pts, len(self.widths)).amax(dim=-2)


class SetAbstraction(nn.Module):
    """PointNet++ set abstraction: FPS centers and one radius group a radius,
    each through its own MLP, max-pooled over the group's valid points."""

    def __init__(self, n_centers: int, radii: Sequence[float], group_k: int,
                 widths: Sequence[int], in_feats: int = 0):
        super().__init__()
        self.n_centers, self.radii, self.group_k = n_centers, tuple(radii), group_k
        self.widths = tuple(widths)
        for r in range(len(self.radii)):
            _dense_norm_stack(self, (3 + in_feats,) + self.widths, start=r * len(self.widths))

    def forward(self, pts: torch.Tensor, feats: Optional[torch.Tensor] = None):
        centers = _gather_points(pts, farthest_point_sampling(pts, self.n_centers))
        near = None
        if feats is not None:
            d = torch.sum((pts[:, None, :, :] - centers[:, :, None, :]) ** 2, dim=-1)
            near = torch.argsort(d, dim=-1, stable=True)[..., : self.group_k]
        outs = []
        for r, radius in enumerate(self.radii):
            x, mask = radius_group(pts, centers, radius, self.group_k)
            if near is not None:
                x = torch.cat([x, _gather_points(feats, near)], dim=-1)
            x = _run_stack(self, x, len(self.widths), start=r * len(self.widths))
            x = torch.where(mask[..., None] > 0, x, torch.full_like(x, -math.inf)).amax(dim=2)
            outs.append(torch.where(torch.isfinite(x), x, torch.zeros_like(x)))
        return centers, torch.cat(outs, dim=-1)


class _Encoder(nn.Module):
    """The per-cloud encoder the JAX package maps over the batch
    (``encoder_batched``)."""

    def __init__(self, arch: str):
        super().__init__()
        self.arch = arch
        if arch == "pointnet2":
            self.sa1 = SetAbstraction(256, (0.1, 0.2), 16, (64, 64, 128))
            self.sa2 = SetAbstraction(64, (0.2, 0.4), 16, (128, 128, 256), in_feats=256)
            self.sa_out = nn.Linear(512 + 3, 512)
        else:
            self.encoder = PointNetEncoder()

    def forward(self, pts):
        if self.arch == "pointnet2":
            c1, f1 = self.sa1(pts)
            c2, f2 = self.sa2(c1, f1)
            return self.sa_out(torch.cat([f2, c2], dim=-1)).amax(dim=-2)
        return self.encoder(pts)


@dataclasses.dataclass(frozen=True)
class PointNetConfig:
    arch: str = "pointnet"      # 'pointnet' | 'pointnet2'
    n_pose: int = 54
    n_betas: int = 5
    n_joints: int = 55
    predict_scales: bool = True
    head_hidden: int = 512

    def group_dims(self):
        groups = [("global_rot", 6), ("joint_rot", self.n_pose * 6), ("betas", self.n_betas),
                  ("trans", 3)]
        if self.predict_scales:
            groups += [("scale_weights", self.n_betas), ("trans_weights", self.n_betas)]
        return tuple(groups)


class SMILPointNet(nn.Module):
    """Point clouds (B, N, 3) → SMIL parameter groups: the encoder, two
    (Linear + LayerNorm + ReLU) layers and one linear head a group, zero
    kernels and the identity pose as bias (Flax's initializers elsewhere)."""

    def __init__(self, config: PointNetConfig):
        super().__init__()
        cfg = self.config = config
        self.encoder_batched = _Encoder(cfg.arch)
        feat = 512 if cfg.arch == "pointnet2" else self.encoder_batched.encoder.widths[-1]
        _dense_norm_stack(self, (feat, cfg.head_hidden, cfg.head_hidden))
        for name, d in cfg.group_dims():
            setattr(self, f"head_{name}", nn.Linear(cfg.head_hidden, d))
        flax_init_(self)
        with torch.no_grad():
            for name, d in cfg.group_dims():
                head = getattr(self, f"head_{name}")
                head.weight.zero_()
                head.bias.copy_(torch.as_tensor(identity_init_for_group(name, d, cfg.n_pose)))

    def forward(self, clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        if clouds.ndim == 2:
            clouds = clouds[None]
        x = _run_stack(self, self.encoder_batched(clouds), 2)
        return {name: getattr(self, f"head_{name}")(x) for name, _ in self.config.group_dims()}


# ---------------------------------------------------------------------------
# self-supervised data and losses
# ---------------------------------------------------------------------------


def sample_smil_configs(spec: ModelSpec, n: int, generator: Optional[torch.Generator] = None,
                        pose_scale: float = 0.1, beta_scale: float = 0.5,
                        scale_weight_scale: float = 0.0) -> Dict[str, torch.Tensor]:
    """Random SMIL parameters for self-supervised training, drawn from
    ``generator`` on the spec's device; the trainer's curriculum grows the
    scales over the epochs."""
    dev = spec.v_template.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    params = {"global_rot": normal(n, 3) * 0.3, "joint_rot": normal(n, spec.n_joints - 1, 3) * pose_scale,
              "betas": normal(n, spec.n_betas) * beta_scale,
              "trans": torch.zeros((n, 3), device=dev)}
    if scale_weight_scale > 0 and spec.scaledirs is not None:
        params["scale_weights"] = normal(n, spec.n_betas) * scale_weight_scale
    return params


def clouds_from_params(spec: ModelSpec, params: Dict[str, torch.Tensor], n_points: int,
                       generator: Optional[torch.Generator] = None):
    """SMIL forward and area-weighted surface sampling → (clouds (n, P, 3),
    ground-truth joints (n, J, 3))."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.ops.mesh_ops import points_from_uniforms, sample_uniforms

    theta = torch.cat([params["global_rot"][:, None, :], params["joint_rot"]], dim=1)
    log_scales = None
    if "scale_weights" in params and spec.scaledirs is not None:
        log_scales = torch.einsum("nb,bjc->njc", params["scale_weights"], spec.scaledirs)
    out = smil_forward(spec, params["betas"], theta, trans=params["trans"], log_scales=log_scales)
    n = out.verts.shape[0]
    r, u = sample_uniforms(n_points, generator, out.verts.device, batch=(n,))
    return points_from_uniforms(out.verts, spec.faces, r, u), out.joints


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) symmetric chamfer distances: mean squared nearest-neighbor
    distance a → b plus b → a."""
    from smilify_tpu_torch.ops.knn import knn_points

    return (knn_points(a, b, K=1).dists.mean(dim=(-2, -1))
            + knn_points(b, a, K=1).dists.mean(dim=(-2, -1)))


def pointnet_loss(spec: ModelSpec, cfg: PointNetConfig, raw: Dict[str, torch.Tensor],
                  gt_params: Dict[str, torch.Tensor], gt_joints: torch.Tensor,
                  clouds: torch.Tensor, chamfer_points: int = 512,
                  generator: Optional[torch.Generator] = None,
                  weights: Optional[Dict[str, float]] = None):
    """Parameter MSE + joint-position + chamfer losses → (total, components).
    The chamfer term samples ``chamfer_points`` points of each predicted
    body from ``generator``: without one (the JAX loss without a key) it is
    left out."""
    from smilify_tpu_torch.core.rotations import axis_angle_to_rotation_6d
    from smilify_tpu_torch.models.regressor import RegressorConfig, decode_predictions, forward_model
    from smilify_tpu_torch.ops.mesh_ops import points_from_uniforms, sample_uniforms

    w = dict({"param": 1.0, "joint": 1.0, "chamfer": 0.5}, **(weights or {}))
    rcfg = RegressorConfig(n_pose=cfg.n_pose, n_betas=cfg.n_betas, n_joints=cfg.n_joints,
                           scale_trans_mode="separate" if cfg.predict_scales else "ignore")
    B = raw["global_rot"].shape[0]
    dev = raw["global_rot"].device
    body_raw = dict(raw)
    body_raw.setdefault("fov", torch.full((B, 1), 60.0, device=dev))
    body_raw.setdefault("cam_rot", torch.eye(3, device=dev).reshape(1, 9).repeat(B, 1))
    body_raw.setdefault("cam_trans", torch.tensor([[0.0, 0.0, 2.7]], device=dev).repeat(B, 1))
    preds = decode_predictions(rcfg, body_raw, spec)

    objs = {}
    gt6_g = axis_angle_to_rotation_6d(gt_params["global_rot"])
    gt6_j = axis_angle_to_rotation_6d(gt_params["joint_rot"]).reshape(B, -1)
    objs["param"] = w["param"] * (
        torch.mean((raw["global_rot"] - gt6_g) ** 2) + torch.mean((raw["joint_rot"] - gt6_j) ** 2)
        + torch.mean((raw["betas"] - gt_params["betas"]) ** 2)
        + torch.mean((raw["trans"] - gt_params["trans"]) ** 2))
    verts_pred, joints_pred = forward_model(spec, preds)
    objs["joint"] = w["joint"] * torch.mean((joints_pred - gt_joints) ** 2)
    if w["chamfer"] > 0 and generator is not None:
        r, u = sample_uniforms(chamfer_points, generator, dev, batch=(B,))
        pred_pts = points_from_uniforms(verts_pred, spec.faces, r, u)
        objs["chamfer"] = w["chamfer"] * torch.mean(chamfer(pred_pts, clouds[:, :chamfer_points]))
    return sum(objs.values()), objs
