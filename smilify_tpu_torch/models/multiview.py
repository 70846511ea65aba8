"""Multi-view image → SMIL regressor with cross-view fusion and camera heads
(port of ``smilify_tpu/models/multiview.py``).

  * the shared backbone runs over the flattened (B·V) view batch, in chunks
    of at most ``backbone_chunk_size`` images (the memory knob; the last
    chunk is zero-padded, as the JAX package pads it);
  * learned per-canonical-camera view embeddings are added to the pooled
    view features and to each view's tokens;
  * cross-view attention fuses the view features under a boolean view mask
    (a sample with every view masked attends uniformly, as Flax's masking
    does, and stays finite);
  * one camera head, shared over views and conditioned on the view
    embedding, predicts fov + 6D rotation + translation, optionally as
    deltas from ground-truth cameras;
  * the body head is the IEF transformer decoder over all views' tokens.

The loss adds per-view visibility-weighted 2D keypoints, world-space 3D
keypoints and the differentiable DLT triangulation-consistency term (ground
truth 2D keypoints triangulated through the predicted cameras against the
predicted 3D joints).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from smilify_tpu_torch.core.rotations import robust_rotation_6d_to_matrix
from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.models.backbones import BackboneFeatures, create_backbone, flax_init_
from smilify_tpu_torch.models.regressor import (
    DEFAULT_LOSS_WEIGHTS,
    RegressorConfig,
    _masked_mse,
    backbone_autocast,
    backbone_flax_name,
    batched_camera,
    decode_predictions,
    float32_region,
    forward_model,
    make_head,
)
from smilify_tpu_torch.models.transformer_decoder import MultiHeadDotProductAttention, _layer_norm
from smilify_tpu_torch.render.cameras import triangulate_dlt

MULTIVIEW_DEFAULT_LOSS_WEIGHTS = dict(
    DEFAULT_LOSS_WEIGHTS,
    keypoint_2d=1.0,
    keypoint_3d=1.0,
    triangulation_consistency=0.1,
)


@dataclasses.dataclass(frozen=True)
class MultiViewConfig(RegressorConfig):
    max_views: int = 4
    num_canonical_cameras: int = 18
    fusion_heads: int = 8
    fusion_layers: int = 2
    camera_delta_mode: bool = False  # predict deltas from a ground-truth camera
    # the backbone runs over at most this many views at once (None: all B·V)
    backbone_chunk_size: Optional[int] = None

    def body_group_dims(self):
        rot = 6 if self.rotation_representation == "6d" else 3
        groups = [
            ("global_rot", rot),
            ("joint_rot", self.n_pose * rot),
            ("betas", self.n_betas),
            ("trans", 3),
        ]
        if self.scale_trans_mode == "separate":
            if self.use_pca_scale_trans:
                groups += [("scale_weights", self.n_betas), ("trans_weights", self.n_betas)]
            else:
                groups += [
                    ("log_beta_scales", self.n_joints * 3),
                    ("betas_trans", self.n_joints * 3),
                ]
        return tuple(groups)


class CrossViewFusion(nn.Module):
    """Masked self-attention over view features: (B, V, D_in), (B, V) bool →
    (fused (B, V, dim), masked mean (B, dim))."""

    def __init__(self, in_dim: int, dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = nn.Linear(in_dim, dim)
        for i in range(num_layers):
            setattr(self, f"LayerNorm_{2 * i}", _layer_norm(dim))
            setattr(self, f"MultiHeadDotProductAttention_{i}", MultiHeadDotProductAttention(dim, num_heads))
            setattr(self, f"LayerNorm_{2 * i + 1}", _layer_norm(dim))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(dim, dim * 4))
            setattr(self, f"Dense_{2 * i + 2}", nn.Linear(dim * 4, dim))

    def forward(self, view_feats: torch.Tensor, view_mask: torch.Tensor):
        x = self.Dense_0(view_feats)
        attn_mask = view_mask[:, None, None, :]  # (B, 1, 1, V) key mask
        for i in range(self.num_layers):
            y = getattr(self, f"LayerNorm_{2 * i}")(x)
            x = x + getattr(self, f"MultiHeadDotProductAttention_{i}")(y, y, mask=attn_mask)
            y = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
            y = F.gelu(getattr(self, f"Dense_{2 * i + 1}")(y), approximate="tanh")
            x = x + getattr(self, f"Dense_{2 * i + 2}")(y)
        m = view_mask[..., None].to(x.dtype)
        pooled = torch.sum(x * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)
        return x, pooled


class CameraHead(nn.Module):
    """Per-view camera regression: fov + 6D rotation + translation, one MLP
    shared over views; the output layers start at zero."""

    def __init__(self, in_dim: int, hidden: int = 256, delta_mode: bool = False):
        super().__init__()
        self.delta_mode = delta_mode
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.LayerNorm_0 = _layer_norm(hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.LayerNorm_1 = _layer_norm(hidden)
        self.Dense_2 = nn.Linear(hidden, 1)
        self.Dense_3 = nn.Linear(hidden, 6)
        self.Dense_4 = nn.Linear(hidden, 3)
        flax_init_(self)
        for m in (self.Dense_2, self.Dense_3, self.Dense_4):
            nn.init.zeros_(m.weight)

    def forward(self, view_feats, cam_embed, init_fov=None, init_rot6d=None, init_trans=None):
        x = torch.cat([view_feats, cam_embed], dim=-1)
        x = F.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = F.relu(self.LayerNorm_1(self.Dense_1(x)))
        fov_raw = self.Dense_2(x)[..., 0]
        rot6d = self.Dense_3(x)
        trans = self.Dense_4(x)
        if self.delta_mode and init_fov is not None:
            return init_fov + fov_raw, init_rot6d + rot6d, init_trans + trans
        ident6 = torch.tensor([1.0, 0, 0, 0, 1.0, 0], dtype=x.dtype, device=x.device)
        dist = torch.tensor([0.0, 0.0, 2.7], dtype=x.dtype, device=x.device)
        return 60.0 + fov_raw, rot6d + ident6, trans + dist


def _backbone_chunks(backbone, flat: torch.Tensor, chunk: Optional[int]) -> BackboneFeatures:
    """The backbone over ``flat`` in chunks of ``chunk`` images, the last
    zero-padded to full size (as the JAX package pads it); the padding's
    outputs are dropped."""
    n = flat.shape[0]
    if not chunk or chunk >= n:
        return backbone(flat)
    pad = (-n) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,) + flat.shape[1:])])
    parts = [backbone(flat[i:i + chunk]) for i in range(0, flat.shape[0], chunk)]
    return BackboneFeatures(*(torch.cat(xs)[:n] if xs[0] is not None else None
                              for xs in zip(*parts)))


class MultiViewSMILRegressor(nn.Module):
    """images (B, V, H, W, 3) + view_mask (B, V) + camera ids (B, V) →
    (raw parameter groups, IEF history); raw adds cam_fov (B, V), cam_rot6d
    (B, V, 6) and cam_trans (B, V, 3)."""

    def __init__(self, config: MultiViewConfig, img_size: int = 224):
        super().__init__()
        cfg = self.config = config
        self.backbone, feat_dim = create_backbone(cfg.backbone, img_size=img_size)
        self.view_embeddings = nn.Embedding(cfg.num_canonical_cameras, feat_dim)
        nn.init.normal_(self.view_embeddings.weight, std=1.0 / feat_dim ** 0.5)
        self.cross_view_fusion = flax_init_(CrossViewFusion(
            feat_dim, cfg.decoder_dim, cfg.fusion_heads, cfg.fusion_layers))
        self.body_head = make_head(dataclasses.replace(cfg, head_type="transformer"),
                                   cfg.body_group_dims(), feat_dim, feat_dim)
        self.camera_head = CameraHead(2 * feat_dim + cfg.decoder_dim,
                                      delta_mode=cfg.camera_delta_mode)

    def forward(self, images, view_mask, camera_ids, gt_cameras: Optional[Dict] = None):
        cfg = self.config
        B, V = images.shape[:2]
        flat = images.reshape((B * V,) + images.shape[2:])
        with backbone_autocast(cfg, images.device):
            feats = _backbone_chunks(self.backbone, flat, cfg.backbone_chunk_size)
        with float32_region(images.device):
            pooled = feats.pooled.float().reshape(B, V, -1)
            T = feats.tokens.shape[1]
            tokens = feats.tokens.float().reshape(B, V, T, -1)

            view_embed = self.view_embeddings(
                torch.clamp(camera_ids.long(), 0, cfg.num_canonical_cameras - 1))
            pooled = pooled + view_embed
            tokens = tokens + view_embed[:, :, None, :]

            _, fused_pooled = self.cross_view_fusion(pooled, view_mask.bool())
            raw_body, history = self.body_head(tokens.reshape(B, V * T, -1))

            delta = cfg.camera_delta_mode and gt_cameras
            fov, rot6d, trans = self.camera_head(
                torch.cat([pooled, fused_pooled[:, None].expand(B, V, fused_pooled.shape[-1])], dim=-1),
                view_embed,
                gt_cameras.get("fov") if delta else None,
                gt_cameras.get("rot6d") if delta else None,
                gt_cameras.get("trans") if delta else None,
            )
        raw = dict(raw_body)
        raw["cam_fov"] = fov
        raw["cam_rot6d"] = rot6d
        raw["cam_trans"] = trans
        return raw, history

    def flax_names(self) -> Dict[str, str]:
        return {"backbone": backbone_flax_name(self.backbone),
                "view_embeddings": "view_embeddings", "cross_view_fusion": "cross_view_fusion",
                "body_head": "body_head", "camera_head": "camera_head"}


def decode_multiview_predictions(cfg: MultiViewConfig, raw, spec: Optional[ModelSpec] = None):
    """Body parameters through the single-view decode, plus each view's
    camera (view_fov, view_cam_rot, view_cam_trans)."""
    body_raw = {k: v for k, v in raw.items() if not k.startswith("cam_")}
    B = raw["global_rot"].shape[0]
    ref = raw["global_rot"]
    # placeholders for the single-view decode's camera groups
    body_raw.setdefault("fov", torch.full((B, 1), 60.0, dtype=ref.dtype, device=ref.device))
    body_raw.setdefault("cam_rot", torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype=ref.dtype,
                                                device=ref.device).expand(B, 9))
    body_raw.setdefault("cam_trans", torch.tensor([0.0, 0, 2.7], dtype=ref.dtype,
                                                  device=ref.device).expand(B, 3))
    preds = decode_predictions(cfg, body_raw, spec)
    preds["view_fov"] = raw["cam_fov"]
    preds["view_cam_rot"] = robust_rotation_6d_to_matrix(raw["cam_rot6d"])
    preds["view_cam_trans"] = raw["cam_trans"]
    return preds


def project_through_view_cameras(preds, points, image_size):
    """(B, K, 3) points through the (B, V) predicted cameras → normalized
    (B, V, K, 2) (y, x), clipped to ±10, NaN → 0."""
    H, W = image_size
    cam = batched_camera(preds["view_cam_rot"], preds["view_cam_trans"], preds["view_fov"])
    yx = cam.project_points_yx(points[:, None], (H, W), eps=1e-4)
    yx = yx / torch.tensor([H, W], dtype=yx.dtype, device=yx.device)
    return torch.nan_to_num(torch.clamp(yx, -10.0, 10.0))


def view_projection_matrices(preds):
    """(B, V, 4, 4) column-vector world → clip matrices of the predicted
    cameras (``FoVCamera.full_projection_matrix`` for each view)."""
    R, T, fov = preds["view_cam_rot"], preds["view_cam_trans"], preds["view_fov"]
    cam = batched_camera(R, T, fov)
    tan_half = torch.tan(fov * (torch.pi / 180.0) / 2.0)
    zn, zf = cam.znear, cam.zfar
    zero, one = torch.zeros_like(fov), torch.ones_like(fov)
    K = torch.stack([
        torch.stack([1.0 / (tan_half * cam.aspect_ratio), zero, zero, zero], -1),
        torch.stack([zero, 1.0 / tan_half, zero, zero], -1),
        torch.stack([zero, zero, zf / (zf - zn) * one, -(zf * zn) / (zf - zn) * one], -1),
        torch.stack([zero, zero, one, zero], -1),
    ], dim=-2)
    E = torch.cat([torch.cat([R.transpose(-1, -2), T[..., None]], dim=-1),
                   torch.stack([zero, zero, zero, one], -1)[..., None, :]], dim=-2)
    return torch.matmul(K, E)


def compute_multiview_batch_loss(
    spec: ModelSpec,
    cfg: MultiViewConfig,
    preds: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    view_mask: torch.Tensor,
    loss_weights: Optional[Dict[str, float]] = None,
    image_size: Tuple[int, int] = (224, 224),
    joint_importance: Optional[torch.Tensor] = None,
):
    """Multi-view loss → (total, dict of weighted components).

    ``targets`` may hold body-parameter targets (as single-view), per-view
    keypoints_2d (B, V, K, 2 normalized yx) and kp_visibility (B, V, K),
    keypoints_3d (B, K, 3 world) and ground-truth view cameras
    (view_fov/view_cam_rot/view_cam_trans). ``joint_importance``: optional
    (K,) weights on the 2D and 3D keypoint terms."""
    w = dict(MULTIVIEW_DEFAULT_LOSS_WEIGHTS, **(loss_weights or {}))
    objs: Dict[str, torch.Tensor] = {}

    for name in ("global_rot", "joint_rot", "betas", "trans", "log_beta_scales", "betas_trans"):
        if w.get(name, 0) > 0 and name in targets and name in preds:
            objs[name] = w[name] * _masked_mse(preds[name], targets[name])

    vm = view_mask.to(torch.float32)
    if w.get("fov", 0) > 0 and "view_fov" in targets:
        objs["fov"] = w["fov"] * _masked_mse(preds["view_fov"], targets["view_fov"], vm)
    if w.get("cam_rot", 0) > 0 and "view_cam_rot" in targets:
        objs["cam_rot"] = w["cam_rot"] * _masked_mse(
            preds["view_cam_rot"], targets["view_cam_rot"], vm[:, :, None, None])
    if w.get("cam_trans", 0) > 0 and "view_cam_trans" in targets:
        objs["cam_trans"] = w["cam_trans"] * _masked_mse(
            preds["view_cam_trans"], targets["view_cam_trans"], vm[:, :, None])

    needs_3d = (
        (w.get("keypoint_2d", 0) > 0 and "keypoints_2d" in targets)
        or (w.get("keypoint_3d", 0) > 0 and "keypoints_3d" in targets)
        or (w.get("triangulation_consistency", 0) > 0 and "keypoints_2d" in targets)
    )
    if needs_3d:
        _, joints3d = forward_model(spec, preds, use_ue_scaling=cfg.use_ue_scaling)

        if w.get("keypoint_2d", 0) > 0 and "keypoints_2d" in targets:
            kp_pred = project_through_view_cameras(preds, joints3d, image_size)
            vis = targets.get("kp_visibility")
            mask = vm[:, :, None, None]
            if vis is not None:
                mask = mask * vis[..., None]
            if joint_importance is not None:
                mask = mask * joint_importance[None, None, :, None]
            objs["keypoint_2d"] = w["keypoint_2d"] * _masked_mse(kp_pred, targets["keypoints_2d"], mask)

        if w.get("keypoint_3d", 0) > 0 and "keypoints_3d" in targets:
            mask3d = None
            if joint_importance is not None:
                mask3d = torch.broadcast_to(joint_importance[None, :, None], joints3d.shape)
            objs["keypoint_3d"] = w["keypoint_3d"] * _masked_mse(
                joints3d, targets["keypoints_3d"], mask3d)

        if w.get("triangulation_consistency", 0) > 0 and "keypoints_2d" in targets:
            P = view_projection_matrices(preds)                 # (B, V, 4, 4)
            H, W = image_size
            # normalized (y, x) → NDC (x, y): the screen transform inverted
            kp = targets["keypoints_2d"]
            s = min(H, W)
            ndc = torch.stack([(W - 1.0 - 2.0 * kp[..., 1] * W) / s,
                               (H - 1.0 - 2.0 * kp[..., 0] * H) / s], dim=-1)
            vis = targets.get("kp_visibility")
            mask3 = vm[:, :, None] * (vis if vis is not None else 1.0)
            tri = triangulate_dlt(ndc, P, mask3)                   # (B, J, 3)
            objs["triangulation_consistency"] = w["triangulation_consistency"] * _masked_mse(
                tri, joints3d)

    if w.get("joint_angle_regularization", 0) > 0:
        objs["joint_angle_regularization"] = w["joint_angle_regularization"] * torch.mean(
            preds["joint_rot"] ** 2)

    total = sum(objs.values()) if objs else torch.zeros(())
    return total, objs
