"""Single-view image → SMIL-parameter regressor and its loss engine (port of
``smilify_tpu/models/regressor.py``).

The network is a backbone and an MLP or IEF transformer head emitting named
parameter groups; the loss engine is a function of (ModelSpec, predictions,
targets) that reuses the fitter's differentiable projection (and, through
``render_silhouette_fn``, its raster).

Output groups: global_rot (6d|3), joint_rot (P×(6|3)), betas (B), trans (3),
fov (1), cam_rot (9, a flattened 3×3), cam_trans (3), and in
scale_trans_mode 'separate' either PCA weights (B each) or per-joint values
(J×3) for limb scales and translations; 'entangled_with_betas' folds them
into the betas through the model's scaledirs/transdirs.

Precision: ``RegressorConfig.compute_dtype`` is the backbone's; with
``torch.bfloat16`` the backbone runs under ``torch.autocast`` and the heads,
the decode, the SMIL forward and the projection stay in float32, as the JAX
package keeps them (its decode at ``Precision.HIGHEST``). Float32 runs on a
card need TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), which the entry points set.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.core.rotations import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    robust_rotation_6d_to_matrix,
)
from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.models.backbones import create_backbone, flax_init_
from smilify_tpu_torch.models.transformer_decoder import MLPHead, SMILTransformerDecoderHead
from smilify_tpu_torch.render.cameras import default_camera

DEFAULT_LOSS_WEIGHTS: Dict[str, float] = {
    "global_rot": 0.02,
    "joint_rot": 0.02,
    "betas": 0.01,
    "trans": 0.001,
    "fov": 0.001,
    "cam_rot": 0.01,
    "cam_trans": 0.001,
    "log_beta_scales": 0.1,
    "betas_trans": 0.1,
    "keypoint_2d": 0.0,
    "keypoint_3d": 0.0,
    "silhouette": 0.0,
    "joint_angle_regularization": 0.001,
    "limb_scale_regularization": 0.01,
    "limb_trans_regularization": 0.1,
}


@dataclasses.dataclass(frozen=True)
class RegressorConfig:
    backbone: str = "resnet50"
    head_type: str = "transformer"        # 'transformer' | 'mlp'
    rotation_representation: str = "6d"   # '6d' | 'axis_angle'
    n_pose: int = 54
    n_betas: int = 5
    n_joints: int = 55
    scale_trans_mode: str = "ignore"      # 'ignore' | 'separate' | 'entangled_with_betas'
    use_pca_scale_trans: bool = True      # 'separate' mode: PCA weights vs per-joint
    ief_iters: int = 3
    decoder_dim: int = 512
    decoder_depth: int = 4
    decoder_heads: int = 8
    decoder_mlp_dim: Optional[int] = None   # None → 4×dim
    mlp_hidden: int = 1024
    dropout: float = 0.1
    compute_dtype: Any = torch.bfloat16
    # per-joint translation outputs scaled down to ease optimization
    trans_scale_factor: float = 1.0
    # optional global mesh-scale output (about the root)
    allow_mesh_scaling: bool = False
    init_mesh_scale: float = 1.0
    use_log_mesh_scale: bool = True
    # replicAnt UE convention: ×10 about the root
    use_ue_scaling: bool = False

    def group_dims(self):
        rot = 6 if self.rotation_representation == "6d" else 3
        groups = [
            ("global_rot", rot),
            ("joint_rot", self.n_pose * rot),
            ("betas", self.n_betas),
            ("trans", 3),
            ("fov", 1),
            ("cam_rot", 9),
            ("cam_trans", 3),
        ]
        if self.scale_trans_mode == "separate":
            if self.use_pca_scale_trans:
                groups += [("scale_weights", self.n_betas), ("trans_weights", self.n_betas)]
            else:
                groups += [
                    ("log_beta_scales", self.n_joints * 3),
                    ("betas_trans", self.n_joints * 3),
                ]
        if self.allow_mesh_scaling:
            groups += [("mesh_scale", 1)]
        return tuple(groups)


def backbone_autocast(cfg, device: torch.device):
    """The backbone's precision context: ``torch.autocast`` to
    ``cfg.compute_dtype`` unless that is float32."""
    if cfg.compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=cfg.compute_dtype)


def float32_region(device: torch.device):
    """Autocast off: the heads and the geometry stay in float32 even inside
    a caller's autocast region."""
    return torch.autocast(device.type, enabled=False)


def make_head(cfg: RegressorConfig, group_dims, token_dim: int, feat_dim: int) -> nn.Module:
    if cfg.head_type == "transformer":
        head = SMILTransformerDecoderHead(
            group_dims, token_dim=token_dim, dim=cfg.decoder_dim, depth=cfg.decoder_depth,
            num_heads=cfg.decoder_heads, mlp_dim=cfg.decoder_mlp_dim, ief_iters=cfg.ief_iters,
            n_pose=cfg.n_pose)
    else:
        head = MLPHead(group_dims, in_dim=feat_dim, hidden=cfg.mlp_hidden, dropout=cfg.dropout,
                       n_pose=cfg.n_pose)
    # Flax's initializers on the hidden layers; the heads' own zero and
    # identity initializations stay
    keep = {n: (m.weight.detach().clone(), m.bias.detach().clone())
            for n, m in head.named_modules() if n.startswith("head_")}
    flax_init_(head)
    with torch.no_grad():
        for n, (w, b) in keep.items():
            head.get_submodule(n).weight.copy_(w)
            head.get_submodule(n).bias.copy_(b)
    return head


def backbone_flax_name(backbone: nn.Module) -> str:
    return f"{type(backbone).__name__}_0"


class SMILRegressor(nn.Module):
    """Backbone + head: images (B, H, W, 3) in [0, 1] → (raw parameter
    groups, IEF history). ``img_size`` is the resolution the model serves
    (it fixes a ViT's position embedding)."""

    def __init__(self, config: RegressorConfig, img_size: int = 224):
        super().__init__()
        self.config = config
        self.backbone, feat_dim = create_backbone(config.backbone, img_size=img_size)
        self.head = make_head(config, config.group_dims(), feat_dim, feat_dim)

    def forward(self, images: torch.Tensor):
        cfg = self.config
        with backbone_autocast(cfg, images.device):
            feats = self.backbone(images)
        with float32_region(images.device):
            if cfg.head_type == "transformer":
                return self.head(feats.tokens.float())
            return self.head(feats.pooled.float())

    def flax_names(self) -> Dict[str, str]:
        head = "SMILTransformerDecoderHead_0" if self.config.head_type == "transformer" else "MLPHead_0"
        return {"backbone": backbone_flax_name(self.backbone), "head": head}


# ---------------------------------------------------------------------------
# prediction decoding
# ---------------------------------------------------------------------------


def decode_predictions(cfg: RegressorConfig, raw: Dict[str, torch.Tensor],
                       spec: Optional[ModelSpec] = None):
    """Raw head outputs → physical parameters: axis-angle rotations, the
    camera rotation from the 9-vector's first six entries (robust 6D),
    per-joint scales and translations, fov, trans, betas and, with mesh
    scaling, the global scale."""
    B = raw["global_rot"].shape[0]
    if cfg.rotation_representation == "6d":
        global_rot = matrix_to_axis_angle(robust_rotation_6d_to_matrix(raw["global_rot"]))
        joint_rot = matrix_to_axis_angle(
            robust_rotation_6d_to_matrix(raw["joint_rot"].reshape(B, cfg.n_pose, 6)))
    else:
        global_rot = raw["global_rot"]
        joint_rot = raw["joint_rot"].reshape(B, cfg.n_pose, 3)

    out = {
        "global_rot": global_rot,
        "joint_rot": joint_rot,
        "betas": raw["betas"],
        "trans": raw["trans"],
        "fov": raw["fov"][:, 0],
        "cam_rot": robust_rotation_6d_to_matrix(raw["cam_rot"][:, :6]),
        "cam_trans": raw["cam_trans"],
    }

    J = cfg.n_joints
    if cfg.scale_trans_mode == "separate":
        if cfg.use_pca_scale_trans and spec is not None and spec.scaledirs is not None:
            out["log_beta_scales"] = torch.einsum("nb,bjc->njc", raw["scale_weights"], spec.scaledirs)
            out["betas_trans"] = torch.einsum("nb,bjc->njc", raw["trans_weights"], spec.transdirs)
            out["scale_weights"] = raw["scale_weights"]
            out["trans_weights"] = raw["trans_weights"]
        elif not cfg.use_pca_scale_trans:
            out["log_beta_scales"] = raw["log_beta_scales"].reshape(B, J, 3)
            out["betas_trans"] = raw["betas_trans"].reshape(B, J, 3)
    elif cfg.scale_trans_mode == "entangled_with_betas" and spec is not None \
            and spec.scaledirs is not None:
        out["log_beta_scales"] = torch.einsum("nb,bjc->njc", raw["betas"], spec.scaledirs)
        out["betas_trans"] = torch.einsum("nb,bjc->njc", raw["betas"], spec.transdirs)
    if "betas_trans" in out and cfg.trans_scale_factor != 1.0:
        out["betas_trans"] = out["betas_trans"] * cfg.trans_scale_factor
    if cfg.allow_mesh_scaling and "mesh_scale" in raw:
        ms = raw["mesh_scale"][:, 0]
        out["mesh_scale"] = (torch.exp(ms) * cfg.init_mesh_scale if cfg.use_log_mesh_scale
                             else ms + cfg.init_mesh_scale)
    return out


def forward_model(spec: ModelSpec, preds: Dict[str, torch.Tensor],
                  propagate_scaling: bool = False, use_ue_scaling: bool = False):
    """SMIL forward with predicted parameters → (verts, joints3d) in model
    space. ``use_ue_scaling`` applies the replicAnt ×10-about-root
    convention; a ``mesh_scale`` prediction scales about the root."""
    theta = torch.cat([preds["global_rot"][:, None, :], preds["joint_rot"]], dim=1)
    scaled = use_ue_scaling or "mesh_scale" in preds
    out = smil_forward(
        spec, preds["betas"], theta,
        trans=None if scaled else preds["trans"],
        log_scales=preds.get("log_beta_scales"),
        joint_trans=preds.get("betas_trans"),
        propagate_scaling=propagate_scaling,
    )
    if scaled:
        s = 10.0 if use_ue_scaling else preds["mesh_scale"][:, None, None]
        root = out.j_transformed[:, :1, :]
        trans = preds["trans"][:, None, :]
        return (out.verts - root) * s + trans, (out.joints - root) * s + trans
    joints = out.joints
    if spec.static_joint_locations:
        joints = joints + preds["trans"][:, None, :]
    return out.verts, joints


def batched_camera(R: torch.Tensor, T: torch.Tensor, fov: torch.Tensor):
    """A :class:`FoVCamera` over leading batch dims: R (..., 3, 3), T (..., 3)
    and fov (...) shaped to broadcast against points (..., K, 3)."""
    cam = default_camera(device=R.device)
    return cam.replace(R=R, T=T[..., None, :], fov=fov[..., None])


def project_to_camera(preds: Dict[str, torch.Tensor], points: torch.Tensor,
                      image_size: Tuple[int, int]):
    """(N, K, 3) model-space points through the predicted cameras →
    normalized [0, 1] (y, x) coordinates, clipped to ±10, NaN → 0."""
    H, W = image_size
    cam = batched_camera(preds["cam_rot"], preds["cam_trans"], preds["fov"])
    # eps guards points at the camera plane
    yx = cam.project_points_yx(points, (H, W), eps=1e-4)
    yx = yx / torch.tensor([H, W], dtype=yx.dtype, device=yx.device)
    return torch.nan_to_num(torch.clamp(yx, -10.0, 10.0))


# ---------------------------------------------------------------------------
# loss engine
# ---------------------------------------------------------------------------


def _masked_mse(pred, target, mask=None):
    d = (pred - target) ** 2
    if mask is None:
        return torch.mean(d)
    m = torch.broadcast_to(torch.as_tensor(mask, dtype=d.dtype, device=d.device), d.shape)
    return torch.sum(d * m) / torch.clamp_min(torch.sum(m), 1.0)


def compute_sample_validity(kp_visibility: Optional[torch.Tensor],
                            sil_target: Optional[torch.Tensor],
                            min_visible_kps: int = 5, min_mask_coverage: float = 0.05):
    """Per-sample validity: a sample contributes to the image-space losses
    only with ≥ 5 visible keypoints and ≥ 5% silhouette coverage."""
    valid = None
    if kp_visibility is not None:
        valid = torch.sum(kp_visibility > 0, dim=-1) >= min_visible_kps
    if sil_target is not None:
        cov_ok = torch.mean(sil_target, dim=(-2, -1)) >= min_mask_coverage
        valid = cov_ok if valid is None else (valid & cov_ok)
    return valid


def compute_batch_loss(
    spec: ModelSpec,
    cfg: RegressorConfig,
    preds: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    loss_weights: Optional[Dict[str, float]] = None,
    image_size: Tuple[int, int] = (224, 224),
    availability: Optional[Dict[str, torch.Tensor]] = None,
    joint_importance: Optional[torch.Tensor] = None,
    render_silhouette_fn=None,
):
    """Weighted multi-component loss → (total, dict of weighted components).

    ``preds`` are decoded predictions (:func:`decode_predictions`);
    ``targets`` any of global_rot (N,3), joint_rot (N,P,3), betas, trans,
    fov, cam_rot (N,3,3), cam_trans, log_beta_scales, betas_trans,
    keypoints_2d (N,K,2 normalized yx), kp_visibility (N,K), keypoints_3d
    (N,K,3), silhouette (N,H,W). ``availability``: per-sample {component:
    (N,) mask} for mixed datasets. ``joint_importance``: (K,) per-joint
    weights. ``render_silhouette_fn(verts (V, 3), camera) → (H, W)`` alpha
    for the silhouette BCE, called a sample at a time (the port's
    ``soft_silhouette`` reaches the raster kernels from here).
    """
    w = dict(DEFAULT_LOSS_WEIGHTS, **(loss_weights or {}))
    avail = availability or {}
    objs: Dict[str, torch.Tensor] = {}

    def amask(name):
        m = avail.get(name)
        return None if m is None else m[:, None]

    if w["global_rot"] > 0 and "global_rot" in targets:
        objs["global_rot"] = w["global_rot"] * _masked_mse(
            preds["global_rot"], targets["global_rot"], amask("pose"))
    if w["joint_rot"] > 0 and "joint_rot" in targets:
        m = avail.get("pose")
        vis = targets.get("kp_visibility")
        if vis is not None and vis.shape[-1] == preds["joint_rot"].shape[1] + 1:
            # visibility-weighted rotation loss: Frobenius distance between
            # rotation matrices, averaged over the visible non-root joints
            pm = axis_angle_to_matrix(preds["joint_rot"])
            tm = axis_angle_to_matrix(targets["joint_rot"])
            ss = torch.sum((pm - tm) ** 2, dim=(-2, -1))
            # double-where sqrt: exactly 0 at the target with a finite gradient
            pos = ss > 0
            per_joint = torch.where(pos, torch.sqrt(torch.where(pos, ss, torch.ones_like(ss))),
                                    torch.zeros_like(ss))
            jvis = vis[:, 1:].to(per_joint.dtype)
            if m is not None:
                jvis = jvis * m[:, None]
            objs["joint_rot"] = w["joint_rot"] * (
                torch.sum(per_joint * jvis) / torch.clamp_min(torch.sum(jvis), 1e-8))
        else:
            mask = None if m is None else m[:, None, None]
            objs["joint_rot"] = w["joint_rot"] * _masked_mse(
                preds["joint_rot"], targets["joint_rot"], mask)
    if w["betas"] > 0 and "betas" in targets:
        objs["betas"] = w["betas"] * _masked_mse(preds["betas"], targets["betas"], amask("betas"))
    if w["trans"] > 0 and "trans" in targets:
        objs["trans"] = w["trans"] * _masked_mse(preds["trans"], targets["trans"], amask("trans"))
    if w["fov"] > 0 and "fov" in targets:
        objs["fov"] = w["fov"] * _masked_mse(preds["fov"], targets["fov"], avail.get("camera"))
    if w["cam_rot"] > 0 and "cam_rot" in targets:
        m = avail.get("camera")
        mask = None if m is None else m[:, None, None]
        objs["cam_rot"] = w["cam_rot"] * _masked_mse(preds["cam_rot"], targets["cam_rot"], mask)
    if w["cam_trans"] > 0 and "cam_trans" in targets:
        objs["cam_trans"] = w["cam_trans"] * _masked_mse(
            preds["cam_trans"], targets["cam_trans"], amask("camera"))
    for name in ("log_beta_scales", "betas_trans"):
        if w[name] > 0 and name in targets and name in preds:
            m = avail.get("scale_trans")
            mask = None if m is None else m[:, None, None]
            objs[name] = w[name] * _masked_mse(preds[name], targets[name], mask)

    needs_geometry = (
        (w["keypoint_2d"] > 0 and "keypoints_2d" in targets)
        or (w["keypoint_3d"] > 0 and "keypoints_3d" in targets)
        or (w["silhouette"] > 0 and "silhouette" in targets and render_silhouette_fn is not None)
    )
    if needs_geometry:
        verts, joints3d = forward_model(spec, preds, use_ue_scaling=cfg.use_ue_scaling)
        kp_vis = targets.get("kp_visibility")
        validity = compute_sample_validity(kp_vis, targets.get("silhouette"))

        if w["keypoint_2d"] > 0 and "keypoints_2d" in targets:
            kp_pred = project_to_camera(preds, joints3d, image_size)
            vis = kp_vis if kp_vis is not None else torch.ones(kp_pred.shape[:2], device=kp_pred.device)
            mask = vis[..., None]
            if validity is not None:
                mask = mask * validity[:, None, None]
            if joint_importance is not None:
                mask = mask * joint_importance[None, :, None]
            objs["keypoint_2d"] = w["keypoint_2d"] * _masked_mse(kp_pred, targets["keypoints_2d"], mask)

        if w["keypoint_3d"] > 0 and "keypoints_3d" in targets:
            mask = None if kp_vis is None else kp_vis[..., None]
            objs["keypoint_3d"] = w["keypoint_3d"] * _masked_mse(
                joints3d, targets["keypoints_3d"], mask)

        if w["silhouette"] > 0 and "silhouette" in targets and render_silhouette_fn is not None:
            base = default_camera(device=verts.device)
            sil_pred = torch.stack([
                render_silhouette_fn(verts[i], base.replace(R=preds["cam_rot"][i],
                                                            T=preds["cam_trans"][i],
                                                            fov=preds["fov"][i]))
                for i in range(verts.shape[0])])
            sil_t = targets["silhouette"]
            eps = 1e-6
            bce = -(sil_t * torch.log(sil_pred + eps) + (1 - sil_t) * torch.log(1 - sil_pred + eps))
            if validity is not None:
                bce = bce * validity[:, None, None]
            objs["silhouette"] = w["silhouette"] * torch.mean(bce)

    if w["joint_angle_regularization"] > 0:
        objs["joint_angle_regularization"] = w["joint_angle_regularization"] * torch.mean(
            preds["joint_rot"] ** 2)
    if w["limb_scale_regularization"] > 0 and "log_beta_scales" in preds:
        objs["limb_scale_regularization"] = w["limb_scale_regularization"] * torch.mean(
            preds["log_beta_scales"] ** 2)
    if w["limb_trans_regularization"] > 0 and "betas_trans" in preds:
        objs["limb_trans_regularization"] = w["limb_trans_regularization"] * torch.mean(
            preds["betas_trans"] ** 2)

    total = sum(objs.values()) if objs else torch.zeros(())
    return total, objs
