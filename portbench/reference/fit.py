"""The fitter's stage step in plain PyTorch, as SMILify's ``SMALFitter``
runs it for a sequence: all frames posed by the SMIL forward, the joints
projected, the silhouette rendered, the stage's weighted loss suite plus the
temporal smoothing terms, and Adam(β1 = 0.5, β2 = 0.999, eps 1e-8) at the
stage's lr on every parameter but the fov, which has lr 1. The per-joint
translation offsets stay frozen (their gradient times 0).

The start is the fitter's: the head-on root rotation (intrinsic ZYX euler
(−π/2, 0, −π/2)), zero pose, trans, log scales and offsets, the shape
prior's mean betas and a fov of 60° in every frame."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import raster, smil

LEAVES = ("global_rot", "joint_rot", "betas", "trans", "fov", "log_beta_scales", "joint_trans")
FROZEN = ("joint_trans",)
BETAS = (0.5, 0.999)
EPS = 1e-8
LIMIT = 0.01           # every non-root joint a ±0.01 rad ball joint


def head_on_rotation() -> np.ndarray:
    """Axis-angle of Rz(−π/2) · Ry(0) · Rx(−π/2)."""
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    Rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    R = Rz @ Rx
    angle = np.arccos((np.trace(R) - 1) / 2)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(angle))
    return axis * angle


def initial_state(m: dict, n_frames: int) -> dict:
    dev = m["v_template"].device
    J = m["parents"].shape[0]
    g0 = torch.as_tensor(head_on_rotation(), dtype=torch.float32, device=dev)
    return {
        "global_rot": g0.expand(n_frames, 3).clone(),
        "joint_rot": torch.zeros((n_frames, J - 1, 3), device=dev),
        "betas": m["shape_mean_betas"].clone(),
        "trans": torch.zeros((n_frames, 3), device=dev),
        "fov": torch.full((n_frames,), 60.0, device=dev),
        "log_beta_scales": torch.zeros((J, 3), device=dev),
        "joint_trans": torch.zeros((J, 3), device=dev),
    }


def shape_precision(m: dict) -> torch.Tensor:
    cov = m["shape_cov"].double().cpu().numpy()
    prec = np.linalg.cholesky(np.linalg.inv(cov + 1e-5 * np.eye(cov.shape[0])))
    return torch.as_tensor(prec, dtype=torch.float32, device=m["shape_cov"].device)


def frames(m, p, H, W):
    """Every frame of parameters ``p`` posed and seen: (joints as (row, col)
    (N, J, 2), vertices as NDC x, y and view depth (N, V, 3), theta, betas)."""
    N, J = p["global_rot"].shape[0], m["parents"].shape[0]
    theta = torch.cat([p["global_rot"][:, None], p["joint_rot"]], 1)
    betas = p["betas"].expand(N, -1)
    verts, joints = smil.smil_forward(m, betas, theta, trans=p["trans"],
                                      log_scales=p["log_beta_scales"].expand(N, J, 3),
                                      joint_trans=p["joint_trans"].expand(N, J, 3))
    fov = p["fov"][:, None]
    yx = smil.ndc_to_yx(smil.to_ndc(smil.to_view(joints), fov), H, W)
    view_v = smil.to_view(verts)
    return yx, torch.cat([smil.to_ndc(view_v, fov), view_v[..., 2:]], -1), theta, betas


def stage_loss(m, p, target, w, H, W, k_sub):
    """The stage's total loss of parameters ``p`` against ``target`` (sil
    (N, H, W), joints (N, J, 2) as (row, col), vis (N, J)); ``w`` is the
    stage's weights."""
    N, J = p["global_rot"].shape[0], m["parents"].shape[0]
    yx, verts_ndc, theta, betas = frames(m, p, H, W)
    jr = p["joint_rot"]
    diff = (yx - target["joints"]) * target["vis"][..., None]
    mask = torch.ones(3 * J, device=jr.device)
    mask[:3] = 0
    total = (w["w_j2d"] * (diff ** 2).sum() / diff.numel()
             + w["w_limit"] * (torch.clamp_min(jr - LIMIT, 0) + torch.clamp_min(-LIMIT - jr, 0)).mean()
             + w["w_pose"] * ((theta.reshape(N, -1) * mask) ** 2).mean()
             + w["w_splay"] * (jr[:, :, [0, 2]] ** 2).sum()
             + w["w_betas"] * (((betas - m["shape_mean_betas"]) @ shape_precision(m)) ** 2).mean())
    if w["w_reproj"] > 0:
        sil = raster.soft_silhouette(verts_ndc, m["faces"], H, W, k_sub)
        total = total + w["w_reproj"] * (sil - target["sil"]).abs().mean()
    for x in (jr, p["global_rot"], p["trans"]):
        d = (x[1:] - x[:-1]).reshape(N - 1, -1)
        total = total + w["w_temp"] * (d ** 2).mean(1).sum()
    return total


def run_steps(m, target, w, H, W, k_sub, n_steps=3, state=None):
    """``n_steps`` Adam steps from the fitter's start (or ``state``):
    (losses, the first gradient as Adam gets it by leaf, the parameters by
    leaf after the steps, the parameters by leaf before them)."""
    start = state if state is not None else initial_state(m, target["joints"].shape[0])
    p = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    sq = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t in range(1, n_steps + 1):
        loss = stage_loss(m, p, target, w, H, W, k_sub)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: (torch.zeros_like(p[k]) if gk is None or k in FROZEN else gk)
                 for k, gk in zip(LEAVES, grads)}
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            for k in LEAVES:
                lr = 1.0 if k == "fov" else w["lr"]
                mom[k] = BETAS[0] * mom[k] + (1 - BETAS[0]) * g[k]
                sq[k] = BETAS[1] * sq[k] + (1 - BETAS[1]) * g[k] ** 2
                mh = mom[k] / (1 - BETAS[0] ** t)
                vh = sq[k] / (1 - BETAS[1] ** t)
                p[k] -= lr * mh / (vh.sqrt() + EPS)
    return losses, first, {k: v.detach() for k, v in p.items()}, start
