"""Pose / shape / joint-limit priors (port of ``smilify_tpu/fitter/priors.py``).

  * dynamic pose prior — identity-precision zero-mean Mahalanobis over all
    joint angles, root excluded;
  * dynamic joint-limit prior — ±0.01 "ball joint" ranges per non-root joint;
  * shape prior — Cholesky-precision Mahalanobis from the model's
    ``shape_cov`` / ``shape_mean_betas``.

Each prior is a small ``nn.Module`` whose tensors are buffers, so
``prior.to(device)`` moves it with the model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from smilify_tpu_torch.core.spec import ModelSpec


class PosePrior(nn.Module):
    """x (N, J, 3) axis-angle (root first) → (N, 3J) squared residuals."""

    def __init__(self, mean: torch.Tensor, precs: torch.Tensor, use_mask: torch.Tensor):
        super().__init__()
        self.register_buffer("mean", mean)          # (3J,)
        self.register_buffer("precs", precs)        # (3J, 3J)
        self.register_buffer("use_mask", use_mask)  # (3J,) float — 0 for the root entries

    def forward(self, theta: torch.Tensor) -> torch.Tensor:
        x = theta.reshape(theta.shape[0], -1) - self.mean
        return (torch.matmul(x, self.precs) * self.use_mask) ** 2


def default_pose_prior(spec: ModelSpec, dtype=torch.float32) -> PosePrior:
    """Identity-precision zero-mean prior over all joints, root excluded."""
    n = 3 * spec.n_joints
    mask = torch.ones(n, dtype=dtype, device=spec.device)
    mask[:3] = 0.0
    return PosePrior(
        mean=torch.zeros(n, dtype=dtype, device=spec.device),
        precs=torch.eye(n, dtype=dtype, device=spec.device),
        use_mask=mask,
    )


class LimitPrior(nn.Module):
    """Hinge penalty outside per-joint per-axis [min, max] ranges (root excluded)."""

    def __init__(self, min_limits: torch.Tensor, max_limits: torch.Tensor):
        super().__init__()
        self.register_buffer("min_limits", min_limits)  # (P, 3) — P = n_joints − 1
        self.register_buffer("max_limits", max_limits)  # (P, 3)

    def forward(self, joint_rot: torch.Tensor) -> torch.Tensor:
        """joint_rot (N, P, 3) → mean hinge violation (scalar)."""
        over = torch.clamp_min(joint_rot - self.max_limits, 0.0)
        under = torch.clamp_min(self.min_limits - joint_rot, 0.0)
        return torch.mean(over + under)


def default_limit_prior(spec: ModelSpec, ball_range: float = 0.01, dtype=torch.float32) -> LimitPrior:
    """All non-root joints treated as ±ball_range ball joints (SMIL default)."""
    P = spec.n_joints - 1
    return LimitPrior(
        min_limits=torch.full((P, 3), -ball_range, dtype=dtype, device=spec.device),
        max_limits=torch.full((P, 3), ball_range, dtype=dtype, device=spec.device),
    )


class ShapePrior(nn.Module):
    """Mahalanobis shape prior: mean(‖(β − μ) L‖²) with L = chol((Σ+εI)⁻¹)."""

    def __init__(self, mean_betas: torch.Tensor, precs: torch.Tensor):
        super().__init__()
        self.register_buffer("mean_betas", mean_betas)  # (B,)
        self.register_buffer("precs", precs)            # (B, B) Cholesky factor of the precision

    def forward(self, betas: torch.Tensor) -> torch.Tensor:
        res = torch.matmul(betas - self.mean_betas, self.precs)
        return torch.mean(res**2)


def shape_prior_from_spec(spec: ModelSpec, n_betas: Optional[int] = None, dtype=torch.float32) -> ShapePrior:
    n_b = n_betas or spec.n_betas
    cov = spec.shape_cov.detach().cpu().double().numpy()
    invcov = np.linalg.inv(cov + 1e-5 * np.eye(cov.shape[0]))
    prec = np.linalg.cholesky(invcov)[:n_b, :n_b]
    mean = spec.shape_mean_betas.detach().cpu().double().numpy()[:n_b]
    return ShapePrior(
        mean_betas=torch.as_tensor(mean, dtype=dtype).to(spec.device),
        precs=torch.as_tensor(prec, dtype=dtype).to(spec.device),
    )
