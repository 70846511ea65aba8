"""Sequence-batched fitting: many independent clips in one optimization
(port of ``smilify_tpu/fitter/fitter_batch.py``, the single-device part).

S sequences of N frames each are stacked on a leading axis:

  * every ``FitParams`` field gains a leading (S,) axis, including the
    per-sequence shared ``betas`` / ``log_beta_scales`` / ``joint_trans``;
  * the SMIL forward and the raster see one flat (S·N) frame batch: the
    raster kernels take all S·N frames in one launch (one block per tile and
    frame);
  * every loss term keeps its per-sequence normalization and is summed over
    sequences (a loop over S of :func:`~smilify_tpu_torch.fitter.fitter.loss_objs`,
    where the JAX package vmaps it). No parameter is shared across sequences
    and Adam is elementwise, so the batched fit is S independent fits;
  * temporal smoothing pairs frames within each sequence only.

:class:`BatchedFitter` is used like ``SmalFitter`` with an extra leading
sequence axis on ``FitData`` (sil (S, N, H, W), joints (S, N, K, 2),
visibility (S, N, K)); the stage loop, freeze masks and ``chunk`` are
inherited unchanged.

Not ported yet: the sharded corpus fitters (``ShardedBatchedFitter``,
``GridShardedFitter``) and their frame-sharded base in ``fitter_frames``,
which need ``torch.distributed``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.fitter.fitter import (
    FitData,
    FitParams,
    SmalFitter,
    _project_frames,
    init_params,
    loss_objs,
    temporal_losses,
)
from smilify_tpu_torch.fitter.priors import LimitPrior, PosePrior, ShapePrior
from smilify_tpu_torch.fitter.stages import StageWeights
from smilify_tpu_torch.render.cameras import FoVCamera, default_camera
from smilify_tpu_torch.render.rasterizer import soft_silhouette


def init_params_many(spec: ModelSpec, n_seqs: int, n_frames: int,
                     shape_prior: ShapePrior, fov: float = 60.0) -> FitParams:
    """The reference init (head-on global rotation, mean betas) tiled to
    (n_seqs, ...): every field gains a leading sequence axis."""
    p = init_params(spec, n_frames, shape_prior, fov)
    return FitParams(**{k: getattr(p, k)[None].repeat(n_seqs, *([1] * getattr(p, k).ndim))
                        for k in FitParams.fields()})


def sequence_params(params: FitParams, s: int) -> FitParams:
    """Sequence ``s`` of batched parameters as single-sequence parameters."""
    return FitParams(**{k: getattr(params, k)[s] for k in FitParams.fields()})


def _batched_smil_forward(spec: ModelSpec, params: FitParams, allow_limb_scaling: bool):
    """SMIL forward over (S, N) as one flat frame batch: the per-sequence
    shared fields are broadcast per frame. Returns world verts and joints
    with the translation applied, flat (S·N, ...), theta (S, N, J, 3) and
    the per-frame betas (S, N, B)."""
    S, N = params.global_rot.shape[:2]
    J = spec.n_joints
    B = params.betas.shape[-1]

    def flat(x):
        return x.reshape((S * N,) + tuple(x.shape[2:]))

    theta = torch.cat([params.global_rot[:, :, None, :], params.joint_rot], dim=2)
    betas_bc = params.betas[:, None, :].expand(S, N, B)
    log_scales = (params.log_beta_scales[:, None].expand(S, N, J, 3)
                  if allow_limb_scaling else None)
    joint_trans = params.joint_trans[:, None].expand(S, N, J, 3)

    out = smil_forward(
        spec, flat(betas_bc), flat(theta),
        log_scales=None if log_scales is None else flat(log_scales),
        joint_trans=flat(joint_trans),
    )
    trans_f = flat(params.trans)
    return (out.verts + trans_f[:, None, :], out.joints + trans_f[:, None, :],
            theta, betas_bc)


def forward_losses_many(
    spec: ModelSpec,
    params: FitParams,             # fields lead with (S, ...): see init_params_many
    data: FitData,                 # sil (S, N, H, W) | None, joints (S, N, K, 2), vis (S, N, K)
    weights: StageWeights,
    pose_prior: PosePrior,
    limit_prior: LimitPrior,
    shape_prior: ShapePrior,
    image_size: Tuple[int, int],
    visibility_override: Optional[torch.Tensor] = None,
    canonical_joints: Optional[torch.Tensor] = None,
    allow_limb_scaling: bool = True,
    use_reference: bool = False,
    approx_max_faces: Optional[int] = None,
    camera: Optional[FoVCamera] = None,
):
    """Batched :func:`~smilify_tpu_torch.fitter.fitter.forward_losses`: S
    sequences forward as one flat (S·N) frame batch; the loss terms are
    normalized per sequence and summed over sequences. Returns (total, dict
    of weighted components)."""
    S, N = params.global_rot.shape[:2]
    verts, joints3d, theta, betas_bc = _batched_smil_forward(spec, params, allow_limb_scaling)
    if canonical_joints is not None:
        joints3d = joints3d[:, canonical_joints]
    camera = camera if camera is not None else default_camera(device=spec.device)
    verts_ndc, joints_r = _project_frames(camera, params.fov.reshape(S * N), verts, joints3d,
                                          image_size)

    render_sil = weights.w_reproj != 0 and data.sil is not None
    sil_r = None
    if render_sil:
        # one raster call: the S·N frames go to the kernels in one launch
        H, W = image_size
        sil_r = soft_silhouette(
            verts_ndc, spec.faces, image_size, znear=camera.znear,
            use_reference=use_reference, approx_max_faces=approx_max_faces,
        ).reshape(S, N, H, W)

    vis = (visibility_override if visibility_override is not None
           else data.visibility).to(torch.float32)
    joints_r = joints_r.reshape(S, N, joints_r.shape[-2], 2)
    per_seq = [
        loss_objs(weights, pose_prior, limit_prior, shape_prior,
                  params.joint_rot[s], theta[s], betas_bc[s], joints_r[s], data.joints[s],
                  vis[s], sil_r[s] if render_sil else None,
                  data.sil[s] if render_sil else None)
        for s in range(S)
    ]
    objs = {k: functools.reduce(lambda a, b: a + b, (o[k] for o in per_seq))
            for k in per_seq[0]}
    total = functools.reduce(lambda a, b: a + b, objs.values())
    return total, objs


class BatchedFitter(SmalFitter):
    """``SmalFitter`` over a leading sequence axis: one optimizer, S clips.
    The stage loop, freeze masks and ``chunk`` are inherited; only the
    parameter layout and the loss assembly change shape."""

    def _init_params_from_data(self, data: FitData):
        self.n_seqs, self.n_frames = int(data.joints.shape[0]), int(data.joints.shape[1])
        self.params = init_params_many(self.spec, self.n_seqs, self.n_frames, self.shape_prior)

    def _total_loss(self, params, weights: StageWeights, visibility):
        total, objs = forward_losses_many(
            self.spec, params, self.data, weights,
            self.pose_prior, self.limit_prior, self.shape_prior,
            self.image_size,
            visibility_override=visibility,
            canonical_joints=self.canonical_joints,
            allow_limb_scaling=self.allow_limb_scaling,
            use_reference=self.use_reference,
            approx_max_faces=self.approx_max_faces,
            camera=self.camera,
        )
        # frame pairs within each sequence only
        per_seq = [temporal_losses(sequence_params(params, s), weights.w_temp)
                   for s in range(self.n_seqs)]
        tj, tg, tt = (functools.reduce(lambda a, b: a + b, terms) for terms in zip(*per_seq))
        objs = dict(objs, temporal_joint=tj, temporal_global=tg, temporal_trans=tt)
        return total + tj + tg + tt, objs

    @torch.no_grad()
    def forward_frames(self):
        """SMIL forward for every sequence and frame: (S, N, V, 3), (S, N, J, 3)."""
        S, N, J = self.n_seqs, self.n_frames, self.spec.n_joints
        verts, joints, _, _ = _batched_smil_forward(self.spec, self.params,
                                                    self.allow_limb_scaling)
        return verts.reshape(S, N, verts.shape[1], 3), joints.reshape(S, N, J, 3)

    def sequence_params(self, s: int) -> FitParams:
        """The s-th sequence's parameters as single-sequence parameters (for
        per-clip export and rendering through the single-sequence tooling)."""
        return sequence_params(self.params, s)
