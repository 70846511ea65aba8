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

The corpus over several ranks: :class:`ShardedBatchedFitter` cuts the
clips over a ``('clips',)`` mesh (nothing is shared, so only the reported
scalars are reduced); :class:`GridShardedFitter` cuts clips and frames over
a ``('clips', 'frames')`` mesh, with the frame axis handled as in
:mod:`~smilify_tpu_torch.fitter.fitter_frames`.
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
from smilify_tpu_torch.fitter.fitter_frames import (
    _FRAME_MEAN_TERMS,
    ShardedFitterMixin,
    _default_mesh,
    temporal_losses_halo,
)
from smilify_tpu_torch.fitter.priors import LimitPrior, PosePrior, ShapePrior
from smilify_tpu_torch.fitter.stages import StageWeights
from smilify_tpu_torch.render.cameras import FoVCamera, default_camera
from smilify_tpu_torch.render.rasterizer import soft_silhouette
from smilify_tpu_torch.train.multihost import axis_group, globalize, process_count
from smilify_tpu_torch.utils import monitoring


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

    with monitoring.span("fit.smil_forward"):
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


@torch.no_grad()
def posed_clips(spec: ModelSpec, params: FitParams, allow_limb_scaling: bool = True):
    """SMIL forward of every clip and frame of batched ``params``: world
    verts (S, N, V, 3) and joints (S, N, J, 3)."""
    S, N = params.global_rot.shape[:2]
    verts, joints, _, _ = _batched_smil_forward(spec, params, allow_limb_scaling)
    return verts.reshape(S, N, verts.shape[1], 3), joints.reshape(S, N, joints.shape[1], 3)


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
    with monitoring.span("fit.losses"):
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

    def _total_loss(self, params, weights: StageWeights, visibility, data=None):
        total, objs = forward_losses_many(
            self.spec, params, self.data if data is None else data, weights,
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
        with monitoring.span("fit.losses"):
            per_seq = [temporal_losses(sequence_params(params, s), weights.w_temp)
                       for s in range(self.n_seqs)]
            tj, tg, tt = (functools.reduce(lambda a, b: a + b, terms) for terms in zip(*per_seq))
        objs = dict(objs, temporal_joint=tj, temporal_global=tg, temporal_trans=tt)
        return total + tj + tg + tt, objs

    def forward_frames(self):
        """SMIL forward for every sequence and frame: (S, N, V, 3), (S, N, J, 3)."""
        return posed_clips(self.spec, self.params, self.allow_limb_scaling)

    def sequence_params(self, s: int) -> FitParams:
        """The s-th sequence's parameters as single-sequence parameters (for
        per-clip export and rendering through the single-sequence tooling)."""
        return sequence_params(self.params, s)


class GridShardedFitter(ShardedFitterMixin, BatchedFitter):
    """:class:`BatchedFitter` over a 2-D ``('clips', 'frames')`` mesh: a
    corpus of long clips cut along both axes, each rank holding an
    (S/Dc × N/Df) block of (clip, frame) space.

    Clips share nothing, so the ``clips`` axis needs no collective in the
    update. Along ``frames`` each clip's shared leaves (betas, scales, joint
    offsets) sum their gradients, the clip's frame-mean terms scale by 1/Df
    and the temporal pairs across a rank boundary take the halo, one
    exchange for every local clip. The reported scalars sum over both axes.
    Every rank is given the whole corpus and keeps its block; ``mesh``
    defaults to (every rank × 1)."""

    _MESH_AXES = ("clips", "frames")

    def __init__(self, spec, data: FitData, image_size, mesh=None, device="cuda", **kwargs):
        if mesh is None:
            mesh = _default_mesh((process_count(), 1)[:len(self._MESH_AXES)], self._MESH_AXES,
                                 device)
        if mesh is not None and tuple(mesh.mesh_dim_names) != self._MESH_AXES:
            raise ValueError(f"need a {self._MESH_AXES} mesh, got {mesh.mesh_dim_names}")
        self.mesh = mesh
        self._report_axes = self._MESH_AXES
        self._frames = (axis_group(mesh, "frames") if "frames" in self._MESH_AXES
                        else (None, 1, 0))
        S, N = int(data.joints.shape[0]), int(data.joints.shape[1])
        Dc, Df = axis_group(mesh, "clips")[1], self._frames[1]
        if S % Dc or N % Df:
            raise ValueError(
                f"corpus ({S} clips × {N} frames) not divisible by the ({Dc} × {Df}) mesh — "
                f"pad the corpus (cli/optimize_corpus.py --shard does this)")
        TILE = self._data_spec()
        local = globalize(data._replace(rgb=None), mesh,
                          FitData(rgb=None, sil=TILE, joints=TILE, visibility=TILE))
        super().__init__(spec, local._replace(rgb=data.rgb), image_size, device=device, **kwargs)
        self.n_local = (self.n_seqs, self.n_frames)
        self.n_seqs, self.n_frames = S, N

    def _data_spec(self):
        return ("clips", "frames")

    def _param_specs(self) -> FitParams:
        TILE, CLIP = self._data_spec(), ("clips",)
        return FitParams(global_rot=TILE, joint_rot=TILE, betas=CLIP, trans=TILE, fov=TILE,
                         log_beta_scales=CLIP, joint_trans=CLIP)

    def _total_loss(self, params, weights: StageWeights, visibility, data=None):
        """This rank's loss: its sum over both axes, and its gradients once
        the shared ones are summed along ``frames``, equal the unsharded
        batched fit's."""
        Df = self._frames[1]
        _, objs = forward_losses_many(
            self.spec, params, self.data if data is None else data, weights,
            self.pose_prior, self.limit_prior, self.shape_prior,
            self.image_size,
            visibility_override=visibility,
            canonical_joints=self.canonical_joints,
            allow_limb_scaling=self.allow_limb_scaling,
            use_reference=self.use_reference,
            approx_max_faces=self.approx_max_faces,
            camera=self.camera,
        )
        objs = {k: (v / Df if k in _FRAME_MEAN_TERMS else v) for k, v in objs.items()}
        with monitoring.span("fit.losses"):
            tj, tg, tt = temporal_losses_halo(params, weights.w_temp, *self._frames)
        objs = dict(objs, temporal_joint=tj, temporal_global=tg, temporal_trans=tt)
        return functools.reduce(lambda a, b: a + b, objs.values()), objs


class ShardedBatchedFitter(GridShardedFitter):
    """:class:`BatchedFitter` with the clips cut over a 1-D ``('clips',)``
    mesh: the corpus-scale path. Clips are independent, so the step has NO
    collective in the optimization: each rank fits its S/D clips (its raster
    runs the kernels on its own S/D·N frames) and only the reported scalars
    are summed over the ranks."""

    _MESH_AXES = ("clips",)

    def _data_spec(self):
        return ("clips",)
