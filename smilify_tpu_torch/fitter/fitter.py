"""Optimization-based model fitter (port of ``smilify_tpu/fitter/fitter.py``).

One step: SMIL forward over all frames, joint projection, soft-silhouette
render (the CUDA raster kernels on the card), loss suite, temporal
smoothing, Adam update. Differences from the JAX package, same behavior:

  * the parameters are a :class:`FitParams` dataclass of tensors; during a
    stage they are leaf tensors owned by a ``torch.optim.Adam``;
  * the JAX package's single jitted step becomes an eager step (there is no
    compile); ``chunk`` keeps its meaning for the host: that many steps run
    back to back and their losses are read back once;
  * Adam(β1=0.5, β2=0.999, eps=1e-8) with two parameter groups — fov with
    its own lr of 1 — equals the JAX package's ``optax.scale_by_adam``
    followed by ×(−lr). A frozen parameter gets its gradient multiplied by
    0 (never set to None, which ``torch.optim.Adam`` would skip), so its
    moments still decay as optax's do; the optimizer is fresh for each stage;
  * losses keep the reference's quirks, including that the 2D-joint MSE
    divides by the total element count while invisible joints contribute 0.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.core.rotations import euler_zyx_to_axis_angle
from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.fitter.priors import (
    LimitPrior,
    PosePrior,
    ShapePrior,
    default_limit_prior,
    default_pose_prior,
    shape_prior_from_spec,
)
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS, StageWeights
from smilify_tpu_torch.render.cameras import FoVCamera, default_camera
from smilify_tpu_torch.render.rasterizer import soft_silhouette
from smilify_tpu_torch.utils import monitoring


@dataclass
class FitParams:
    """Optimizable per-sequence parameters."""

    global_rot: torch.Tensor        # (N, 3) axis-angle root rotation
    joint_rot: torch.Tensor         # (N, P, 3) per-joint axis-angle
    betas: torch.Tensor             # (B,) shared across the sequence
    trans: torch.Tensor             # (N, 3)
    fov: torch.Tensor               # (N,) degrees
    log_beta_scales: torch.Tensor   # (J, 3) shared per-joint log scales
    joint_trans: torch.Tensor       # (J, 3) shared per-joint translation offsets

    @staticmethod
    def fields() -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(FitParams))


class FitData(NamedTuple):
    """Target observations; silhouettes/joints use the (y, x) pixel convention."""

    rgb: Optional[np.ndarray]          # (N, H, W, 3) float in [0, 1] (host-side, viz only)
    sil: Optional[torch.Tensor]        # (N, H, W) float silhouettes
    joints: torch.Tensor               # (N, K, 2) (row, col) pixel targets
    visibility: torch.Tensor           # (N, K) {0, 1}


# the reference's head-on init: eul_to_axis([-π/2, 0, -π/2])
def _default_global_rotation() -> np.ndarray:
    return euler_zyx_to_axis_angle(np.array([-np.pi / 2, 0.0, -np.pi / 2]))


def init_params(spec: ModelSpec, n_frames: int, shape_prior: ShapePrior, fov: float = 60.0) -> FitParams:
    dev = spec.device
    g0 = torch.as_tensor(_default_global_rotation(), dtype=torch.float32).to(dev)
    return FitParams(
        global_rot=g0[None].repeat(n_frames, 1),
        joint_rot=torch.zeros((n_frames, spec.n_joints - 1, 3), device=dev),
        betas=shape_prior.mean_betas.clone(),
        trans=torch.zeros((n_frames, 3), device=dev),
        fov=torch.full((n_frames,), fov, dtype=torch.float32, device=dev),
        log_beta_scales=torch.zeros((spec.n_joints, 3), device=dev),
        joint_trans=torch.zeros((spec.n_joints, 3), device=dev),
    )


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> FitParams:
    """A :class:`FitParams` from one array per field — e.g. the JAX
    package's ``FitParams`` carried across as ``np.asarray`` of each leaf."""
    dev = resolve_device(device)
    return FitParams(**{
        k: torch.as_tensor(np.asarray(arrays[k]), dtype=torch.float32).to(dev)
        for k in FitParams.fields()
    })


def synthetic_poses(spec: ModelSpec, n_frames: int, seed: int = 42):
    """The perturbed ground-truth poses :func:`synthetic_fit_data` renders:
    (betas (N, B), theta (N, J, 3), trans (N, 3)) float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    J = spec.n_joints
    theta = np.zeros((n_frames, J, 3), np.float32)
    theta[:, 0] = _default_global_rotation() + rng.uniform(-0.15, 0.15, (n_frames, 3))
    theta[:, 1:] = rng.uniform(-0.06, 0.06, (n_frames, J - 1, 3))
    mean = spec.shape_mean_betas.detach().cpu().numpy()
    betas = mean[None] + 0.3 * rng.uniform(-0.5, 0.5, (n_frames, spec.n_betas)).astype(np.float32)
    trans = rng.uniform(-0.05, 0.05, (n_frames, 3)).astype(np.float32)
    return betas.astype(np.float32), theta, trans


def synthetic_fit_data(
    spec: ModelSpec,
    n_frames: int,
    image_size: Tuple[int, int],
    seed: int = 42,
    fov: float = 60.0,
    use_reference: bool = False,
) -> FitData:
    """Reachable ground-truth fit targets on the spec's device: perturbed
    poses of ``spec`` rendered to binary silhouettes plus projected (y, x)
    joints — the production fitting workload.

    Benchmarks must fit this, not random noise: a noise silhouette drags the
    mesh until it covers the whole image, where the raster's culling and
    saturation early-outs stop firing."""
    dev = spec.device
    betas, theta, trans = (torch.as_tensor(a).to(dev) for a in synthetic_poses(spec, n_frames, seed))
    cam = default_camera(fov=fov, device=dev)
    with torch.no_grad():
        out = smil_forward(spec, betas, theta)
        verts = out.verts + trans[:, None]
        proj = cam.project_points_yx(out.joints + trans[:, None], image_size)
        pv = cam.world_to_view(verts)
        ndc = cam.view_to_ndc(pv)
        vb = torch.cat([ndc[..., :2], pv[..., 2:3]], dim=-1)
        sil = soft_silhouette(vb, spec.faces, image_size, znear=cam.znear,
                              use_reference=use_reference)
    return FitData(
        rgb=None,
        sil=(sil > 0.5).to(torch.float32),
        joints=proj,
        visibility=torch.ones((n_frames, spec.n_joints), dtype=torch.float32, device=dev),
    )


def render_frame(
    spec: ModelSpec,
    camera: FoVCamera,
    verts: torch.Tensor,
    joints: torch.Tensor,
    image_size: Tuple[int, int],
    render_sil: bool = True,
    use_reference: bool = False,
):
    """Project joints to (y, x) pixels and optionally rasterize the silhouette."""
    proj_yx = camera.project_points_yx(joints, image_size)
    sil = None
    if render_sil:
        pts_view = camera.world_to_view(verts)
        ndc = camera.view_to_ndc(pts_view)
        verts_ndc = torch.cat([ndc[..., :2], pts_view[..., 2:3]], dim=-1)
        sil = soft_silhouette(verts_ndc, spec.faces, image_size, znear=camera.znear,
                              use_reference=use_reference)
    return sil, proj_yx


def _project_frames(camera: FoVCamera, fov, verts, joints3d, image_size):
    """Per-frame camera math for a batch: fov (N,), verts (N, V, 3), joints
    (N, K, 3) → NDC vertices with view depth (N, V, 3), (y, x) joints."""
    with monitoring.span("fit.project"):
        cam = camera.replace(fov=fov[:, None])
        proj_yx = cam.project_points_yx(joints3d, image_size)
        pts_view = cam.world_to_view(verts)
        ndc = cam.view_to_ndc(pts_view)
        return torch.cat([ndc[..., :2], pts_view[..., 2:3]], dim=-1), proj_yx


def loss_objs(
    weights: StageWeights,
    pose_prior: PosePrior,
    limit_prior: LimitPrior,
    shape_prior: ShapePrior,
    joint_rot: torch.Tensor,       # (N, P, 3)
    theta: torch.Tensor,           # (N, J, 3)
    betas: torch.Tensor,           # (N, B) broadcast per frame
    joints_r: torch.Tensor,        # (N, K, 2) projected (y, x) pixels
    target_joints: torch.Tensor,   # (N, K, 2)
    vis: torch.Tensor,             # (N, K) float
    sil_r: Optional[torch.Tensor],       # (N, H, W) rendered, or None
    target_sil: Optional[torch.Tensor],  # (N, H, W) target, or None
):
    """The per-sequence weighted loss terms; a term with weight 0 is absent."""
    objs = {}
    if weights.w_j2d != 0:
        # invisible joints contribute zero, but the mean divides by the full
        # element count (reference quirk)
        diff = (joints_r - target_joints) * vis[..., None]
        objs["joint"] = weights.w_j2d * torch.sum(diff**2) / diff.numel()

    if weights.w_limit != 0:
        objs["limit"] = weights.w_limit * limit_prior(joint_rot)

    if weights.w_pose != 0:
        objs["pose"] = weights.w_pose * torch.mean(pose_prior(theta))

    if weights.w_splay != 0:
        objs["splay"] = weights.w_splay * torch.sum(joint_rot[:, :, [0, 2]] ** 2)

    if weights.w_betas != 0:
        objs["betas"] = weights.w_betas * shape_prior(betas)

    if weights.w_reproj != 0 and sil_r is not None and target_sil is not None:
        objs["sil_reproj"] = weights.w_reproj * torch.mean(torch.abs(sil_r - target_sil))
    return objs


def _posed(spec, params: FitParams, allow_limb_scaling: bool):
    """SMIL forward of ``params`` for every frame → (verts, joints, theta, betas)."""
    with monitoring.span("fit.smil_forward"):
        N, J = params.global_rot.shape[0], spec.n_joints
        theta = torch.cat([params.global_rot[:, None, :], params.joint_rot], dim=1)
        log_scales = params.log_beta_scales.expand(N, J, 3) if allow_limb_scaling else None
        joint_trans = params.joint_trans.expand(N, J, 3)
        betas = params.betas.expand(N, params.betas.shape[0])
        out = smil_forward(spec, betas, theta, log_scales=log_scales, joint_trans=joint_trans)
        return (out.verts + params.trans[:, None, :], out.joints + params.trans[:, None, :],
                theta, betas)


def forward_losses(
    spec: ModelSpec,
    params: FitParams,
    data: FitData,
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
    """Full loss over all frames. Returns (total, dict of weighted components).

    ``approx_max_faces`` selects the work-list raster (z-nearest per-tile
    face cap); ``camera`` (default: :func:`default_camera` on the spec's
    device) supplies the extrinsics, each frame's fov comes from ``params``."""
    verts, joints3d, theta, betas = _posed(spec, params, allow_limb_scaling)
    if canonical_joints is not None:
        joints3d = joints3d[:, canonical_joints]
    camera = camera if camera is not None else default_camera(device=spec.device)

    render_sil = weights.w_reproj != 0 and data.sil is not None
    verts_ndc, joints_r = _project_frames(camera, params.fov, verts, joints3d, image_size)
    sil_r = None
    if render_sil:
        # one batched rasterizer call — frames ride the kernel grid
        sil_r = soft_silhouette(
            verts_ndc, spec.faces, image_size, znear=camera.znear,
            use_reference=use_reference, approx_max_faces=approx_max_faces,
        )

    vis = (visibility_override if visibility_override is not None else data.visibility)
    with monitoring.span("fit.losses"):
        objs = loss_objs(
            weights, pose_prior, limit_prior, shape_prior,
            params.joint_rot, theta, betas, joints_r, data.joints, vis.to(torch.float32),
            sil_r, data.sil if render_sil else None,
        )
        total = functools.reduce(lambda a, b: a + b, objs.values())
    return total, objs


def temporal_losses(params: FitParams, w_temp: float):
    """Consecutive-frame smoothing: per-pair MSE summed over the sequence,
    separately for joints / global rotation / trans."""

    def pair_sum(x):
        if x.shape[0] < 2:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        d = x[1:] - x[:-1]
        per_pair = torch.mean(d.reshape(d.shape[0], -1) ** 2, dim=1)
        return torch.sum(per_pair) * w_temp

    return pair_sum(params.joint_rot), pair_sum(params.global_rot), pair_sum(params.trans)


class SmalFitter:
    """Host-side driver of the optimization stages: Adam(β1=0.5) with a
    dedicated lr=1 group for ``fov``; stage 0 freezes pose/betas/scales and
    restricts visibility to the torso joints.

    ``device`` (default ``"cuda"``) is where the spec, targets and
    parameters live and the step runs; ``use_reference=True`` renders with
    the all-faces reference raster, ``approx_max_faces`` with the capped
    work-list raster (see :func:`~smilify_tpu_torch.render.rasterizer.soft_silhouette`).
    """

    _WEIGHT_FIELDS = ("w_j2d", "w_reproj", "w_betas", "w_pose", "w_limit", "w_splay", "w_temp")

    def __init__(
        self,
        spec: ModelSpec,
        data: FitData,
        image_size: Tuple[int, int],
        pose_prior: Optional[PosePrior] = None,
        limit_prior: Optional[LimitPrior] = None,
        shape_prior: Optional[ShapePrior] = None,
        canonical_joints: Optional[np.ndarray] = None,
        allow_limb_scaling: bool = True,
        use_reference: bool = False,
        approx_max_faces: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.spec = spec.to(self.device)
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device)

        self.data = FitData(
            rgb=data.rgb,
            sil=None if data.sil is None else f32(data.sil),
            joints=f32(data.joints),
            visibility=f32(data.visibility),
        )
        self.image_size = tuple(image_size)
        self.pose_prior = (pose_prior or default_pose_prior(self.spec)).to(self.device)
        self.limit_prior = (limit_prior or default_limit_prior(self.spec)).to(self.device)
        self.shape_prior = (shape_prior or shape_prior_from_spec(self.spec)).to(self.device)
        self.canonical_joints = (
            torch.as_tensor(np.asarray(canonical_joints), dtype=torch.int64).to(self.device)
            if canonical_joints is not None else None
        )
        self.allow_limb_scaling = allow_limb_scaling
        self.use_reference = use_reference
        self.approx_max_faces = approx_max_faces
        self.camera = default_camera(device=self.device)
        self._init_params_from_data(self.data)

        # stage-0 torso-only visibility; joints are the LAST axis, so this
        # also covers (S, N, K) batched data
        vis = self.data.visibility
        torso_vis = torch.zeros_like(vis)
        if self.spec.torso_joints:
            torso = list(self.spec.torso_joints)
            torso_vis[..., torso] = vis[..., torso]
        self._torso_visibility = torso_vis

    def _init_params_from_data(self, data: FitData):
        """Read the frame count off the targets and allocate the initial
        parameters (the batched corpus fitter overrides this: its leading
        axis is clips, not frames)."""
        self.n_frames = int(data.joints.shape[0])
        self.params = init_params(self.spec, self.n_frames, self.shape_prior)

    def _total_loss(self, params: FitParams, weights: StageWeights, visibility, data=None):
        """Full loss + component dict for one step over ``data`` (default:
        the fitter's own targets; overridden by the multi-sequence
        :class:`~smilify_tpu_torch.fitter.fitter_batch.BatchedFitter` and the
        sharded fitters)."""
        total, objs = forward_losses(
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
        with monitoring.span("fit.losses"):
            tj, tg, tt = temporal_losses(params, weights.w_temp)
        objs = dict(objs, temporal_joint=tj, temporal_global=tg, temporal_trans=tt)
        return total + tj + tg + tt, objs

    def _freeze_mask(self, freeze: dict) -> dict:
        """Gradient multiplier per field: 0 for frozen fields, else 1;
        ``joint_trans`` is frozen unless a stage unfreezes it."""
        defaults = {"joint_trans": True}
        return {name: 0.0 if freeze.get(name, defaults.get(name, False)) else 1.0
                for name in FitParams.fields()}

    def run_stage(self, stage_id: int, weights: StageWeights, callback=None,
                  chunk: int = 1):
        """Run one optimization stage. ``chunk`` steps run back to back
        (remainder steps singly) and their losses are read back once per
        chunk for ``callback(stage_id, it, loss, objs)``."""
        with monitoring.span("fit.stage"):
            freeze = {}
            if stage_id == 0:
                freeze = {
                    "joint_rot": True,
                    "betas": True,
                    "log_beta_scales": True,
                    "torso_only": True,
                }
            elif not self.allow_limb_scaling:
                freeze = {"log_beta_scales": True}

            # a non-positive weight switches its term off
            weights = weights._replace(**{
                f: (getattr(weights, f) if getattr(weights, f) > 0 else 0.0)
                for f in self._WEIGHT_FIELDS
            })
            mask = self._freeze_mask(freeze)
            visibility = (
                self._torso_visibility if freeze.get("torso_only", False) else self.data.visibility
            )
            chunk = max(1, min(int(chunk), weights.num_iters or 1))

            # fresh leaves and optimizer state per stage
            leaves = {k: getattr(self.params, k).detach().clone().requires_grad_(True)
                      for k in FitParams.fields()}
            params = FitParams(**leaves)
            opt = torch.optim.Adam(
                [{"params": [v for k, v in leaves.items() if k != "fov"], "lr": weights.lr},
                 {"params": [leaves["fov"]], "lr": 1.0}],
                betas=(0.5, 0.999), eps=1e-8,
            )

            def step():
                with monitoring.span("fit.step"):
                    opt.zero_grad(set_to_none=True)
                    total, objs = self._total_loss(params, weights, visibility, self.data)
                    with monitoring.span("fit.backward"):
                        total.backward()
                    with monitoring.span("fit.update"):
                        with torch.no_grad():
                            for leaf in leaves.values():
                                if leaf.grad is None:
                                    leaf.grad = torch.zeros_like(leaf)
                            self._reduce_grads(leaves)
                            for k, leaf in leaves.items():
                                if mask[k] != 1.0:
                                    leaf.grad.mul_(mask[k])
                        opt.step()
                    return total.detach(), {k: v.detach() for k, v in objs.items()}

            loss = None
            it = 0
            while it < weights.num_iters:
                n = chunk if weights.num_iters - it >= chunk else 1
                results = [step() for _ in range(n)]
                loss = results[-1][0]
                # callbacks see the end-of-chunk parameters, as the JAX fitter's do
                self.params = FitParams(**{k: v.detach() for k, v in leaves.items()})
                if callback is not None:
                    with monitoring.span("fit.readback"):
                        rows = self._readback(results)
                    for j, (loss_j, objs_j) in enumerate(rows):
                        callback(stage_id, it + j, loss_j, objs_j)
                it += n
            self.params = FitParams(**{k: v.detach() for k, v in leaves.items()})
            return self._stage_loss(loss)

    # --- hooks of the sharded fitters (fitter_frames.ShardedFitterMixin) ---

    def _reduce_grads(self, leaves: dict) -> None:
        """Combine the gradients of ``leaves`` across devices before the
        update: nothing to do on one device."""

    def _readback(self, results):
        """``[(loss, objs), ...]`` of a chunk's steps as the callback sees
        them: one step's device tensors as they are, several steps' read
        back to the host at once (ONE device→host read-back a chunk)."""
        if len(results) == 1:
            return results
        names = list(results[0][1])
        table = torch.stack([
            torch.stack([r[0]] + [r[1][k] for k in names]) for r in results
        ]).cpu().numpy()
        return [(row[0], dict(zip(names, row[1:]))) for row in table]

    def _stage_loss(self, loss):
        """The loss :meth:`run_stage` returns: the last step's."""
        return loss

    def fit(self, schedule=None, callback=None, chunk: int = 1):
        schedule = schedule if schedule is not None else OPT_WEIGHTS
        return [self.run_stage(stage_id, weights, callback=callback, chunk=chunk)
                for stage_id, weights in enumerate(schedule)]

    # --- inference/rendering helpers ---

    def forward_frames(self):
        """SMIL forward for all frames with the current parameters."""
        return posed_frames(self.spec, self.params, self.allow_limb_scaling)


@torch.no_grad()
def posed_frames(spec, params: FitParams, allow_limb_scaling: bool = True):
    """SMIL forward of every frame of ``params``: world (verts, joints)."""
    verts, joints, _, _ = _posed(spec, params, allow_limb_scaling)
    return verts, joints
