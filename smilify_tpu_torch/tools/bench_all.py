"""The configs of ``tools/bench_all.py`` on the card (port).

    python -m smilify_tpu_torch.tools.bench_all [--only config3 ...] [--model PKL]
        [--target-obj OBJ] [--out build/bench_all.json] [--device cuda]

Configs:
  config1_smil_forward_stick                   SMIL forward at batch 1 and 64
  config2_fitter3d_atta                        one 3D-registration step against one
                                               target scan (``--target-obj``; runs only
                                               when that is given)
  config3_smalfitter_512                       fitter step, 1 frame, exact raster
  config3b_smalfitter_512_window10             fitter step, 10 frames, exact raster
  config3c_smalfitter_512_window10_worklist    10 frames, work-list raster capped at 800,
                                               plus the capped raster's IoU against exact
  config3d_smalfitter_512_window10_worklist700 10 frames, cap 700, plus IoU
  config4_singleview_resnet50                  single-view serving: ResNet-50 + IEF head
                                               (decoder 256 wide, 4 deep, 3 iterations) at
                                               224², batches 8 and 128; images_per_sec at 128
  config5a_multiview_4cam_stick                multi-view serving, 4 views at 224², B = 1
                                               and 8: model, decode, SMIL forward, the
                                               projection and the DLT re-triangulation
  config5b_multiview_18cam_mouse               the same at 18 views on the mouse-width spec
  config4b_singleview_train_step               single-view training step (forward, backward,
                                               Adam 1e-4): config 4's model in train mode,
                                               param MSEs + visibility-weighted 2D keypoints,
                                               B = 32 and 128
  config4c_singleview_train_step_gn            the same with the GroupNorm ResNet-50
  config5c_multiview_train_step                multi-view training step, 4 views at 224²,
                                               B = 2 and 8: the full multi-view loss with
                                               the DLT triangulation term

The fitter configs share one measurement of the card's FP32 FMA peak (K5,
``tools/peak.py``), the denominator of ``raster_work_bound_over_peak_pct``.
The regressor configs run their backbones under bf16 autocast (the JAX
benches' default compute dtype), everything after it in float32, on seeded
random weights; 5b's spec is ``toy_model_spec(106, 31, 3)``, the width of
the SMILy_Mouse model (J = 31, about 11,000 vertices). The train-step
configs add ``mfu``: 3 × the forward FLOPs of :func:`count_flops` a second
over 989 TFLOP/s (H100 SXM dense bf16), at their largest batch.
config2's target scan (the JAX bench's
is the Atta scan, which the repository does not hold) is ``--target-obj``:
without it the run skips config2, and ``--only config2`` is refused.

The model is ``--model``'s pickle or the STICK-width toy spec
(``smilify_tpu_torch.bench``). Timing: ``tools/_timing.timeit_chain``, the
step and its two modes as in ``smilify_tpu_torch.bench``. Results go to
``--out`` (default ``build/bench_all.json`` at the root of the checkout);
with ``--only`` they merge into that file. The report is printed as one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from smilify_tpu_torch._device import card_line, resolve_device, set_float32_matmul
from smilify_tpu_torch.bench import fit_step, load_spec, time_modes
from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.fitter.fitter import FitParams, synthetic_fit_data
from smilify_tpu_torch.fitter.fitter3d import (
    init_3d_params,
    pad_target_meshes,
    registration_losses,
    template_topology,
)
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
from smilify_tpu_torch.render import rasterizer as R
from smilify_tpu_torch.render import rasterizer_worklist as RW
from smilify_tpu_torch.render._kernels import BWD_OPS_PER_PAIR, FWD_OPS_PER_PAIR
from smilify_tpu_torch.render.cameras import default_camera
from smilify_tpu_torch.render.rasterizer import soft_silhouette
from smilify_tpu_torch.tools._timing import timeit_chain
from smilify_tpu_torch.tools.peak import SHAPE, flops, fma_peak
from smilify_tpu_torch.utils import monitoring
from smilify_tpu_torch.utils.export import load_obj
from smilify_tpu_torch.utils.visualization import silhouette_iou

CONFIGS = (
    "config1_smil_forward_stick",
    "config2_fitter3d_atta",
    "config3_smalfitter_512",
    "config3b_smalfitter_512_window10",
    "config3c_smalfitter_512_window10_worklist",
    "config3d_smalfitter_512_window10_worklist700",
    "config4_singleview_resnet50",
    "config5a_multiview_4cam_stick",
    "config5b_multiview_18cam_mouse",
    "config4b_singleview_train_step",
    "config4c_singleview_train_step_gn",
    "config5c_multiview_train_step",
)
MOUSE_WIDTH = (106, 31, 3)   # toy_model_spec(V_side, J, B): V=11,236, J=31 (SMILy_Mouse)
# the JAX benches' regressor: ResNet-50, IEF decoder 256 × 4 layers × 3 iterations
REGRESSOR_KW = dict(backbone="resnet50", decoder_dim=256, decoder_depth=4, ief_iters=3,
                    compute_dtype=torch.bfloat16)
MULTIVIEW_KW = dict(fusion_heads=4, fusion_layers=2, camera_delta_mode=False)
# config → (frames, work-list cap or None for exact)
FITTER_CONFIGS = {CONFIGS[2]: (1, None), CONFIGS[3]: (10, None),
                  CONFIGS[4]: (10, 800), CONFIGS[5]: (10, 700)}
PUBLISHED_FP32_PEAK_GFLOPS = 67_000.0   # H100 SXM, FP32 outside the tensor cores, 700 W
OUT = Path(__file__).resolve().parents[2] / "build" / "bench_all.json"
# the JAX bench's registration step (tools/bench_all.py:69-105)
FIT3D_LOSS_WEIGHTS = {"chamfer": 1.0, "edge": 1.0, "normal": 0.01, "laplacian": 0.1, "sdf": 0.0}
FIT3D_SAMPLES = 3000


def bench_forward(spec, repeats=3, target_s=1.0):
    """SMIL forward (no gradient) at batch 1 and 64: ms and samples/s."""
    res = {}
    for batch in (1, 64):
        rng = np.random.RandomState(0)
        betas = torch.as_tensor(rng.randn(batch, spec.n_betas).astype(np.float32) * 0.3)
        theta = torch.as_tensor(rng.randn(batch, spec.n_joints, 3).astype(np.float32) * 0.1)

        @torch.no_grad()
        def chain(carry):
            b, t = carry
            verts = smil_forward(spec, b, t).verts
            # fold the output back in: every iteration depends on the last
            return b * (1.0 - 1e-5) + torch.mean(verts) * 1e-7, t

        dt = timeit_chain(chain, (betas.to(spec.device), theta.to(spec.device)),
                          n1=64, n2=256, repeats=repeats, target_s=target_s)
        res[f"b{batch}_ms"] = dt * 1000
        res[f"b{batch}_samples_per_sec"] = batch / dt
    return res


def fitter3d_step(spec, meshes):
    """config2's registration step against the target ``meshes`` [(verts,
    faces), ...], registered at once: every field of ``Fit3DParams`` under one
    Adam(1e-3), chamfer + edge + normal + laplacian at 3000 samples a mesh.
    As in the JAX bench, every step draws the same samples (its generator is
    re-seeded a step, as the JAX step reuses one key). Returns ``(step,
    params)``: ``step(params)`` takes one step and returns ``params``."""
    targets = pad_target_meshes(meshes, device=spec.device)
    params = init_3d_params(spec, len(meshes))
    for name in params.fields():
        getattr(params, name).requires_grad_(True)
    topo = template_topology(spec)
    opt = torch.optim.Adam([getattr(params, k) for k in params.fields()], lr=1e-3)
    gen = torch.Generator(device=spec.device)

    def step(state):
        gen.manual_seed(0)
        opt.zero_grad(set_to_none=True)
        total, _ = registration_losses(spec, topo, state, targets, gen, FIT3D_LOSS_WEIGHTS,
                                       num_samples=FIT3D_SAMPLES)
        total.backward()
        opt.step()
        return state

    return step, params


def bench_fitter3d(spec, target_obj, repeats=3, target_s=1.0):
    """One registration step of the template against one target scan."""
    v, f = load_obj(target_obj)
    step, params = fitter3d_step(spec, [(v, f)])
    dt = timeit_chain(step, params, n1=10, n2=40, warmup=3, repeats=repeats, target_s=target_s)
    return {"step_ms": dt * 1000, "iters_per_sec": 1 / dt,
            "target_verts": int(v.shape[0]), "samples": FIT3D_SAMPLES}


def measure_fp32_fma_peak_gflops(device="cuda", repeats=3, target_s=1.0):
    """The card's FP32 FMA rate in GFLOP/s, measured with K5 (``fma_peak``,
    a hand-written CUDA kernel) at the JAX probe's shape (2048, 1024): one
    read and one write of global memory against 8192 FP32 operations an
    element, so the rate is the FMA pipes'. Self-chained as the JAX probe is:
    the output feeds the next launch (it grows ~82× a launch and reaches inf
    after ~20; the FMA rate does not depend on the values)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the FP32 peak is a property of the card: pass a CUDA device")
    x = torch.full(SHAPE, 0.5, dtype=torch.float32, device=dev)
    dt = timeit_chain(fma_peak, x, n1=4, n2=16, repeats=repeats, target_s=target_s)
    return flops(x.numel()) / dt / 1e9


def measure_worklist_iou(spec, cap, size=512):
    """Silhouette IoU of the raster capped at ``cap`` faces a tile against
    the exact raster, on the model's rest pose seen by the default camera."""
    with torch.no_grad():
        out = smil_forward(spec, torch.zeros((1, spec.n_betas), device=spec.device),
                           torch.zeros((1, spec.n_joints, 3), device=spec.device))
        cam = default_camera(device=spec.device)
        pv = cam.world_to_view(out.verts[0])
        ndc = cam.view_to_ndc(pv)
        v = torch.cat([ndc[:, :2], pv[:, 2:3]], dim=1)
        exact = soft_silhouette(v, spec.faces, (size, size), znear=1e-3)
        capped = soft_silhouette(v, spec.faces, (size, size), znear=1e-3, approx_max_faces=cap)
    return round(silhouette_iou(capped, exact), 4)


def raster_active_subgroups(spec, params: FitParams, image_size, approx_max_faces=None) -> int:
    """The raster's work bound at ``params``: the 8-face subgroups the exact
    raster's cull admits summed over (frame, tile), or with a cap the summed
    work-list lengths; counted as the JAX bench counts them (rest betas
    broadcast, no limb scales, the default camera, znear 0)."""
    H, W = image_size
    N = params.global_rot.shape[0]
    with torch.no_grad():
        theta = torch.cat([params.global_rot[:, None, :], params.joint_rot], dim=1)
        out = smil_forward(spec, params.betas.expand(N, spec.n_betas), theta)
        cam = default_camera(device=spec.device)
        pv = cam.world_to_view(out.verts + params.trans[:, None, :])
        ndc = cam.view_to_ndc(pv)
        tri = torch.cat([ndc[..., :2], pv[..., 2:3]], dim=-1)[:, spec.faces.long()]
        valid = torch.any(tri[..., 2] > 0.0, dim=-1)
        if approx_max_faces is not None:
            k_sub = max(1, -(-approx_max_faces // R.FACE_GROUP))
            _, count = RW._tile_worklists(tri[..., :2], tri[..., 2], valid, H, W, 1e-4, k_sub)
            return int(count.sum())
        mask = R._tile_cull_mask(tri[..., :2], valid, H, W, 1e-4)
        bits = (mask[:, None] >> torch.arange(32, device=mask.device)) & 1
        return int(bits.sum())


def _kernel_counts():
    """(launches, frames) of each raster kernel as the recorder counts them."""
    c = monitoring.summary()["counters"]
    return {name: (c.get(f"raster.{name}.launches", 0), c.get(f"raster.{name}.frames", 0))
            for name in ("exact_fwd", "exact_bwd", "worklist_fwd", "worklist_bwd")}


def bench_fitter_step(spec, n_frames=1, approx_max_faces=None, fp32_peak_gflops=None,
                      size=512, repeats=3, target_s=1.0):
    """The bench's fitter step (``smilify_tpu_torch.bench``) on ``n_frames``
    frames at ``size``²: single-dispatch and chained-10 rates, the raster's
    work bound at a mid-fit pose, its FP32 rate over the step and, given the
    card's peak, its share of that peak. Also which raster kernels the timed
    steps launched, and how many frames each launch took."""
    H = W = size
    N = n_frames
    data = synthetic_fit_data(spec, N, (H, W))
    weights = OPT_WEIGHTS[1]
    with monitoring.recording():
        before = _kernel_counts()
        single, chain = time_modes(spec, data, weights, (H, W), approx_max_faces, repeats,
                                   target_s)
        after = _kernel_counts()
    dt, dt_chained = 1 / single, 1 / chain
    launches = {k: after[k][0] - before[k][0] for k in after}
    frames = {k: after[k][1] - before[k][1] for k in after}

    # a mid-fit pose (the regime the timing windows covered) for the work bound
    params, step = fit_step(spec, data, weights, (H, W), approx_max_faces)
    for _ in range(25):
        step()
    groups = raster_active_subgroups(spec, params, (H, W), approx_max_faces)
    tests = groups * R.FACE_GROUP * R.TILE_PIX
    ops = tests * (FWD_OPS_PER_PAIR + BWD_OPS_PER_PAIR)
    out = {"step_ms": dt * 1000, "iters_per_sec": 1 / dt,
           "frame_iters_per_sec": N / dt, "frames": N,
           "chained10_step_ms": dt_chained * 1000,
           "chained10_iters_per_sec": 1 / dt_chained,
           "chained10_frame_iters_per_sec": N / dt_chained,
           "image": f"{H}x{W}", "faces": int(spec.n_faces),
           "raster_mode": ("exact" if approx_max_faces is None
                           else f"worklist_top{approx_max_faces}"),
           # every bbox-overlapping subgroup counted as fully evaluated: the
           # saturation early-out skips a share of these at run time
           "raster_point_triangle_tests_bound": int(tests),
           "raster_ops_per_pair": FWD_OPS_PER_PAIR + BWD_OPS_PER_PAIR,
           "raster_work_bound_gflops": ops / dt / 1e9,
           "roofline_note": "the raster is FP32 elementwise work (no tensor cores). "
                            "work_bound_gflops counts every bbox-overlapping subgroup "
                            f"as fully evaluated, forward and backward ({FWD_OPS_PER_PAIR} + "
                            f"{BWD_OPS_PER_PAIR} FP32 operations a (pixel, face) pair), "
                            "over the single-dispatch step time: an upper bound on the "
                            "raster's achieved rate",
           "kernel_launches": launches,
           "kernel_frames_per_launch": {k: frames[k] / n for k, n in launches.items() if n}}
    if fp32_peak_gflops:
        out["fp32_fma_peak_gflops_measured"] = fp32_peak_gflops
        out["fp32_peak_gflops_published"] = PUBLISHED_FP32_PEAK_GFLOPS
        out["raster_work_bound_over_peak_pct"] = 100 * (ops / dt / 1e9) / fp32_peak_gflops
    return out


def singleview_model(spec, res=224, compute_dtype=torch.bfloat16):
    """config 4's regressor on ``spec``'s device, eval mode, seeded weights."""
    from smilify_tpu_torch.models.regressor import RegressorConfig, SMILRegressor

    torch.manual_seed(0)
    cfg = RegressorConfig(n_pose=spec.n_joints - 1, n_betas=spec.n_betas, n_joints=spec.n_joints,
                          **dict(REGRESSOR_KW, compute_dtype=compute_dtype))
    model = SMILRegressor(cfg, img_size=res).to(spec.device).eval()
    if spec.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return cfg, model


def multiview_model(spec, n_views, res=224, compute_dtype=torch.bfloat16):
    """configs 5a/5b's regressor on ``spec``'s device, eval mode, seeded weights."""
    from smilify_tpu_torch.models.multiview import MultiViewConfig, MultiViewSMILRegressor

    torch.manual_seed(0)
    cfg = MultiViewConfig(n_pose=spec.n_joints - 1, n_betas=spec.n_betas, n_joints=spec.n_joints,
                          max_views=n_views, **dict(REGRESSOR_KW, compute_dtype=compute_dtype),
                          **MULTIVIEW_KW)
    model = MultiViewSMILRegressor(cfg, img_size=res).to(spec.device).eval()
    if spec.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return cfg, model


def bench_singleview_inference(spec, batches=(8, 128), res=224, repeats=3, target_s=1.0):
    """config 4: images/s of the model and the decode at each batch."""
    from smilify_tpu_torch.models.predict import decoded

    cfg, model = singleview_model(spec, res)

    @torch.no_grad()
    def chain(imgs):
        preds, _ = decoded(model, cfg, spec, {"image": imgs})
        # fold the predictions into the next batch: every step depends on the last
        return imgs * (1.0 - 1e-5) + torch.mean(preds["trans"]) * 1e-7

    out = {"backbone": "resnet50", "resolution": res, "compute": "bf16 autocast backbone"}
    rng = np.random.RandomState(0)
    for B in batches:
        imgs = torch.as_tensor(rng.rand(B, res, res, 3).astype(np.float32), device=spec.device)
        dt = timeit_chain(chain, imgs, n1=4, n2=16, repeats=repeats, target_s=target_s)
        out[f"batch{B}_ms"] = dt * 1000
        out[f"batch{B}_images_per_sec"] = B / dt
    out["images_per_sec"] = out[f"batch{batches[-1]}_images_per_sec"]
    return out


def multiview_chain(spec, cfg, model, res):
    """configs 5a/5b's dependent step: model, decode, SMIL forward, the
    projection through each view and the DLT re-triangulation of the
    projected keypoints, folded back into the next step's images."""
    from smilify_tpu_torch.models.multiview import (
        project_through_view_cameras,
        view_projection_matrices,
    )
    from smilify_tpu_torch.models.predict import decoded
    from smilify_tpu_torch.models.regressor import float32_region, forward_model
    from smilify_tpu_torch.render.cameras import triangulate_dlt

    @torch.no_grad()
    def chain(carry):
        imgs, vm, cids = carry
        preds, _ = decoded(model, cfg, spec,
                           {"images": imgs, "view_mask": vm, "camera_indices": cids})
        with float32_region(imgs.device):
            _, joints3d = forward_model(spec, preds)
            kp2d = project_through_view_cameras(preds, joints3d, (res, res))
            P = view_projection_matrices(preds)
            ndc = torch.stack([(res - 1.0 - 2.0 * kp2d[..., 1] * res) / res,
                               (res - 1.0 - 2.0 * kp2d[..., 0] * res) / res], dim=-1)
            ones = torch.ones(ndc.shape[:2], dtype=torch.bool, device=ndc.device)
            tri = triangulate_dlt(ndc, P, ones)
        return imgs * (1.0 - 1e-5) + (torch.mean(kp2d) + torch.mean(tri)) * 1e-8, vm, cids

    return chain


def bench_multiview_inference(spec, n_views, label, batches=(1, 8), res=224, repeats=3,
                              target_s=1.0):
    """configs 5a/5b: frames/s (a frame = ``n_views`` images) at each batch."""
    cfg, model = multiview_model(spec, n_views, res)
    chain = multiview_chain(spec, cfg, model, res)
    out = {"views": n_views, "resolution": res, "compute": "bf16 autocast backbone"}
    rng = np.random.RandomState(0)
    for B in batches:
        imgs = torch.as_tensor(rng.rand(B, n_views, res, res, 3).astype(np.float32),
                               device=spec.device)
        vm = torch.ones((B, n_views), dtype=torch.bool, device=spec.device)
        cids = torch.arange(n_views, device=spec.device).expand(B, n_views)
        dt = timeit_chain(chain, (imgs, vm, cids), n1=3, n2=12, repeats=repeats, target_s=target_s)
        out[f"{label}_b{B}_ms"] = dt * 1000
        out[f"{label}_b{B}_frames_per_sec"] = B / dt
    out[f"{label}_frames_per_sec"] = out[f"{label}_b{batches[-1]}_frames_per_sec"]
    return out


PEAK_BF16_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
TRAIN_LR = 1e-4                   # the JAX benches' optax.adam(1e-4)
# the single-view train step's loss weights (tools/bench_all.py:386-395)
TRAIN_WEIGHTS = {"global_rot": 1.0, "joint_rot": 1.0, "betas": 0.5, "trans": 1.0,
                 "keypoint_2d": 1.0}


def singleview_train_setup(spec, backbone="resnet50", res=224, compute_dtype=torch.bfloat16,
                           mesh=None):
    """configs 4b/4c: (model in train mode, its train step, a batch maker
    ``batch(B, rng)``): Adam 1e-4, param MSEs + visibility-weighted 2D
    keypoints. With a ``('data',)`` ``mesh`` the step is the data-parallel
    one (``train/trainer.py::make_train_step``): give it this rank's rows."""
    from smilify_tpu_torch.models.regressor import RegressorConfig, SMILRegressor, compute_batch_loss
    from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn
    from smilify_tpu_torch.train.trainer import PlainAdam, make_train_step

    torch.manual_seed(0)
    cfg = RegressorConfig(n_pose=spec.n_joints - 1, n_betas=spec.n_betas, n_joints=spec.n_joints,
                          **dict(REGRESSOR_KW, backbone=backbone, compute_dtype=compute_dtype))
    model = SMILRegressor(cfg, img_size=res).to(spec.device).train()
    if spec.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    def loss_fn(preds, batch):
        targets = {k: batch[k] for k in ("global_rot", "joint_rot", "betas", "trans",
                                         "keypoints_2d", "kp_visibility")}
        return compute_batch_loss(spec, cfg, preds, targets, TRAIN_WEIGHTS, image_size=(res, res))

    step = make_train_step(model, make_singleview_apply_fn(cfg, spec), loss_fn,
                           PlainAdam(model, TRAIN_LR), mesh=mesh)
    dev, J = spec.device, spec.n_joints

    def batch(B, rng):
        return {"image": torch.as_tensor(rng.rand(B, res, res, 3).astype(np.float32), device=dev),
                "global_rot": torch.zeros((B, 3), device=dev),
                "joint_rot": torch.zeros((B, J - 1, 3), device=dev),
                "betas": spec.shape_mean_betas.expand(B, -1).clone(),
                "trans": torch.zeros((B, 3), device=dev),
                "keypoints_2d": torch.as_tensor(rng.rand(B, J, 2).astype(np.float32), device=dev),
                "kp_visibility": torch.ones((B, J), device=dev)}

    return cfg, model, step, batch


def multiview_train_setup(spec, n_views=4, res=224, compute_dtype=torch.bfloat16):
    """config 5c: (model in train mode, its train step, a batch maker): the
    full multi-view loss (param MSEs, per-view 2D keypoints, 3D keypoints,
    cameras, DLT triangulation consistency) at its default weights."""
    from smilify_tpu_torch.models.multiview import (
        MULTIVIEW_DEFAULT_LOSS_WEIGHTS,
        MultiViewConfig,
        MultiViewSMILRegressor,
        compute_multiview_batch_loss,
    )
    from smilify_tpu_torch.train.multiview_setup import make_multiview_apply_fn
    from smilify_tpu_torch.train.trainer import PlainAdam, make_train_step

    torch.manual_seed(0)
    cfg = MultiViewConfig(n_pose=spec.n_joints - 1, n_betas=spec.n_betas, n_joints=spec.n_joints,
                          max_views=n_views, **dict(REGRESSOR_KW, compute_dtype=compute_dtype),
                          **MULTIVIEW_KW)
    model = MultiViewSMILRegressor(cfg, img_size=res).to(spec.device).train()
    if spec.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    def loss_fn(preds, batch):
        return compute_multiview_batch_loss(spec, cfg, preds, batch["targets"], batch["view_mask"],
                                            MULTIVIEW_DEFAULT_LOSS_WEIGHTS, image_size=(res, res))

    step = make_train_step(model, make_multiview_apply_fn(cfg, spec, (res, res)), loss_fn,
                           PlainAdam(model, TRAIN_LR))
    dev, K = spec.device, spec.n_joints
    eye = torch.eye(3, device=dev)

    def batch(B, rng):
        f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
        targets = {"global_rot": torch.zeros((B, 3), device=dev),
                   "joint_rot": torch.zeros((B, K - 1, 3), device=dev),
                   "betas": spec.shape_mean_betas.expand(B, -1).clone(),
                   "trans": torch.zeros((B, 3), device=dev),
                   "keypoints_2d": f32(rng.rand(B, n_views, K, 2)),
                   "kp_visibility": torch.ones((B, n_views, K), device=dev),
                   "keypoints_3d": f32(rng.rand(B, K, 3)),
                   "view_fov": torch.full((B, n_views), 60.0, device=dev),
                   "view_cam_rot": eye.expand(B, n_views, 3, 3).clone(),
                   "view_cam_trans": torch.tensor([0.0, 0.0, 2.7], device=dev).expand(
                       B, n_views, 3).clone()}
        return {"images": f32(rng.rand(B, n_views, res, res, 3)),
                "view_mask": torch.ones((B, n_views), dtype=torch.bool, device=dev),
                "camera_indices": torch.arange(n_views, device=dev).expand(B, n_views),
                "targets": targets}

    return cfg, model, step, batch


def train_mfu(model, inputs, seconds: float) -> float:
    """3 × the forward FLOPs of ``model`` on ``inputs`` (forward and
    backward), a second, over the dense bf16 peak."""
    return 3 * count_flops(model, *inputs) / seconds / PEAK_BF16_PER_S


def _bench_train(setup, keys, inputs_of, batches, repeats, target_s, n_views=1):
    """Time ``setup``'s train step at each batch: ms, the ``keys`` rates
    (per sample, or per view image) and the mfu."""
    _, model, step, make_batch = setup
    rng = np.random.RandomState(0)
    out = {}
    for B in batches:
        batch = make_batch(B, rng)
        loss = torch.zeros((), device=next(model.parameters()).device)
        # the step updates the model in place: each depends on the last
        dt = timeit_chain(lambda _: step(batch)[0], loss, n1=2, n2=6, repeats=repeats,
                          target_s=target_s)
        out[f"batch{B}_ms"] = dt * 1000
        for key, per in keys.items():
            out[f"batch{B}_{key}"] = B * (n_views if per == "view" else 1) / dt
        out[f"batch{B}_mfu"] = train_mfu(model, inputs_of(batch), dt)
    out["mfu"] = out[f"batch{batches[-1]}_mfu"]
    return out


def bench_singleview_train_step(spec, backbone="resnet50", batches=(32, 128), res=224,
                                repeats=3, target_s=1.0):
    """configs 4b/4c: the single-view train step's images/s and mfu at each batch."""
    out = {"backbone": backbone, "resolution": res, "compute": "bf16 autocast backbone",
           "losses": "param MSEs + visibility-weighted kp2d"}
    out.update(_bench_train(singleview_train_setup(spec, backbone, res),
                            {"images_per_sec": "sample"}, lambda b: (b["image"],), batches,
                            repeats, target_s))
    return out


def bench_multiview_train_step(spec, n_views=4, batches=(2, 8), res=224, repeats=3, target_s=1.0):
    """config 5c: the multi-view train step's frames/s, view images/s and mfu."""
    out = {"backbone": "resnet50", "resolution": res, "views": n_views,
           "compute": "bf16 autocast backbone",
           "losses": "param MSEs + per-view kp2d + kp3d + cameras + DLT consistency"}
    out.update(_bench_train(multiview_train_setup(spec, n_views, res),
                            {"frames_per_sec": "sample", "view_images_per_sec": "view"},
                            lambda b: (b["images"], b["view_mask"], b["camera_indices"]), batches,
                            repeats, target_s, n_views))
    return out


def count_flops(model, *inputs) -> int:
    """Multiply-adds × 2 of one forward of ``model`` on ``inputs``, counted
    from the shapes its convolutions, linear layers and attention modules
    see (forward hooks; normalizations and activations are not counted)."""
    from smilify_tpu_torch.models.backbones import Attention
    from smilify_tpu_torch.models.transformer_decoder import MultiHeadDotProductAttention

    total = [0]

    def conv(m, args, out):
        k = m.weight[0].numel()                    # (Cin / groups) · kh · kw
        total[0] += 2 * out.numel() * k

    def linear(m, args, out):
        total[0] += 2 * out.numel() * m.in_features

    def attention(m, args, out):
        q = args[0]
        kv = args[1] if len(args) > 1 else q
        # scores and weighted sum: 2 · (B · Lq · Lk · D) each
        total[0] += 4 * q.shape[0] * q.shape[1] * kv.shape[1] * q.shape[2]

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, (Attention, MultiHeadDotProductAttention)):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def run(spec, only=None, size=512, repeats=3, target_s=1.0, target_obj=None) -> dict:
    """The configs whose key contains any string of ``only`` (all when None);
    config2 only with a ``target_obj``. Config 5b builds its own
    mouse-width spec on ``spec``'s device."""
    def wanted(key):
        return only is None or any(s in key for s in only)

    report = {}
    if wanted(CONFIGS[0]):
        report[CONFIGS[0]] = bench_forward(spec, repeats, target_s)
    if wanted(CONFIGS[1]) and target_obj is not None:
        report[CONFIGS[1]] = bench_fitter3d(spec, target_obj, repeats, target_s)
    fitter_configs = [k for k in FITTER_CONFIGS if wanted(k)]
    peak = None
    if fitter_configs and spec.device.type == "cuda":
        peak = measure_fp32_fma_peak_gflops(spec.device, repeats, target_s)
        report["fp32_fma_peak_gflops_measured"] = peak
    for key in fitter_configs:
        frames, cap = FITTER_CONFIGS[key]
        report[key] = bench_fitter_step(spec, frames, cap, peak, size, repeats, target_s)
        if cap is not None:
            report[key]["iou_vs_exact"] = measure_worklist_iou(spec, cap, size)
    if wanted(CONFIGS[6]):
        report[CONFIGS[6]] = bench_singleview_inference(spec, repeats=repeats, target_s=target_s)
    if wanted(CONFIGS[7]):
        report[CONFIGS[7]] = bench_multiview_inference(spec, 4, "stick4", repeats=repeats,
                                                       target_s=target_s)
    if wanted(CONFIGS[8]):
        from smilify_tpu_torch.core.spec import toy_model_spec

        mouse = toy_model_spec(*MOUSE_WIDTH, device=spec.device)
        report[CONFIGS[8]] = bench_multiview_inference(mouse, 18, "mouse18", repeats=repeats,
                                                       target_s=target_s)
    if wanted(CONFIGS[9]):
        report[CONFIGS[9]] = bench_singleview_train_step(spec, repeats=repeats, target_s=target_s)
    if wanted(CONFIGS[10]):
        report[CONFIGS[10]] = bench_singleview_train_step(spec, "resnet50_gn", repeats=repeats,
                                                          target_s=target_s)
    if wanted(CONFIGS[11]):
        report[CONFIGS[11]] = bench_multiview_train_step(spec, repeats=repeats, target_s=target_s)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="the configs of tools/bench_all.py")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only configs whose key contains any of these substrings; "
                         "results merge into the existing --out file")
    ap.add_argument("--model", default=None, help="model pickle (default: the STICK-width toy spec)")
    ap.add_argument("--target-obj", type=Path, default=None,
                    help="config2's target scan (the JAX bench's is the Atta scan, which "
                         "the repository does not hold); without it config2 is skipped")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.target_obj is None and any(s in CONFIGS[1] for s in args.only or ()):
        ap.error("config2 needs its target scan: pass --target-obj")
    dev = resolve_device(args.device)
    set_float32_matmul(dev)
    spec, name = load_spec(args.model, dev)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
              "card": card_line() if dev.type == "cuda" else None,
              "model": name, "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    report.update(run(spec, args.only, target_obj=args.target_obj))
    if args.only is not None and args.out.exists():
        report = {**json.loads(args.out.read_text()), **report}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
