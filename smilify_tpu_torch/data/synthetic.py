"""Synthetic multi-view dataset generation from the SMIL model itself (port of
``smilify_tpu/data/synthetic.py``).

Renders ground-truth poses of a ModelSpec through a ring of OpenCV-convention
cameras: the fully-synthetic analogue of the reference's replicAnt pipeline,
used for end-to-end training tests and held-out generalization runs when the
original capture data is unavailable. Because the images are rendered from
the *same* ModelSpec that training and benchmarking use, ground truth is
exactly reachable.

:func:`synthesize_multiview` makes the samples on the device (the SMIL
forward over sample chunks, then one exact raster launch — kernel K1 on the
card — of a whole chunk for each camera) and returns them as numpy sample
dicts; :func:`generate_synthetic_multiview` writes them to the multi-view
HDF5 (the port's codec, ``utils/hdf5_io.py``, and OpenCV), as the JAX
package's function does.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device

# the soft silhouette's colour (RGB) on black
SILHOUETTE_RGB = (0.2, 0.7, 0.9)
ZNEAR = 1e-3


def ring_cameras_opencv(n_views: int, radius: float = 2.5, height: float = 0.8,
                        focal: float = 300.0, resolution: int = 224):
    """OpenCV-convention (R, t, K) ring looking at the origin."""
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        C = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        z = -C / np.linalg.norm(C)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        t = -R @ C
        K = np.array([
            [focal, 0, (resolution - 1) / 2.0],
            [0, focal, (resolution - 1) / 2.0],
            [0, 0, 1.0],
        ])
        cams.append((R, t, K))
    return cams


def draw_parameters(spec, n_samples: int, pose_scale: float = 0.1, beta_scale: float = 0.3,
                    seed: int = 0, keyframe_every: int = 0):
    """The samples' ground-truth (betas (N, B), global_rot (N, 3), joint_rot
    (N, J−1, 3), trans (N, 3)), float32.

    Drawn per sample in a fixed order from ``np.random.RandomState(seed)``
    (the determinism contract: the same ``seed`` gives the same parameters
    whatever the chunk size). ``keyframe_every > 0`` makes every
    ``keyframe_every``-th draw a keyframe and cosine-interpolates the frames
    between (a video-like clip with the keyframes' distribution)."""
    rng = np.random.RandomState(seed)
    P = spec.n_joints - 1
    betas_all = np.empty((n_samples, spec.n_betas), np.float32)
    grot_all = np.empty((n_samples, 3), np.float32)
    jrot_all = np.empty((n_samples, P, 3), np.float32)
    for s in range(n_samples):
        betas_all[s] = rng.randn(spec.n_betas).astype(np.float32) * beta_scale
        grot_all[s] = rng.randn(3).astype(np.float32) * 0.3
        jrot_all[s] = rng.randn(P, 3).astype(np.float32) * pose_scale
    trans_all = np.zeros((n_samples, 3), np.float32)
    if keyframe_every > 0:
        kf = np.arange(0, n_samples, keyframe_every)
        if kf[-1] != n_samples - 1:
            kf = np.append(kf, n_samples - 1)
        t = np.arange(n_samples, dtype=np.float64)
        seg = np.clip(np.searchsorted(kf, t, side="right") - 1, 0, len(kf) - 2)
        f = (t - kf[seg]) / np.maximum(kf[seg + 1] - kf[seg], 1)
        w = (0.5 - 0.5 * np.cos(np.pi * f)).astype(np.float32)  # cosine ease
        for arr in (betas_all, grot_all, jrot_all):
            a, b = arr[kf[seg]], arr[kf[seg + 1]]
            arr[:] = a + (b - a) * w.reshape((-1,) + (1,) * (arr.ndim - 1))
    return betas_all, grot_all, jrot_all, trans_all


def view_ndc(verts: torch.Tensor, R, t, K, resolution: int) -> torch.Tensor:
    """(C, V, 3) world vertices → the raster's (C, V, 3) input (NDC xy, view
    z) through the OpenCV camera (R, t, K) at ``resolution``²."""
    from smilify_tpu_torch.render.cameras import camera_from_opencv

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=verts.device)

    cam = camera_from_opencv(dev(R), dev(t), dev(K), (resolution, resolution))
    pv = cam.world_to_view(verts)
    ndc = cam.view_to_ndc(pv)
    return torch.cat([ndc[..., :2], pv[..., 2:3]], dim=-1)


def _pad(a: np.ndarray, n_pad: int) -> np.ndarray:
    """``a`` with its last row repeated up to ``n_pad`` rows."""
    n = a.shape[0]
    return np.concatenate([a, np.repeat(a[-1:], n_pad - n, axis=0)], 0) if n_pad != n else a


@torch.no_grad()
def synthesize_multiview(
    spec,
    n_samples: int = 8,
    n_views: int = 4,
    resolution: int = 96,
    pose_scale: float = 0.1,
    beta_scale: float = 0.3,
    seed: int = 0,
    render_images: bool = True,
    chunk_size: int = 32,
    keyframe_every: int = 0,
    device="cuda",
) -> List[Dict]:
    """Sample random SMIL configurations (:func:`draw_parameters`), project
    their joints through a camera ring and render silhouette-shaded images:
    the sample dicts of :func:`~smilify_tpu_torch.data.hdf5_dataset.write_multiview_hdf5`,
    with ``images`` a (views, R, R, 3) uint8 array.

    The SMIL forward runs on ``device`` in chunks of ``chunk_size`` samples
    (the last chunk padded with copies of the last sample), and each (camera,
    chunk) is one exact soft-silhouette render of the whole chunk: one launch
    of kernel K1 on the card."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.render.rasterizer import soft_silhouette

    dev = resolve_device(device)
    if spec.device != dev:
        spec = spec.to(dev)
    cams = ring_cameras_opencv(n_views, resolution=resolution)
    betas_all, grot_all, jrot_all, trans_all = draw_parameters(
        spec, n_samples, pose_scale, beta_scale, seed, keyframe_every)
    theta_all = np.concatenate([grot_all[:, None], jrot_all], axis=1)  # (N, J, 3)

    C = min(chunk_size, n_samples)
    n_chunks = -(-n_samples // C)
    n_pad = n_chunks * C
    betas_p = torch.from_numpy(_pad(betas_all, n_pad)).to(dev)
    theta_p = torch.from_numpy(_pad(theta_all, n_pad)).to(dev)
    verts = torch.empty((n_pad, spec.n_verts, 3), dtype=torch.float32, device=dev)
    joints = torch.empty((n_pad, spec.n_joints, 3), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * C, (c + 1) * C
        out = smil_forward(spec, betas_p[lo:hi], theta_p[lo:hi])
        verts[lo:hi], joints[lo:hi] = out.verts, out.joints
    joints_np = joints[:n_samples].cpu().numpy()

    images_all = np.zeros((n_samples, n_views, resolution, resolution, 3), np.uint8)
    if render_images:
        colour = torch.tensor(SILHOUETTE_RGB, dtype=torch.float32, device=dev)
        for vi, (R, t, K) in enumerate(cams):
            for c in range(n_chunks):
                lo, hi = c * C, (c + 1) * C
                alpha = soft_silhouette(view_ndc(verts[lo:hi], R, t, K, resolution), spec.faces,
                                        (resolution, resolution), znear=ZNEAR)
                keep = min(hi, n_samples) - lo
                img = alpha[:keep, ..., None] * colour                  # float32, as numpy's
                images_all[lo:lo + keep, vi] = (img * 255).to(torch.uint8).cpu().numpy()

    # ---- host-side vectorized keypoint projection
    kp2d_v, kpv_v = [], []
    for (R, t, K) in cams:
        pc = joints_np @ R.T + t                              # (N, J, 3)
        uv = pc[..., :2] / np.maximum(pc[..., 2:3], 1e-9) * np.diag(K)[:2] + K[:2, 2]
        inb = (
            (uv[..., 0] >= 0) & (uv[..., 0] < resolution)
            & (uv[..., 1] >= 0) & (uv[..., 1] < resolution)
            & (pc[..., 2] > 0)
        )
        kp2d_v.append(uv.astype(np.float32))
        kpv_v.append(inb.astype(np.float32))
    kp2d_all = np.stack(kp2d_v, axis=1)                       # (N, views, J, 2)
    kpv_all = np.stack(kpv_v, axis=1)
    Ks = np.stack([K for (_, _, K) in cams]).astype(np.float32)
    Rs = np.stack([R for (R, _, _) in cams]).astype(np.float32)
    ts = np.stack([t for (_, t, _) in cams]).astype(np.float32)
    sizes = np.full((n_views, 2), resolution, np.int32)

    return [{
        "images": images_all[s_idx],
        "camera_indices": list(range(n_views)),
        "keypoints_2d": kp2d_all[s_idx],
        "keypoint_visibility": kpv_all[s_idx],
        "camera_intrinsics": Ks,
        "camera_extrinsics_R": Rs,
        "camera_extrinsics_t": ts,
        "image_sizes": sizes,
        "keypoints_3d": joints_np[s_idx],
        "global_rot": grot_all[s_idx],
        "joint_rot": jrot_all[s_idx],
        "betas": betas_all[s_idx],
        "trans": trans_all[s_idx],
        "session_name": "synthetic",
        "frame_idx": s_idx,
    } for s_idx in range(n_samples)]


def generate_synthetic_multiview(
    spec,
    out_path: str,
    n_samples: int = 8,
    n_views: int = 4,
    resolution: int = 96,
    pose_scale: float = 0.1,
    beta_scale: float = 0.3,
    seed: int = 0,
    render_images: bool = True,
    chunk_size: int = 32,
    keyframe_every: int = 0,
    device="cuda",
):
    """:func:`synthesize_multiview`, written to the multi-view HDF5 at
    ``out_path`` (JPEG images through OpenCV); returns ``out_path``."""
    from smilify_tpu_torch.data.hdf5_dataset import write_multiview_hdf5

    samples = synthesize_multiview(
        spec, n_samples, n_views, resolution, pose_scale, beta_scale, seed,
        render_images, chunk_size, keyframe_every, device=device)
    write_multiview_hdf5(
        out_path, samples, max_views=n_views, target_resolution=resolution,
        canonical_camera_order=[f"cam_{i}" for i in range(n_views)],
        n_pose=spec.n_joints - 1, n_betas=spec.n_betas, dataset_type="synthetic_multiview",
    )
    return out_path
