"""Neural inference CLI, single- and multi-view (port of
``smilify_tpu/cli/run_inference.py``).

Loads a checkpoint and the config in its ``.meta.json``, predicts over a
dataset (a replicAnt folder, an HDF5 store, or a raw video with the
``default``/``centred``/``bbox_crop`` crop modes) in batches, optionally
smooths the parameter trajectory, exports an AMASS-style animation,
renders each frame (Phong, with the joints drawn; multi-view frames as a
grid of the views) to PNGs and writes them as a video (multi-view: one
video a view, ``{base}_view{v}{ext}``, and the grid's at ``--video``).
``--video`` without ``--render-dir`` renders into the config's
``output.visualizations_dir`` beside the checkpoint. ``predictions.npz`` is
written beside the checkpoint.

Precision: the model's backbone runs under bf16 autocast when the config
asks for mixed precision (``training.use_mixed_precision``); the heads, the
decode, the SMIL forward and the projection run in float32 with TF32 off.

Usage:
  python -m smilify_tpu_torch.cli.run_inference --checkpoint runs/sv/final_model \\
      --data-path <dir|h5|video> [--smooth-window 5] [--export-animation out.npz] \\
      [--render-dir out_frames] [--video out.mp4] [--device cuda]

``--shard`` splits each batch over every visible card, the model
replicated on each (the JAX CLI's batches sharded over the local devices).

HDF5 stores are read by the port's codec (``utils/hdf5_io.py``), on the
card's machine too.
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device, set_float32_matmul
from smilify_tpu_torch.serve import discover_checkpoint, load_model_from_checkpoint, predictor

RENDER_CHUNK = 8   # single-view frames rendered between two host fetches
VIDEO_FPS = 15


def _interleave(parts):
    """Strided shares ``x[c::n]`` of a batch back into one array in order."""
    out = np.empty((sum(len(p) for p in parts),) + parts[0].shape[1:], parts[0].dtype)
    for c, p in enumerate(parts):
        out[c::len(parts)] = p
    return out


def render_frame(spec, vtx, j3d, R, T, fov, res):
    """One frame through one camera: (uint8 (res, res, 3) Phong image, (K, 2)
    (y, x) joints), both on the vertices' device."""
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.phong import render_phong

    cam = default_camera(device=vtx.device).replace(R=R, T=T, fov=fov)
    pts_view = cam.world_to_view(vtx)
    ndc = cam.view_to_ndc(pts_view)
    verts_ndc = torch.cat([ndc[:, :2], pts_view[:, 2:3]], dim=1)
    img = render_phong(vtx, pts_view, verts_ndc, spec.faces, (res, res))
    kp = cam.project_points_yx(j3d, (res, res))
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8), kp


def render_frames(spec, rcfg, traj, res, render_dir, multiview: bool):
    """Render every frame of ``traj`` (numpy predictions) to
    ``render_dir/frame_%05d.png``: single-view frames RENDER_CHUNK at a time
    (the last chunk's indices clamped to the last frame) with one host
    fetch a chunk; multi-view frames view by view, tiled in rows of ≤ 4
    views. Returns (the frames as written, uint8 (H, W, 3) each; for
    multi-view the frames of each view, else None), so that a video needs
    no second render."""
    from smilify_tpu_torch.models.regressor import float32_region, forward_model
    from smilify_tpu_torch.utils.image_io import write_png
    from smilify_tpu_torch.utils.visualization import draw_joints

    os.makedirs(render_dir, exist_ok=True)
    dev = spec.device
    preds = {k: torch.as_tensor(v, device=dev) for k, v in traj.items()}
    n = preds["global_rot"].shape[0]
    frames = []
    with torch.no_grad(), float32_region(dev):
        verts, joints3d = forward_model(spec, preds, use_ue_scaling=rcfg.use_ue_scaling)
        if multiview:
            V = preds["view_fov"].shape[1]
            per_view = [[] for _ in range(V)]
            for i in range(n):
                views = [render_frame(spec, verts[i], joints3d[i], preds["view_cam_rot"][i, v],
                                      preds["view_cam_trans"][i, v], preds["view_fov"][i, v], res)
                         for v in range(V)]
                imgs = torch.stack([u8 for u8, _ in views]).cpu().numpy()
                kps = torch.stack([kp for _, kp in views]).cpu().numpy()
                row = [draw_joints(imgs[v], kps[v]) for v in range(V)]
                for v in range(V):
                    per_view[v].append(row[v])
                cols = min(4, V)
                rows_n = -(-V // cols)
                row += [np.zeros_like(row[0])] * (rows_n * cols - V)
                grid = np.concatenate([np.concatenate(row[r * cols:(r + 1) * cols], axis=1)
                                       for r in range(rows_n)], axis=0)
                frames.append(grid)
                write_png(os.path.join(render_dir, f"frame_{i:05d}.png"), grid)
            return frames, per_view
        C = max(1, min(RENDER_CHUNK, n))
        for lo in range(0, n, C):
            idx = [min(lo + j, n - 1) for j in range(C)]
            out = [render_frame(spec, verts[i], joints3d[i], preds["cam_rot"][i],
                                preds["cam_trans"][i], preds["fov"][i], res) for i in idx]
            imgs = torch.stack([u8 for u8, _ in out]).cpu().numpy()
            kps = torch.stack([kp for _, kp in out]).cpu().numpy()
            for j in range(min(C, n - lo)):
                frames.append(draw_joints(imgs[j], kps[j]))
                write_png(os.path.join(render_dir, f"frame_{lo + j:05d}.png"), frames[-1])
    return frames, None


def write_videos(path, frames, per_view, fps=VIDEO_FPS):
    """``frames`` as a video at ``path``; with ``per_view`` (multi-view), first
    each view's frames at ``{base}_view{v}{ext}``. Returns the paths written."""
    from smilify_tpu_torch.utils.export import write_video

    written = []
    if per_view is not None:
        base, ext = os.path.splitext(path)
        for v, view_frames in enumerate(per_view):
            written.append(write_video(f"{base}_view{v}{ext}", view_frames, fps=fps))
        print(f"per-view videos → {base}_view*.{ext.lstrip('.')}")
    written.append(write_video(path, frames, fps=fps))
    print(f"video → {path}")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="SMIL neural inference")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--smooth-window", type=int, default=0)
    ap.add_argument("--export-animation", default=None)
    ap.add_argument("--render-dir", default=None)
    ap.add_argument("--video", default=None,
                    help="video of the rendered frames (.mp4: mp4v, else MJPG); multi-view "
                         "adds one a view")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--crop-mode", choices=["default", "centred", "bbox_crop"],
                    default="default", help="raw-video input crop mode")
    ap.add_argument("--sleap-predictions", default=None,
                    help=".slp/.h5 predictions for bbox_crop + keypoint overlays")
    ap.add_argument("--joint-lookup", default=None, help="sleap→model joint CSV")
    ap.add_argument("--shard", action="store_true",
                    help="split each batch over every visible card, the model replicated on "
                         "each (the reference's 2-phase frame-sharded DDP pipeline, "
                         "run_multiview_inference.py:664-930)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.data.video import VideoFrameDataset
    from smilify_tpu_torch.models.predict import input_names
    from smilify_tpu_torch.train.trainer import StagingCollator
    from smilify_tpu_torch.utils.animation_export import AnimationRecorder, PredictionSmoother

    dev = resolve_device(args.device)
    set_float32_matmul(dev)
    model, cfg, rcfg, spec, meta = load_model_from_checkpoint(args.checkpoint, dev)
    res = cfg.model.input_resolution or 224

    if args.data_path.lower().endswith(VideoFrameDataset.VIDEO_EXTS):
        from smilify_tpu_torch.data.sleap_raw import read_joint_lookup_csv

        dataset = VideoFrameDataset(
            args.data_path, resolution=res, crop_mode=args.crop_mode,
            sleap_predictions=args.sleap_predictions, joint_names=list(spec.joint_names),
            joint_lookup=read_joint_lookup_csv(args.joint_lookup) if args.joint_lookup else None,
            max_frames=args.max_frames,
        )
        kind = "raw_video"
    else:
        from smilify_tpu_torch.cli.train_regressor import build_dataset

        cfg.dataset.data_path = args.data_path
        dataset, kind = build_dataset(cfg, spec)
    n = len(dataset) if args.max_frames is None else min(len(dataset), args.max_frames)
    print(f"inference over {n} frames ({kind}) on {dev}")

    is_mv = cfg.mode == "multi_view"
    predicts = [predictor(model, rcfg, spec, is_mv)]
    devices = [dev]
    if args.shard and dev.type == "cuda":
        for c in range(1, torch.cuda.device_count()):
            d = torch.device("cuda", c)
            predicts.append(predictor(copy.deepcopy(model).to(d), rcfg, spec.to(d), is_mv))
            devices.append(d)
        print(f"sharding inference batches over {len(devices)} card(s)")
    staging = StagingCollator()
    keys = input_names(is_mv)
    all_preds = []
    for i in range(0, n, args.batch_size):
        samples = [dataset[j] for j in range(i, min(n, i + args.batch_size))]
        host = staging([{k: s[k] for k in keys} for s in samples])
        if len(devices) == 1:
            all_preds.append({k: v.cpu().numpy() for k, v in predicts[0](
                staging.to_device(host, dev)).items()})
            continue
        # one share of the batch a card (the last shares may be short or empty)
        shares = [{k: v[c::len(devices)] for k, v in host.items()} for c in range(len(devices))]
        outs = [p({k: v.to(d) for k, v in share.items()})
                for p, d, share in zip(predicts, devices, shares) if len(share[keys[0]])]
        # the shares are strided: interleave them back into batch order
        all_preds.append({k: _interleave([o[k].cpu().numpy() for o in outs])
                          for k in outs[0]})
    traj = {k: np.concatenate([p[k] for p in all_preds]) for k in all_preds[0]}

    if args.smooth_window and args.smooth_window > 1:
        smoother = PredictionSmoother(args.smooth_window)
        smooth_keys = [k for k in ("global_rot", "joint_rot", "trans", "betas",
                                   "fov", "cam_rot", "cam_trans",
                                   "view_fov", "view_cam_rot", "view_cam_trans")
                       if k in traj]
        traj = smoother.smooth_params(traj, smooth_keys)
        print(f"smoothed {smooth_keys} with window {args.smooth_window}")

    if args.export_animation:
        rec = AnimationRecorder(model_name=os.path.basename(spec.source_path))
        for i in range(n):
            rec.add_frame(
                traj["global_rot"][i], traj["joint_rot"][i], traj["trans"][i],
                betas=traj["betas"][i],
                log_beta_scales=traj.get("log_beta_scales", [None] * n)[i],
                betas_trans=traj.get("betas_trans", [None] * n)[i],
            )
        print(f"animation → {rec.export(args.export_animation)}")

    if args.render_dir or args.video:
        render_dir = args.render_dir or os.path.join(
            os.path.dirname(discover_checkpoint(args.checkpoint)) or ".",
            cfg.output.visualizations_dir)
        frames, per_view = render_frames(spec, rcfg, traj, res, render_dir, is_mv)
        print(f"{len(frames)} frames rendered on {dev} → {render_dir}")
        if args.video:
            write_videos(args.video, frames, per_view)

    out_npz = os.path.join(os.path.dirname(args.checkpoint) or ".", "predictions.npz")
    np.savez(out_npz, **traj)
    print(f"predictions → {out_npz}")
    return traj


if __name__ == "__main__":
    main()
