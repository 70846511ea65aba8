"""Render a fitted parameter sequence to video (port of
``smilify_tpu/cli/generate_video.py``).

Loads the per-frame parameter pkls that the fitter's ``ImageExporter``
writes (``<checkpoint-dir>/<frame>/st{S}_ep{E}.pkl``), poses the model for
every frame in one batched SMIL forward, renders the Phong frames on the
device RENDER_CHUNK at a time (one host fetch a chunk) and writes a video
(``utils/export.py::write_video``). ``--collage`` assembles the exported
``st{S}_ep{E}.png`` collages instead, read with the port's PNG reader (the
card's machine has no imageio); that mode runs on the host alone.

Usage:
  python -m smilify_tpu_torch.cli.generate_video --checkpoint-dir checkpoints/run \\
      --model <pkl> --epoch-name st10_ep0 --output out.mp4 [--fps 15] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device

RENDER_CHUNK = 8   # frames rendered between two host fetches


def frame_dirs(checkpoint_dir: str):
    """The per-frame directories of a fitter run, sorted by name."""
    return sorted(d for d in glob.glob(os.path.join(checkpoint_dir, "*")) if os.path.isdir(d))


def read_frame_params(dirs, epoch_name: str):
    """The ``{epoch_name}.pkl`` parameter dicts of the directories that have one."""
    out = []
    for d in dirs:
        path = os.path.join(d, f"{epoch_name}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out.append(pickle.load(f))
    return out


def _per_frame(params, key, dev):
    """(N, J, 3) of ``key`` where every frame has it as a (J, 3) array; None
    where none has; zeros for the frames without it otherwise (zero log
    scales and joint offsets pose as the JAX CLI's None does)."""
    have = [p.get(key) is not None and np.asarray(p[key]).ndim == 2 for p in params]
    if not any(have):
        return None
    shape = next(np.asarray(p[key]).shape for p, h in zip(params, have) if h)
    arr = np.stack([np.asarray(p[key], np.float32) if h else np.zeros(shape, np.float32)
                    for p, h in zip(params, have)])
    return torch.as_tensor(arr, device=dev)


@torch.no_grad()
def frame_geometry(spec, params):
    """Every frame of ``params`` posed and seen by the default camera with
    the frame's fov, on the spec's device: world vertices (N, V, 3), view
    vertices (N, V, 3) and NDC x, y with view depth (N, V, 3)."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.render.cameras import default_camera

    dev = spec.device
    betas = torch.as_tensor(np.stack([np.asarray(p["betas"], np.float32) for p in params]),
                            device=dev)
    theta = torch.as_tensor(np.stack([np.concatenate(
        [np.asarray(p["global_rotation"])[None], np.asarray(p["joint_rotations"]).reshape(-1, 3)],
        axis=0).astype(np.float32) for p in params]), device=dev)
    trans = torch.as_tensor(np.stack([np.asarray(p["trans"], np.float32) for p in params]),
                            device=dev)
    out = smil_forward(spec, betas, theta, log_scales=_per_frame(params, "log_betascale", dev),
                       joint_trans=_per_frame(params, "betas_trans", dev))
    verts = out.verts + trans[:, None]
    views, ndcs = [], []
    for i, p in enumerate(params):
        fov = float(np.atleast_1d(p.get("fov", 60.0))[0])
        cam = default_camera(device=dev).replace(
            fov=torch.tensor(fov, dtype=torch.float32, device=dev))
        pv = cam.world_to_view(verts[i])
        views.append(pv)
        ndcs.append(torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1))
    return verts, torch.stack(views), torch.stack(ndcs)


@torch.no_grad()
def render_sequence(spec, params, size: int):
    """The frames of ``params`` as (size, size, 3) uint8 Phong renders."""
    from smilify_tpu_torch.render.phong import render_phong

    verts, views, ndcs = frame_geometry(spec, params)
    frames = []
    for lo in range(0, len(params), RENDER_CHUNK):
        chunk = [(render_phong(verts[i], views[i], ndcs[i], spec.faces, (size, size)) * 255)
                 .to(torch.uint8) for i in range(lo, min(lo + RENDER_CHUNK, len(params)))]
        frames.extend(torch.stack(chunk).cpu().numpy())
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render fitted sequences to video")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--epoch-name", default="st10_ep0",
                    help="which stage/epoch files to use (reference EPOCH_NAME)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--collage", action="store_true",
                    help="assemble the exported collage pngs instead of re-rendering (host only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.utils.export import write_video

    out_path = args.output or os.path.join(args.checkpoint_dir, f"{args.epoch_name}.mp4")
    dirs = frame_dirs(args.checkpoint_dir)
    if not dirs:
        raise SystemExit(f"no frame directories in {args.checkpoint_dir}")

    if args.collage:
        from smilify_tpu_torch.utils.image_io import read_png

        frames = [read_png(png) for png in (os.path.join(d, f"{args.epoch_name}.png")
                                            for d in dirs) if os.path.exists(png)]
        if not frames:
            raise SystemExit(f"no {args.epoch_name}.png files found")
        write_video(out_path, frames, fps=args.fps)
        print(f"video ({len(frames)} collage frames) → {out_path}")
        return out_path

    from smilify_tpu_torch.core.spec import load_model_spec

    dev = resolve_device(args.device)
    params = read_frame_params(dirs, args.epoch_name)
    if not params:
        raise SystemExit(f"no {args.epoch_name}.pkl files found")
    spec = load_model_spec(args.model, align_symmetry=False, device=dev)
    frames = render_sequence(spec, params, args.size)
    write_video(out_path, frames, fps=args.fps)
    print(f"video ({len(frames)} rendered frames) → {out_path}")
    return out_path


if __name__ == "__main__":
    main()
