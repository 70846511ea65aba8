"""SLEAP multi-camera session → multi-view HDF5 preprocessor CLI.

Equivalent of the reference
``python -m smal_fitter.sleap_data.preprocess_sleap_multiview_dataset``
(2043 LoC): discovers per-camera prediction files + videos in session
directories, loads the anipose calibration (per session, or a shared
--calibration fallback), synchronizes frames across cameras on the union of
annotated frame indices (a view without data at a frame is dropped via
view_mask — reference frame-sync grouping :235), maps SLEAP nodes → model
joints through joint_lookup.csv (:859), optionally replaces raw 2D with
``reprojections*.h5`` supervision, undistorts, crops (default / centred /
bbox_crop) with intrinsics adjustment, attaches triangulated 3D keypoints
(points3d.h5, outlier-filtered), and writes the shared multi-view HDF5
schema with a canonical camera order across sessions. Sessions run in
parallel workers.

Port of ``smilify_tpu/cli/preprocess_sleap_multiview.py``. It runs on the
host only (the model is read for its joint names and sizes). Video decode and undistortion need OpenCV; the HDF5
files are read and written by the port's codec (``utils/hdf5_io.py``).

Usage:
  python -m smilify_tpu_torch.cli.preprocess_sleap_multiview \
      --sessions <dir> [<dir> ...] --output out.h5 [--calibration cal.toml] \
      [--model pkl] [--joint-lookup map.csv] [--resolution 224]
      [--crop-mode bbox_crop] [--frame-skip 1] [--max-frames N]
      [--use-reprojections] [--workers N]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def collect_session_frames(session_dir, cams, joint_names=None, lookup=None,
                           max_frames=None, frame_skip=1, use_reprojections=False):
    """One session directory → list of synchronized frame dicts.

    Frames are synchronized on the union of annotated frame indices across
    cameras; a camera missing data (or an unreadable video frame) at an index
    simply contributes no view there (per-camera resilience → view_mask)."""
    from smilify_tpu_torch.data.sleap_raw import (
        SequentialVideoReader,
        find_session_layout,
        map_keypoints_to_model,
        read_sleap_predictions,
    )

    layout = find_session_layout(session_dir)
    cam_names = [c.name for c in cams]

    reproj = None
    if use_reprojections:
        cands = sorted(glob.glob(os.path.join(session_dir, "reprojections*.h5")))
        if cands:
            from smilify_tpu_torch.utils import hdf5_io

            with hdf5_io.File(cands[0], "r") as f:
                reproj = {k: f[k][:] for k in f.keys() if hasattr(f[k], "shape")}

    per_cam = {}
    for ci, cam in enumerate(cam_names):
        entry = layout.get(cam)
        if entry is None or "predictions" not in entry or "video" not in entry:
            continue
        try:
            pts, scores, nodes = read_sleap_predictions(entry["predictions"])
        except Exception as e:  # noqa: BLE001 — per-camera resilience
            print(f"warning: {session_dir}/{cam}: unreadable predictions: {e}")
            continue
        if reproj is not None:
            for key in (cam, f"reprojections_{cam}", str(ci)):
                if key in reproj and reproj[key].shape[:2] == pts.shape[:2]:
                    pts = np.asarray(reproj[key], np.float64)
                    break
        if joint_names is not None:
            pts, scores = map_keypoints_to_model(pts, scores, nodes,
                                                 list(joint_names), lookup)
        per_cam[cam] = {"points": pts, "scores": scores,
                        "reader": SequentialVideoReader(entry["video"])}
    if not per_cam:
        return []

    # union of annotated frames across cameras = the synchronized group index
    annotated = sorted(set().union(*[
        set(np.nonzero(np.isfinite(d["points"]).all(axis=-1).any(axis=1))[0].tolist())
        for d in per_cam.values()
    ]))
    annotated = annotated[::frame_skip]
    if max_frames:
        annotated = annotated[:max_frames]

    cal = {c.name: c for c in cams}
    frames = []
    for f_idx in annotated:
        frame = {"frame_idx": int(f_idx), "session_name": os.path.basename(session_dir)}
        for cam, d in per_cam.items():
            if f_idx >= d["points"].shape[0]:
                continue
            if not np.isfinite(d["points"][f_idx]).all(axis=-1).any():
                continue  # this camera has no data at this frame → view dropped
            img = d["reader"].read(int(f_idx))
            if img is None:
                continue  # unreadable frame → view dropped (view_mask=False)
            c = cal[cam]
            frame[cam] = {
                "image": img,
                "keypoints_xy": d["points"][f_idx],
                "scores": d["scores"][f_idx],
                "K": c.matrix,
                "dist": c.distortions,
                "R": c.R,
                "t": c.translation,
            }
        frames.append(frame)
    for d in per_cam.values():
        d["reader"].close()
    return frames


def process_one_session(job):
    """Worker: one session → preprocessed multi-view samples."""
    (sess, cal_path, canonical, opts) = job
    from smilify_tpu_torch.data.preprocess_multiview import preprocess_session_frames
    from smilify_tpu_torch.data.sleap import load_calibration_toml, read_points3d_h5

    sess_cal = os.path.join(sess, "calibration.toml")
    cams = load_calibration_toml(sess_cal if os.path.exists(sess_cal) else cal_path)

    frames = collect_session_frames(
        sess, cams, joint_names=opts["joint_names"], lookup=opts["lookup"],
        max_frames=opts["max_frames"], frame_skip=opts["frame_skip"],
        use_reprojections=opts["use_reprojections"],
    )

    p3d_path = opts["points3d"] or os.path.join(sess, "points3d.h5")
    if os.path.exists(p3d_path):
        points3d = read_points3d_h5(p3d_path)
        for fr in frames:
            fi = fr["frame_idx"]
            if fi < len(points3d):
                fr["keypoints_3d"] = np.nan_to_num(points3d[fi])

    samples = preprocess_session_frames(
        frames, canonical, opts["resolution"], opts["crop_mode"],
        undistort=opts["undistort"], min_views_per_sample=opts["min_views"],
    )
    print(f"{sess}: {len(frames)} frames → {len(samples)} samples")
    return samples


def main(argv=None):
    ap = argparse.ArgumentParser(description="SLEAP multi-view sessions → HDF5")
    ap.add_argument("--sessions", nargs="+", required=True)
    ap.add_argument("--calibration", default=None,
                    help="shared calibration.toml (fallback when a session has none)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--model", default=None, help="model pkl (joint order + n_pose/n_betas)")
    ap.add_argument("--joint-lookup", default=None, help="sleap→model joint-name CSV")
    ap.add_argument("--resolution", type=int, default=224)
    ap.add_argument("--crop-mode", default="default", choices=["default", "centred", "bbox_crop"])
    ap.add_argument("--no-undistort", action="store_true")
    ap.add_argument("--min-views", type=int, default=2)
    ap.add_argument("--frame-skip", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--use-reprojections", action="store_true")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--points3d", default=None, help="points3d.h5 override (else per-session)")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.data.hdf5_dataset import write_multiview_hdf5
    from smilify_tpu_torch.data.sleap import load_calibration_toml
    from smilify_tpu_torch.data.sleap_raw import read_joint_lookup_csv

    # canonical camera order comes from the first resolvable calibration
    first_cal = args.calibration
    if first_cal is None:
        for sess in args.sessions:
            p = os.path.join(sess, "calibration.toml")
            if os.path.exists(p):
                first_cal = p
                break
    if first_cal is None:
        raise SystemExit("no calibration.toml found in sessions and none given")
    canonical = sorted(c.name for c in load_calibration_toml(first_cal))
    print(f"canonical camera order: {canonical}")

    joint_names, n_pose, n_betas = None, 0, 0
    if args.model:
        from smilify_tpu_torch.core.spec import load_model_spec

        spec = load_model_spec(args.model, align_symmetry=False, device="cpu")  # joint names and sizes only
        joint_names = list(spec.joint_names)
        n_pose, n_betas = spec.n_joints - 1, spec.n_betas
    lookup = read_joint_lookup_csv(args.joint_lookup) if args.joint_lookup else None

    opts = {
        "joint_names": joint_names, "lookup": lookup,
        "max_frames": args.max_frames, "frame_skip": args.frame_skip,
        "use_reprojections": args.use_reprojections,
        "resolution": args.resolution, "crop_mode": args.crop_mode,
        "undistort": not args.no_undistort, "min_views": args.min_views,
        "points3d": args.points3d,
    }
    jobs = [(s, first_cal, canonical, opts) for s in args.sessions]
    if args.workers > 1 and len(jobs) > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=args.workers) as pool:
            results = list(pool.map(process_one_session, jobs))
    else:
        results = [process_one_session(j) for j in jobs]
    all_samples = [s for r in results for s in r]

    if not all_samples:
        raise SystemExit("no samples produced")
    K = all_samples[0]["keypoints_2d"].shape[1]
    write_multiview_hdf5(
        args.output, all_samples, max_views=len(canonical),
        target_resolution=args.resolution,
        canonical_camera_order=canonical, n_pose=n_pose or K - 1, n_betas=n_betas or 0,
        dataset_type="sleap_multiview",
        extra_metadata={"crop_mode": args.crop_mode,
                        "undistort_images": not args.no_undistort,
                        "use_reprojections": args.use_reprojections},
    )
    print(f"wrote {len(all_samples)} samples → {args.output}")


if __name__ == "__main__":
    main()
