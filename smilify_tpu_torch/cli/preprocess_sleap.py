"""Single-view SLEAP session → optimized HDF5 preprocessor.

Equivalent of the reference ``sleap_data/preprocess_sleap_dataset.py`` (1829
LoC) + ``optimized_sleap_preprocessor.py`` (worker pool): every annotated
frame of every camera of every session becomes one single-view training
sample. Per frame: read the video frame (sequential fast path), optionally
undistort with the session calibration, map SLEAP nodes → model joints
(joint_lookup.csv or name match), optionally replace raw 2D predictions with
``reprojections*.h5`` supervision (--use-reprojections), confidence-threshold
visibility, crop (default / centred / bbox_crop with intrinsics update),
JPEG-encode — written with the single-view schema that
``SingleViewHDF5Dataset`` and ``cli.train_regressor`` consume. When a
calibration exists, GT camera parameters (fov / cam_rot / cam_trans in
renderer convention) and per-frame 3D keypoints from ``points3d.h5`` are
stored too.

Sessions are processed in parallel (ProcessPoolExecutor) with per-frame and
per-camera skip resilience + a statistics report, like the reference.

Port of ``smilify_tpu/cli/preprocess_sleap.py``. It runs on the host only
(the model is read for its joint names and sizes). Video decode and undistortion need OpenCV; the HDF5
files are read and written by the port's codec (``utils/hdf5_io.py``).

Usage:
  python -m smilify_tpu_torch.cli.preprocess_sleap SESSIONS_DIR OUT.h5 \
      --model SMIL.pkl [--crop-mode bbox_crop] [--target-resolution 224]
      [--num-workers 4] [--use-reprojections] [--joint-lookup map.csv]
      [--shape-betas betas.csv] [--confidence-threshold 0.5]
      [--max-frames-per-video N] [--validate]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

import numpy as np


def discover_sessions(sessions_dir: str) -> List[str]:
    """Subdirectories that look like SLEAP sessions (calibration.toml,
    points3d.h5, or prediction files anywhere below); the directory itself
    when it already is one."""
    def is_session(d):
        if os.path.exists(os.path.join(d, "calibration.toml")):
            return True
        if os.path.exists(os.path.join(d, "points3d.h5")):
            return True
        for root, _dirs, files in os.walk(d):
            if any(f.endswith((".slp", ".h5")) and "points3d" not in f for f in files):
                return True
        return False

    subs = sorted(
        os.path.join(sessions_dir, d)
        for d in os.listdir(sessions_dir)
        if os.path.isdir(os.path.join(sessions_dir, d)) and not d.startswith(".")
    )
    sessions = [d for d in subs if is_session(d)]
    if not sessions and is_session(sessions_dir):
        sessions = [sessions_dir]
    return sessions


def read_shape_betas_csv(path: str) -> Dict[str, np.ndarray]:
    """``session_name,b0,b1,...`` CSV → betas per session (reference
    shape_betas_table)."""
    import csv

    out = {}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or not row[0].strip():
                continue
            try:
                out[row[0].strip()] = np.asarray([float(x) for x in row[1:]], np.float32)
            except ValueError:
                continue  # header
    return out


def _camera_params_renderer(cal, image_size):
    """OpenCV calibration → stored GT camera params (fov scalar, flattened
    row-convention R (9,), t (3,)) — numpy twin of the renderer conversion
    (no device work inside preprocessing worker processes)."""
    from smilify_tpu_torch.data.canonical_frame import camera_from_opencv_np

    Rr, T, fov, _aspect = camera_from_opencv_np(cal.R, cal.translation, cal.matrix, image_size)
    return np.float32(fov), np.asarray(Rr, np.float32).reshape(-1), np.asarray(T, np.float32)


def process_session(job) -> Dict:
    """One session → list of sample dicts (runs inside a worker process)."""
    (session_dir, joint_names, lookup, betas_table, opts) = job
    from smilify_tpu_torch.data.preprocess_multiview import crop_and_resize, undistort_view
    from smilify_tpu_torch.data.sleap import load_calibration_toml, read_points3d_h5
    from smilify_tpu_torch.data.sleap_raw import (
        SequentialVideoReader,
        find_session_layout,
        map_keypoints_to_model,
        read_sleap_predictions,
    )

    session_name = os.path.basename(os.path.normpath(session_dir))
    stats = {"frames": 0, "skipped": 0, "cameras": 0, "cameras_failed": 0}
    samples: List[Dict] = []

    cams_by_name = {}
    cal_path = os.path.join(session_dir, "calibration.toml")
    if os.path.exists(cal_path):
        try:
            cams_by_name = {c.name: c for c in load_calibration_toml(cal_path)}
        except Exception as e:  # noqa: BLE001 — per-session resilience
            print(f"warning: bad calibration in {session_name}: {e}")

    points3d = None
    p3d_path = os.path.join(session_dir, "points3d.h5")
    if os.path.exists(p3d_path):
        try:
            points3d = read_points3d_h5(p3d_path)  # (F, K3, 3) in SLEAP node order
        except Exception as e:  # noqa: BLE001
            print(f"warning: bad points3d in {session_name}: {e}")

    reproj = None
    if opts["use_reprojections"]:
        cands = sorted(glob.glob(os.path.join(session_dir, "reprojections*.h5")))
        if cands:
            from smilify_tpu_torch.utils import hdf5_io

            with hdf5_io.File(cands[0], "r") as f:
                reproj = {k: f[k][:] for k in f.keys() if hasattr(f[k], "shape")}

    layout = find_session_layout(session_dir)
    betas = None
    for key in (session_name, os.path.basename(session_dir)):
        if betas_table and key in betas_table:
            betas = betas_table[key]
            break

    for ci, (cam_name, entry) in enumerate(sorted(layout.items())):
        if "predictions" not in entry or "video" not in entry:
            continue
        stats["cameras"] += 1
        try:
            pts, scores, node_names = read_sleap_predictions(entry["predictions"])
        except Exception as e:  # noqa: BLE001
            print(f"warning: {session_name}/{cam_name}: unreadable predictions: {e}")
            stats["cameras_failed"] += 1
            continue

        # reprojection supervision replaces the raw 2D predictions when a
        # matching dataset exists (reference --use_reprojections)
        if reproj is not None:
            for key in (cam_name, f"reprojections_{cam_name}", str(ci)):
                if key in reproj and reproj[key].shape[:2] == pts.shape[:2]:
                    pts = np.asarray(reproj[key], np.float64)
                    break

        kp, sc = map_keypoints_to_model(pts, scores, node_names, joint_names, lookup)

        cal = cams_by_name.get(cam_name)
        # a frame is annotated when any mapped node has a prediction; low
        # confidence marks keypoints invisible rather than dropping frames
        # (downstream sample-validity filtering decides what to train on)
        annotated = np.nonzero(np.isfinite(kp).all(axis=-1).any(axis=1))[0]
        if opts["max_frames_per_video"]:
            annotated = annotated[: opts["max_frames_per_video"]]

        with SequentialVideoReader(entry["video"]) as reader:
            for fi in annotated:
                try:
                    frame = reader.read(int(fi))
                    if frame is None:
                        stats["skipped"] += 1
                        continue
                    kpf, scf = kp[fi].copy(), sc[fi].copy()
                    H, W = frame.shape[:2]
                    K = (cal.matrix if cal is not None else
                         np.array([[max(H, W), 0, W / 2], [0, max(H, W), H / 2], [0, 0, 1.0]]))
                    if cal is not None and np.any(cal.distortions):
                        frame, kpf = undistort_view(frame, kpf, K, cal.distortions)
                    res = crop_and_resize(frame, kpf, K, opts["target_resolution"],
                                          opts["crop_mode"])
                    R = opts["target_resolution"]
                    inb = (
                        np.isfinite(res.keypoints).all(axis=1)
                        & (res.keypoints[:, 0] >= 0) & (res.keypoints[:, 0] < R)
                        & (res.keypoints[:, 1] >= 0) & (res.keypoints[:, 1] < R)
                    )
                    vis = ((scf >= opts["confidence_threshold"]) & inb).astype(np.float32)
                    img_u8 = (np.clip(res.image, 0, 1) * 255).astype(np.uint8)
                    sample = {
                        "image": img_u8,
                        "keypoints_2d": np.nan_to_num(res.keypoints).astype(np.float32),
                        "keypoint_visibility": vis,
                        "session_name": session_name,
                        "camera_name": cam_name,
                        "frame_idx": int(fi),
                    }
                    if betas is not None:
                        sample["betas"] = betas
                    if cal is not None:
                        fov, cam_rot, cam_trans = _camera_params_renderer(cal, (H, W))
                        sample["fov"] = np.asarray([fov], np.float32)
                        sample["cam_rot"] = cam_rot
                        sample["cam_trans"] = cam_trans
                    if points3d is not None and fi < len(points3d):
                        sample["keypoints_3d_sleap"] = np.nan_to_num(
                            points3d[fi].astype(np.float32))
                    samples.append(sample)
                    stats["frames"] += 1
                except Exception as e:  # noqa: BLE001 — per-frame resilience
                    stats["skipped"] += 1
                    if stats["skipped"] <= 5:
                        print(f"warning: {session_name}/{cam_name} frame {fi}: {e}")
    return {"samples": samples, "stats": stats, "session": session_name}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sessions_dir")
    ap.add_argument("output")
    ap.add_argument("--model", required=True, help="SMIL model .pkl (joint names/schema)")
    ap.add_argument("--target-resolution", type=int, default=224)
    ap.add_argument("--crop-mode", choices=["default", "centred", "bbox_crop"],
                    default="default")
    ap.add_argument("--jpeg-quality", type=int, default=95)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--confidence-threshold", type=float, default=0.5)
    ap.add_argument("--max-frames-per-video", type=int, default=None)
    ap.add_argument("--use-reprojections", action="store_true")
    ap.add_argument("--joint-lookup", default=None, help="sleap→model joint-name CSV")
    ap.add_argument("--shape-betas", default=None, help="session→betas CSV")
    ap.add_argument("--validate", action="store_true")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data.hdf5_dataset import write_singleview_hdf5
    from smilify_tpu_torch.data.sleap_raw import read_joint_lookup_csv

    spec = load_model_spec(args.model, align_symmetry=False, device="cpu")  # joint names and sizes only
    lookup = read_joint_lookup_csv(args.joint_lookup) if args.joint_lookup else None
    betas_table = read_shape_betas_csv(args.shape_betas) if args.shape_betas else None

    sessions = discover_sessions(args.sessions_dir)
    if not sessions:
        raise SystemExit(f"no SLEAP sessions under {args.sessions_dir}")
    print(f"{len(sessions)} session(s): {[os.path.basename(s) for s in sessions]}")

    opts = {
        "target_resolution": args.target_resolution,
        "crop_mode": args.crop_mode,
        "confidence_threshold": args.confidence_threshold,
        "max_frames_per_video": args.max_frames_per_video,
        "use_reprojections": args.use_reprojections,
    }
    jobs = [(s, list(spec.joint_names), lookup, betas_table, opts) for s in sessions]

    if args.num_workers > 1 and len(jobs) > 1:
        with ProcessPoolExecutor(max_workers=args.num_workers) as pool:
            results = list(pool.map(process_session, jobs))
    else:
        results = [process_session(j) for j in jobs]

    samples = [s for r in results for s in r["samples"]]
    totals = {"frames": 0, "skipped": 0, "cameras": 0, "cameras_failed": 0}
    for r in results:
        for k in totals:
            totals[k] += r["stats"][k]
    print(f"processed {totals['frames']} samples "
          f"({totals['skipped']} skipped frames, "
          f"{totals['cameras_failed']}/{totals['cameras']} cameras failed)")
    if not samples:
        raise SystemExit("no samples produced")

    write_singleview_hdf5(
        args.output, samples,
        target_resolution=args.target_resolution,
        n_pose=(spec.n_joints - 1) * 3,
        n_betas=spec.n_betas,
        dataset_type="sleap_singleview",
        jpeg_quality=args.jpeg_quality,
    )
    meta = {
        "sessions": [r["session"] for r in results],
        "stats": totals,
        "crop_mode": args.crop_mode,
        "confidence_threshold": args.confidence_threshold,
        "use_reprojections": args.use_reprojections,
    }
    with open(args.output + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {len(samples)} samples → {args.output}")

    if args.validate:
        from smilify_tpu_torch.data.hdf5_dataset import SingleViewHDF5Dataset

        ds = SingleViewHDF5Dataset(args.output)
        s0 = ds[0]
        assert s0["image"].shape == (args.target_resolution, args.target_resolution, 3)
        assert s0["keypoints_2d"].shape == (spec.n_joints, 2)
        print(f"validated: {len(ds)} samples, keys={sorted(s0)}")


if __name__ == "__main__":
    main()
