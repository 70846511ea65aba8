"""replicAnt multi-camera trial → multi-view HDF5 preprocessor CLI.

Equivalent of the reference
``replicAnt_data/preprocess_replicant_multiview_dataset.py:270-895``:
synchronized multi-camera Unreal frames → the SAME HDF5 schema as the SLEAP
multi-view preprocessor (byte-equivalent round-trip contract,
docs/design/multiview_replicant_integration.md). Cameras are stored in the
canonical-camera frame (lowest camera id → R=I, t=0) via
``data.canonical_frame.canonicalize_sample``; per-camera failures degrade to
``view_mask=False`` instead of dropping the frame.

Expected layout: <trial>/<camera_name>/ each a standard replicAnt frame dir
(frame JSONs + JPGs + _BatchData_), frames synchronized by iteration index.

Port of ``smilify_tpu/cli/preprocess_replicant_multiview.py``. It runs on
the host only (the model is read for its joint order and sizes); the HDF5
output is written by the port's codec (``utils/hdf5_io.py``), the JPEG
images through OpenCV.

Usage:
  python -m smilify_tpu_torch.cli.preprocess_replicant_multiview --input <trial_dir> \
      --output out.h5 --model <pkl> [--resolution 224] [--crop-mode default]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="replicAnt multi-camera trial → multi-view HDF5")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--resolution", type=int, default=224)
    ap.add_argument("--crop-mode", default="default", choices=["default", "centred", "bbox_crop"])
    ap.add_argument("--min-views", type=int, default=2)
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data.canonical_frame import canonicalize_sample
    from smilify_tpu_torch.data.hdf5_dataset import write_multiview_hdf5
    from smilify_tpu_torch.data.preprocess_multiview import preprocess_session_frames
    from smilify_tpu_torch.data.replicant import load_smil_unreal_sample, parse_camera_intrinsics

    spec = load_model_spec(args.model, align_symmetry=False, device="cpu")  # joint order and sizes only

    cam_dirs = sorted(
        d for d in glob.glob(os.path.join(args.input, "*")) if os.path.isdir(d)
    )
    if not cam_dirs:
        raise SystemExit(f"no camera subdirectories in {args.input} "
                         "(expected <trial>/<camera>/frame jsons)")
    cam_names = [os.path.basename(d) for d in cam_dirs]
    print(f"cameras: {cam_names}")

    # index frames per camera by iteration id (filename suffix)
    per_cam = {}
    for cam, d in zip(cam_names, cam_dirs):
        frames = {}
        for p in glob.glob(os.path.join(d, "*.json")):
            base = os.path.basename(p)
            if base.startswith("_BatchData_"):
                continue
            idx = int(os.path.splitext(base)[0].rsplit("_", 1)[-1])
            frames[idx] = p
        per_cam[cam] = frames

    common = sorted(set.union(*(set(f) for f in per_cam.values())))
    if args.max_frames:
        common = common[: args.max_frames]

    frame_dicts = []
    for f_idx in common:
        frame = {"frame_idx": f_idx, "session_name": os.path.basename(args.input)}
        kp3d_world = None
        for cam in cam_names:
            jp = per_cam[cam].get(f_idx)
            if jp is None:
                continue  # per-camera resilience
            try:
                x, y = load_smil_unreal_sample(jp, spec.joint_names)
            except Exception as exc:
                print(f"  frame {f_idx} cam {cam}: skipped ({type(exc).__name__})")
                continue
            img = x["input_image_data"]
            if img is None:
                continue
            H, W = img.shape[:2]
            f = y["fx"]
            K = np.array([[f, 0, y["cx"]], [0, y["fy"], y["cy"]], [0, 0, 1.0]])
            # our cam_rot is row-vector p3d convention; convert to OpenCV
            # column-vector (x right, y down): R_cv = diag(-1,-1,1) @ R_p3dᵀ
            Rz = np.diag([-1.0, -1.0, 1.0])
            R_cv = Rz @ y["cam_rot"].T
            t_cv = Rz @ y["cam_trans"]
            kp_xy = y["keypoints_2d"][:, ::-1] * [W, H]  # normalized (y,x) → pixel (x,y)
            frame[cam] = {
                "image": img[..., :3],
                "keypoints_xy": kp_xy,
                "scores": y["keypoint_visibility"],
                "K": K,
                "dist": None,
                "R": R_cv,
                "t": t_cv,
            }
            if kp3d_world is None:
                kp3d_world = y["keypoints_3d"]
        if kp3d_world is not None:
            frame["keypoints_3d"] = kp3d_world
        frame_dicts.append(frame)

    samples = preprocess_session_frames(
        frame_dicts, cam_names, args.resolution, args.crop_mode,
        undistort=False, min_views_per_sample=args.min_views,
    )

    # canonical-camera-frame storage (lowest camera id → identity)
    for s in samples:
        nv = len(s["images"])
        mask = np.ones(nv, bool)
        kp3d = s.get("keypoints_3d")
        R_new, t_new, kp3d_new, R0, t0, _ = canonicalize_sample(
            s["camera_extrinsics_R"], s["camera_extrinsics_t"],
            kp3d if kp3d is not None else np.zeros((1, 3)), mask,
        )
        s["camera_extrinsics_R"] = R_new.astype(np.float32)
        s["camera_extrinsics_t"] = t_new.astype(np.float32)
        if kp3d is not None:
            s["keypoints_3d"] = kp3d_new.astype(np.float32)

    if not samples:
        raise SystemExit("no samples produced")
    write_multiview_hdf5(
        args.output, samples, max_views=len(cam_names), target_resolution=args.resolution,
        canonical_camera_order=cam_names, n_pose=spec.n_joints - 1, n_betas=spec.n_betas,
        dataset_type="replicant_multiview",
        extra_metadata={"crop_mode": args.crop_mode, "frame_convention": "camera_canonical"},
    )
    print(f"wrote {len(samples)} samples → {args.output}")


if __name__ == "__main__":
    main()
