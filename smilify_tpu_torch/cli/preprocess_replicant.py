"""replicAnt → optimized single-view HDF5 preprocessor CLI.

Equivalent of the reference ``neuralSMIL/dataset_preprocessing.py`` /
``preprocess_dataset.py`` (and the "10-12× faster data loading" optimized
format, neuralSMIL/README.md:309): resizes/encodes frames as JPEG, stores
keypoints, visibility, SMIL parameters, and silhouettes in the shared HDF5
schema. Frames that fail to load are skipped and recorded
(skipped_frame_indices metadata, the reference's per-frame resilience).

Port of ``smilify_tpu/cli/preprocess_replicant.py``. It runs on the host
only (the model is read for its joint order); the HDF5 output is written by
the port's codec (``utils/hdf5_io.py``), the JPEG images through OpenCV.

Usage:
  python -m smilify_tpu_torch.cli.preprocess_replicant --input <raw_dir> \
      --output out.h5 --model <pkl> [--resolution 224] [--workers N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np



def _load_one(args_tuple):
    idx, json_path, joint_names, resolution = args_tuple
    try:
        import cv2

        from smilify_tpu_torch.data.replicant import load_smil_unreal_sample

        x, y = load_smil_unreal_sample(json_path, joint_names)
        img = x["input_image_data"]
        if img is None:
            return idx, None
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        img = img[..., :3]
        if img.shape[0] != resolution:
            img = cv2.resize(img, (resolution, resolution))
        sample = {
            "image": img.astype(np.uint8),
            "keypoints_2d": y["keypoints_2d"].astype(np.float32),
            "keypoint_visibility": y["keypoint_visibility"].astype(np.float32),
            "global_rot": y["root_rot"].astype(np.float32),
            "joint_rot": y["joint_angles"][1:].astype(np.float32),
            "betas": y["shape_betas"].astype(np.float32),
            "trans": y["root_loc"].astype(np.float32),
            "fov": np.asarray(y["cam_fov"][0], np.float32),
            "cam_rot": y["cam_rot"].astype(np.float32),
            "cam_trans": y["cam_trans"].astype(np.float32),
        }
        if x["input_image_mask"] is not None:
            m = (x["input_image_mask"] > 0).astype(np.float32)
            if m.shape[0] != resolution:
                m = cv2.resize(m, (resolution, resolution), interpolation=cv2.INTER_NEAREST)
            sample["silhouette"] = m
        return idx, sample
    except Exception as exc:  # per-frame resilience
        return idx, f"{type(exc).__name__}: {exc}"


def main(argv=None):
    ap = argparse.ArgumentParser(description="replicAnt raw → optimized HDF5")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--model", required=True, help="SMIL model .pkl (joint order)")
    ap.add_argument("--resolution", type=int, default=224)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--jpeg-quality", type=int, default=90)
    args = ap.parse_args(argv)

    import glob

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data.hdf5_dataset import write_singleview_hdf5

    spec = load_model_spec(args.model, align_symmetry=False, device="cpu")  # joint order only
    json_paths = sorted(
        p for p in glob.glob(os.path.join(args.input, "*.json"))
        if not os.path.basename(p).startswith("_BatchData_")
    )
    print(f"{len(json_paths)} frames")

    jobs = [(i, p, spec.joint_names, args.resolution) for i, p in enumerate(json_paths)]
    if args.workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=args.workers) as pool:
            results = list(pool.map(_load_one, jobs))
    else:
        results = [_load_one(j) for j in jobs]

    samples, skipped = [], []
    for idx, res in sorted(results, key=lambda r: r[0]):
        if isinstance(res, dict):
            samples.append(res)
        else:
            skipped.append((idx, res))
            print(f"  skipped frame {idx}: {res}")
    if not samples:
        raise SystemExit("no frames loaded")

    write_singleview_hdf5(
        args.output, samples, args.resolution,
        n_pose=spec.n_joints - 1, n_betas=samples[0]["betas"].shape[0],
        dataset_type="optimized_hdf5", jpeg_quality=args.jpeg_quality,
        extra_metadata={"skipped_frame_indices": [i for i, _ in skipped],
                        "source": os.path.abspath(args.input)},
    )
    print(f"wrote {len(samples)} samples → {args.output} ({len(skipped)} skipped)")


if __name__ == "__main__":
    main()
