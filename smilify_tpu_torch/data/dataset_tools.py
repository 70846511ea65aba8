"""Multi-view dataset tools: merge, filter, scale-match (port of
``smilify_tpu/data/dataset_tools.py``).

Equivalents of the reference ``smal_fitter/multiview_common/
{merge_multiview_datasets, filter_multiview_dataset, match_scale_multiview_dataset}.py``
operating on the shared multi-view HDF5 schema:
  * :func:`merge_multiview_datasets` — concatenate SLEAP+replicAnt HDF5s into
    one uniform-convention file (view padding to the widest max_views);
  * :func:`filter_multiview_dataset` — drop views/samples failing supervision
    quality (min visible keypoints, behind-camera 3D joints, min views);
  * :func:`match_scale_multiview_dataset` — estimate and apply the world-scale
    factor between two datasets from median camera distances (the reference's
    ~27× unit-mismatch correction).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from smilify_tpu_torch.utils import hdf5_io


def _read_all(path: str):
    out = {}
    with hdf5_io.File(path, "r") as f:
        out["meta"] = {k: (v.item() if hasattr(v, "item") else v) for k, v in f["metadata"].attrs.items()}
        V = int(out["meta"]["max_views"])
        N = int(out["meta"]["num_samples"])
        out["images"] = [[bytes(f[f"multiview_images/image_jpeg_view_{v}"][i]) for v in range(V)] for i in range(N)]
        g = f["multiview_keypoints"]
        out["view_mask"] = f["multiview_images/view_mask"][:]
        for k in ("keypoints_2d", "keypoint_visibility", "camera_indices", "camera_intrinsics",
                  "camera_extrinsics_R", "camera_extrinsics_t", "image_sizes", "keypoints_3d"):
            out[k] = g[k][:]
        out["has_3d_data"] = f["auxiliary/has_3d_data"][:]
        for k in ("global_rot", "joint_rot", "betas", "trans"):
            out[k] = f[f"parameters/{k}"][:]
        out["has_ground_truth_betas"] = f["auxiliary/has_ground_truth_betas"][:]
        out["frame_idx"] = f["auxiliary/frame_idx"][:]
        out["session_name"] = [s.decode() for s in f["auxiliary/session_name"][:]]
    return out


def _write_all(path: str, d: dict, dataset_type: str = "merged_multiview"):
    import json

    N = len(d["images"])
    V = d["view_mask"].shape[1]
    with hdf5_io.File(path, "w") as f:
        gi = f.create_group("multiview_images")
        gk = f.create_group("multiview_keypoints")
        gp = f.create_group("parameters")
        ga = f.create_group("auxiliary")
        gm = f.create_group("metadata")
        dt = hdf5_io.vlen_dtype(np.uint8)
        for v in range(V):
            ds = gi.create_dataset(f"image_jpeg_view_{v}", shape=(N,), dtype=dt)
            for i in range(N):
                buf = d["images"][i][v] if v < len(d["images"][i]) else b""
                ds[i] = np.frombuffer(buf, dtype=np.uint8)
        gi.create_dataset("view_mask", data=d["view_mask"])
        for k in ("keypoints_2d", "keypoint_visibility", "camera_indices", "camera_intrinsics",
                  "camera_extrinsics_R", "camera_extrinsics_t", "image_sizes", "keypoints_3d"):
            gk.create_dataset(k, data=d[k])
        ga.create_dataset("has_3d_data", data=d["has_3d_data"])
        for k in ("global_rot", "joint_rot", "betas", "trans"):
            gp.create_dataset(k, data=d[k])
        ga.create_dataset("has_ground_truth_betas", data=d["has_ground_truth_betas"])
        ga.create_dataset("frame_idx", data=d["frame_idx"])
        ga.create_dataset("session_name", data=[s.encode() for s in d["session_name"]])
        ga.create_dataset("num_views", data=d["view_mask"].sum(axis=1).astype(np.int64))
        ga.create_dataset("camera_names", data=[b""] * N)
        meta = dict(d["meta"])
        meta.update(num_samples=N, max_views=V, dataset_type=dataset_type, is_multiview=True)
        for k, v in meta.items():
            try:
                gm.attrs[k] = v
            except TypeError:
                gm.attrs[k] = json.dumps(v)


def merge_multiview_datasets(paths: List[str], out_path: str, scale_factors: Optional[List[float]] = None):
    """Concatenate multi-view HDF5 datasets (padding to the widest max_views)."""
    parts = [_read_all(p) for p in paths]
    scale_factors = scale_factors or [1.0] * len(parts)
    V = max(p["view_mask"].shape[1] for p in parts)
    K = parts[0]["keypoints_2d"].shape[2]

    def pad_views(arr, V):
        pad = V - arr.shape[1]
        if pad <= 0:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[1] = (0, pad)
        return np.pad(arr, widths)

    merged = {"images": [], "session_name": [], "meta": parts[0]["meta"]}
    for key in ("view_mask", "keypoints_2d", "keypoint_visibility", "camera_indices",
                "camera_intrinsics", "camera_extrinsics_R", "camera_extrinsics_t",
                "image_sizes", "keypoints_3d", "has_3d_data", "global_rot", "joint_rot",
                "betas", "trans", "has_ground_truth_betas", "frame_idx"):
        arrays = []
        for p, s in zip(parts, scale_factors):
            a = p[key]
            if key in ("camera_extrinsics_t", "keypoints_3d", "trans"):
                a = a * s
            if a.ndim >= 2 and key in ("view_mask", "keypoints_2d", "keypoint_visibility",
                                       "camera_indices", "camera_intrinsics",
                                       "camera_extrinsics_R", "camera_extrinsics_t", "image_sizes"):
                a = pad_views(a, V)
            arrays.append(a)
        merged[key] = np.concatenate(arrays, axis=0)
    for p in parts:
        merged["images"].extend(p["images"])
        merged["session_name"].extend(p["session_name"])
    _write_all(out_path, merged)
    return out_path


def filter_multiview_dataset(
    path: str,
    out_path: str,
    min_visible_keypoints: int = 5,
    min_views: int = 2,
    drop_behind_camera: bool = True,
):
    """Supervision-quality filtering: invalidate low-visibility views (mask off,
    not dropped), drop samples with too few surviving views; optionally
    invalidate views where the 3D joints fall behind the camera."""
    d = _read_all(path)
    N, V = d["view_mask"].shape
    vm = d["view_mask"].copy()
    stats = {"views_masked": 0, "samples_dropped": 0}
    for i in range(N):
        for v in range(V):
            if not vm[i, v]:
                continue
            vis = (d["keypoint_visibility"][i, v] > 0).sum()
            if vis < min_visible_keypoints:
                vm[i, v] = False
                stats["views_masked"] += 1
                continue
            if drop_behind_camera and d["has_3d_data"][i]:
                R = d["camera_extrinsics_R"][i, v]
                t = d["camera_extrinsics_t"][i, v]
                kp = d["keypoints_3d"][i]
                nz = ~np.all(kp == 0, axis=1)
                if nz.any():
                    z = (kp[nz] @ R.T + t)[:, 2]
                    if (z <= 0).any():
                        vm[i, v] = False
                        stats["views_masked"] += 1
    keep = vm.sum(axis=1) >= min_views
    stats["samples_dropped"] = int((~keep).sum())
    d["view_mask"] = vm
    for key in list(d):
        if key in ("meta",):
            continue
        if key in ("images", "session_name"):
            d[key] = [x for x, k in zip(d[key], keep) if k]
        elif isinstance(d[key], np.ndarray) and d[key].shape[:1] == (N,):
            d[key] = d[key][keep]
    _write_all(out_path, d)
    return out_path, stats


def estimate_world_scale_ratio(path_a: str, path_b: str) -> float:
    """Median camera-distance ratio between datasets (the reference's ~27×
    cross-domain unit mismatch, match_scale_multiview_dataset.py)."""
    def med(path):
        d = _read_all(path)
        t = d["camera_extrinsics_t"][d["view_mask"]]
        return float(np.median(np.linalg.norm(t, axis=-1)))

    return med(path_a) / max(med(path_b), 1e-12)


def match_scale_multiview_dataset(path: str, out_path: str, scale: float):
    """Apply a world-scale factor to metric quantities of a dataset."""
    d = _read_all(path)
    for key in ("camera_extrinsics_t", "keypoints_3d", "trans"):
        d[key] = d[key] * scale
    _write_all(out_path, d)
    return out_path
