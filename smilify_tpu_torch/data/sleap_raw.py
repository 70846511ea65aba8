"""Raw SLEAP session reading — host-side numpy (no sleap package; port of
``smilify_tpu/data/sleap_raw.py``).

Equivalent of the reference root ``sleap_data_loader.py``: read 2D pose
predictions from SLEAP exports and locate session videos. Two formats:
  * analysis ``.h5`` (SLEAP "Export Analysis HDF5"): datasets ``tracks``
    (n_tracks, 2, n_nodes, n_frames), ``node_names``, ``point_scores``;
  * native ``.slp`` (best effort): the ``pred_points`` / ``points`` structured
    tables with ``frames``/``instances`` indices.

Both return (points (F, K, 2) pixel xy, scores (F, K), node_names) for the
first track/instance per frame — the convention the preprocessors consume.
Video frame decode goes through cv2.VideoCapture.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from smilify_tpu_torch.utils import hdf5_io


def read_sleap_analysis_h5(path: str, track: int = 0):
    """Analysis-HDF5 export → (points (F, K, 2), scores (F, K), node_names)."""
    with hdf5_io.File(path, "r") as f:
        tracks = f["tracks"][:]  # (n_tracks, 2, n_nodes, n_frames)
        node_names = [n.decode() if isinstance(n, bytes) else str(n) for n in f["node_names"][:]]
        scores = f["point_scores"][:] if "point_scores" in f else None

    if tracks.ndim != 4:
        raise ValueError(f"unexpected tracks shape {tracks.shape}")
    t = tracks[track]  # (2, n_nodes, n_frames)
    points = np.transpose(t, (2, 1, 0))  # (F, K, 2) xy
    if scores is not None:
        s = scores[track] if scores.ndim == 3 else scores
        s = np.transpose(s, (1, 0)) if s.shape[0] != points.shape[0] else s
    else:
        s = np.where(np.isfinite(points).all(axis=-1), 1.0, 0.0)
    return points, s.astype(np.float32), node_names


def read_slp(path: str, instance: int = 0):
    """Native .slp (best effort) → (points (F, K, 2), scores (F, K), node_names).

    Reads the HDF5 tables SLEAP stores: frames, instances, pred_points, and
    the node names from the JSON metadata attribute. ``instance`` selects the
    n-th instance within each frame (0 = first, matching the reference's
    single-subject sessions; multi-animal sessions pick others).
    """
    import json

    with hdf5_io.File(path, "r") as f:
        meta = json.loads(f["metadata"].attrs["json"]) if "metadata" in f else {}
        skel = (meta.get("skeletons") or [{}])[0]
        node_ids = [n.get("id") for n in skel.get("nodes", [])]
        name_map = {}
        for link in meta.get("nodes", []):
            name_map[link.get("id")] = link.get("name", str(link.get("id")))
        node_names = [name_map.get(i, str(i)) for i in node_ids]

        frames = f["frames"][:]
        instances = f["instances"][:]
        pts_table = f["pred_points"][:] if "pred_points" in f else f["points"][:]

    K = len(node_names) if node_names else int(
        np.max(instances["point_id_end"] - instances["point_id_start"])
    )
    F = len(frames)
    points = np.full((F, K, 2), np.nan, np.float64)
    scores = np.zeros((F, K), np.float32)

    inst_by_frame = {}
    seen_count: dict = {}
    for inst in instances:
        fid = int(inst["frame_id"])
        k = seen_count.get(fid, 0)
        if k == instance:
            inst_by_frame[fid] = inst
        seen_count[fid] = k + 1

    for i, fr in enumerate(frames):
        inst = inst_by_frame.get(int(fr["frame_id"]))
        if inst is None:
            continue
        lo, hi = int(inst["point_id_start"]), int(inst["point_id_end"])
        pts = pts_table[lo:hi]
        n = min(K, len(pts))
        points[i, :n, 0] = pts["x"][:n]
        points[i, :n, 1] = pts["y"][:n]
        if "score" in pts.dtype.names:
            scores[i, :n] = pts["score"][:n]
        else:
            scores[i, :n] = np.where(np.isfinite(points[i, :n]).all(axis=-1), 1.0, 0.0)
    return points, scores, node_names


def read_sleap_predictions(path: str, track: int = 0):
    """Dispatch on extension (.h5 analysis export vs native .slp).

    ``track`` selects the track (analysis export) / per-frame instance (.slp)
    for multi-animal sessions."""
    if path.endswith(".slp"):
        return read_slp(path, instance=track)
    return read_sleap_analysis_h5(path, track=track)


def find_session_layout(session_dir: str) -> dict:
    """Locate per-camera prediction files + videos in a session directory.

    Supports the reference's two layouts: flat (<cam>.{slp,h5} + <cam>.mp4
    side by side) and nested (<session>/<cam>/...)."""
    out = {}
    for root, _dirs, files in os.walk(session_dir):
        for fn in files:
            base, ext = os.path.splitext(fn)
            if ext in (".slp", ".h5") and "calibration" not in fn and "points3d" not in fn:
                cam = base.split(".")[0]
                entry = out.setdefault(cam, {})
                entry["predictions"] = os.path.join(root, fn)
            elif ext in (".mp4", ".avi", ".mov"):
                cam = base.split(".")[0]
                entry = out.setdefault(cam, {})
                entry["video"] = os.path.join(root, fn)
    return out


def read_video_frame(video_path: str, frame_idx: int) -> Optional[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(video_path)
    try:
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        ok, frame = cap.read()
        if not ok:
            return None
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


class SequentialVideoReader:
    """One persistent cv2 capture per video with a sequential fast path.

    The reference preprocessor's key performance fix (its
    ``_process_camera_optimized``: open the video once, sort target frames,
    read sequentially, seek only on gaps). ``read(idx)`` returns RGB uint8 or
    None on decode failure (one retry after reopening — codecs occasionally
    wedge on damaged frames)."""

    def __init__(self, path: str):
        import cv2

        self.path = path
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        self._pos = 0

    @property
    def n_frames(self) -> int:
        return int(self._cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    def read(self, frame_idx: int) -> Optional[np.ndarray]:
        if not self._cap.isOpened():
            self._reopen()
        if frame_idx != self._pos:
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_idx)
            self._pos = frame_idx
        ok, frame = self._cap.read()
        if not ok:
            self._reopen()
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_idx)
            self._pos = frame_idx
            ok, frame = self._cap.read()
            if not ok:
                return None
        self._pos += 1
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def _reopen(self):
        try:
            self._cap.release()
        except Exception:
            pass
        self._cap = self._cv2.VideoCapture(self.path)
        self._pos = 0

    def close(self):
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_skeleton(path: str) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Skeleton (node names + edge index pairs) from a SLEAP export.

    Analysis .h5 exports carry ``node_names`` + ``edge_inds``; native .slp
    stores the skeleton in the JSON metadata (links between node ids) —
    the reference extracts both (root ``sleap_data_loader.py`` skeleton
    handling)."""
    import json

    if not path.endswith(".slp"):
        with hdf5_io.File(path, "r") as f:
            names = [n.decode() if isinstance(n, bytes) else str(n) for n in f["node_names"][:]]
            edges = []
            if "edge_inds" in f:
                edges = [(int(a), int(b)) for a, b in f["edge_inds"][:]]
            return names, edges

    with hdf5_io.File(path, "r") as f:
        meta = json.loads(f["metadata"].attrs["json"]) if "metadata" in f else {}
    skel = (meta.get("skeletons") or [{}])[0]
    node_ids = [n.get("id") for n in skel.get("nodes", [])]
    id_to_slot = {nid: i for i, nid in enumerate(node_ids)}
    name_map = {}
    for link in meta.get("nodes", []):
        name_map[link.get("id")] = link.get("name", str(link.get("id")))
    names = [name_map.get(i, str(i)) for i in node_ids]
    edges = []
    for e in skel.get("links", []):
        a, b = e.get("source"), e.get("target")
        if a in id_to_slot and b in id_to_slot:
            edges.append((id_to_slot[a], id_to_slot[b]))
    return names, edges


def read_joint_lookup_csv(path: str) -> dict:
    """``sleap_name,model_joint_name`` CSV → mapping dict (reference
    joint_lookup.csv consumed at ``preprocess_sleap_multiview_dataset.py:859``).
    Lines with an empty model name drop that SLEAP node."""
    import csv

    out = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        rows = list(reader)
    start = 1 if rows and rows[0] and rows[0][0].strip().lower() in (
        "sleap_name", "sleap", "source", "node") else 0
    for row in rows[start:]:
        if not row or not row[0].strip():
            continue
        out[row[0].strip()] = row[1].strip() if len(row) > 1 else ""
    return out


def map_keypoints_to_model(points: np.ndarray, scores: np.ndarray,
                           node_names: List[str], model_joint_names: List[str],
                           lookup: Optional[dict] = None):
    """Reorder SLEAP keypoints into model-joint order.

    Matching: explicit lookup table first, then case-insensitive name match.
    Unmapped model joints become NaN/score-0 (invisible). Returns
    ((F, J, 2), (F, J)) arrays."""
    F = points.shape[0]
    J = len(model_joint_names)
    out = np.full((F, J, 2), np.nan, np.float64)
    out_s = np.zeros((F, J), np.float32)
    lower_model = {str(n).lower(): j for j, n in enumerate(model_joint_names)}
    for k, node in enumerate(node_names):
        target = (lookup or {}).get(node, node)
        if not target:
            continue
        j = lower_model.get(str(target).lower())
        if j is None:
            continue
        out[:, j] = points[:, k]
        out_s[:, j] = scores[:, k]
    return out, out_s
