"""HDF5 dataset format: writer + readers (single-view and multi-view; port
of ``smilify_tpu/data/hdf5_dataset.py``, the same files: the images are JPEG
through OpenCV, imported when used, and the files are read and written by
the port's own HDF5 codec, ``utils/hdf5_io.py``, so h5py and the JAX
package read what the port writes and the other way round). A multi-view
store can also be held in memory (:func:`multiview_store` →
:class:`MultiViewStore`), which the multi-view reader takes in place of a
path.

The on-disk schema is the reference's (so datasets interchange):
multi-view (preprocess_sleap_multiview_dataset.py:1441-1720):
  multiview_images/image_jpeg_view_{v}   vlen uint8 JPEG per sample
  multiview_images/view_mask             (N, V) bool
  multiview_keypoints/keypoints_2d       (N, V, K, 2)
  multiview_keypoints/keypoint_visibility(N, V, K)
  multiview_keypoints/camera_indices     (N, V) canonical camera ids
  multiview_keypoints/camera_intrinsics  (N, V, 3, 3)
  multiview_keypoints/camera_extrinsics_R(N, V, 3, 3)
  multiview_keypoints/camera_extrinsics_t(N, V, 3)
  multiview_keypoints/image_sizes        (N, V, 2)
  multiview_keypoints/keypoints_3d       (N, K, 3)
  parameters/{global_rot,joint_rot,betas,trans}
  auxiliary/{has_3d_data,session_name,frame_idx,num_views,has_ground_truth_betas,camera_names}
  metadata attrs: num_samples, max_views, n_joints, target_resolution,
    dataset_type, is_multiview, n_pose, n_betas, canonical_camera_order, ...

single-view optimized (neuralSMIL/optimized_dataset.py):
  images/image_jpeg           vlen uint8
  keypoints/{keypoints_2d,keypoint_visibility}
  parameters/{global_rot,joint_rot,betas,trans,fov,cam_rot,cam_trans[,log_beta_scales,betas_trans]}
  metadata attrs: num_samples, n_joints, target_resolution, dataset_type, ...

Readers return numpy samples (host-side); batching/collation pads to static
max_views with boolean masks so batches have static shapes.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from smilify_tpu_torch.utils import hdf5_io


def encode_jpeg(img_uint8: np.ndarray, quality: int = 90) -> np.ndarray:
    import cv2

    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img_uint8, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("jpeg encode failed")
    return buf.reshape(-1)


def decode_jpeg(buf: np.ndarray) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.asarray(buf, dtype=np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def multiview_store(
    samples: List[Dict],
    max_views: int,
    target_resolution: int,
    canonical_camera_order: List[str],
    n_pose: int,
    n_betas: int,
    dataset_type: str = "sleap_multiview",
    jpeg_quality: int = 90,
    extra_metadata: Optional[Dict] = None,
) -> "MultiViewStore":
    """Multi-view samples in the reference schema, in memory: what
    :func:`write_multiview_hdf5` writes, JPEG images included, as a
    :class:`MultiViewStore`.

    Each sample dict: images (list of (H,W,3) uint8 per valid view),
    camera_indices (list int), keypoints_2d (V', K, 2), keypoint_visibility
    (V', K), camera_intrinsics (V',3,3), camera_extrinsics_R (V',3,3),
    camera_extrinsics_t (V',3), image_sizes (V',2), optional keypoints_3d
    (K,3) + has_3d_data, optional parameters global_rot/joint_rot/betas/trans,
    session_name, frame_idx.
    """
    N = len(samples)
    K = samples[0]["keypoints_2d"].shape[1]

    jpegs = [np.empty((N,), object) for _ in range(max_views)]   # a view's JPEG buffers
    for col in jpegs:
        for i in range(N):
            col[i] = np.zeros((0,), np.uint8)                     # an absent view: empty
    view_mask = np.zeros((N, max_views), dtype=bool)
    kp2d = np.zeros((N, max_views, K, 2), np.float32)
    kpv = np.zeros((N, max_views, K), np.float32)
    cam_idx = np.full((N, max_views), -1, np.int32)
    Kmat = np.zeros((N, max_views, 3, 3), np.float32)
    Rmat = np.zeros((N, max_views, 3, 3), np.float32)
    tvec = np.zeros((N, max_views, 3), np.float32)
    sizes = np.zeros((N, max_views, 2), np.int32)
    kp3d = np.zeros((N, K, 3), np.float32)
    has3d = np.zeros((N,), bool)
    g_rot = np.zeros((N, 3), np.float32)
    j_rot = np.zeros((N, n_pose, 3), np.float32)
    betas = np.zeros((N, n_betas), np.float32)
    trans = np.zeros((N, 3), np.float32)
    has_betas = np.zeros((N,), bool)
    sessions, fidx, nviews, cam_names = [], [], [], []

    for i, s in enumerate(samples):
        nv = len(s["images"])
        view_mask[i, :nv] = True
        for v in range(nv):
            jpegs[v][i] = encode_jpeg(s["images"][v], jpeg_quality)
        kp2d[i, :nv] = s["keypoints_2d"]
        kpv[i, :nv] = s["keypoint_visibility"]
        cam_idx[i, :nv] = s["camera_indices"]
        Kmat[i, :nv] = s["camera_intrinsics"]
        Rmat[i, :nv] = s["camera_extrinsics_R"]
        tvec[i, :nv] = s["camera_extrinsics_t"]
        sizes[i, :nv] = s["image_sizes"]
        if s.get("keypoints_3d") is not None:
            kp3d[i] = s["keypoints_3d"]
            has3d[i] = True
        for name, arr in (("global_rot", g_rot), ("joint_rot", j_rot), ("betas", betas), ("trans", trans)):
            if s.get(name) is not None:
                arr[i] = s[name]
                if name == "betas":
                    has_betas[i] = True
        sessions.append(s.get("session_name", "session").encode())
        fidx.append(int(s.get("frame_idx", i)))
        nviews.append(nv)
        cam_names.append(",".join(str(c) for c in s.get("camera_names", s["camera_indices"])).encode())

    arrays = {f"multiview_images/image_jpeg_view_{v}": jpegs[v] for v in range(max_views)}
    arrays.update({
        "multiview_images/view_mask": view_mask,
        "multiview_keypoints/keypoints_2d": kp2d,
        "multiview_keypoints/keypoint_visibility": kpv,
        "multiview_keypoints/camera_indices": cam_idx,
        "multiview_keypoints/camera_intrinsics": Kmat,
        "multiview_keypoints/camera_extrinsics_R": Rmat,
        "multiview_keypoints/camera_extrinsics_t": tvec,
        "multiview_keypoints/image_sizes": sizes,
        "multiview_keypoints/keypoints_3d": kp3d,
        "auxiliary/has_3d_data": has3d,
        "parameters/global_rot": g_rot,
        "parameters/joint_rot": j_rot,
        "parameters/betas": betas,
        "parameters/trans": trans,
        "auxiliary/session_name": np.asarray(sessions),
        "auxiliary/frame_idx": np.asarray(fidx),
        "auxiliary/num_views": np.asarray(nviews),
        "auxiliary/has_ground_truth_betas": has_betas,
        "auxiliary/camera_names": np.asarray(cam_names),
    })
    attrs = {
        "num_samples": N,
        "max_views": max_views,
        "n_joints": K,
        "target_resolution": target_resolution,
        "dataset_type": dataset_type,
        "is_multiview": True,
        "n_pose": n_pose,
        "n_betas": n_betas,
        "canonical_camera_order": json.dumps(canonical_camera_order),
        "has_camera_parameters": True,
        "has_3d_keypoints": bool(has3d.any()),
        **(extra_metadata or {}),
    }
    return MultiViewStore(arrays, attrs)


def write_multiview_hdf5(path: str, samples: List[Dict], *args, **kwargs):
    """Write multi-view samples in the reference schema to the HDF5 file
    ``path``; the arguments are :func:`multiview_store`'s."""
    store = multiview_store(samples, *args, **kwargs)
    with hdf5_io.File(path, "w") as f:
        for group in ("multiview_images", "multiview_keypoints", "parameters", "auxiliary"):
            f.create_group(group)
        for key, arr in store.arrays.items():
            if arr.dtype == object:                         # JPEG buffers
                arr = arr.view(hdf5_io.vlen_dtype(np.uint8))
            elif arr.dtype.kind == "S":                     # lists of bytes to the JAX writer:
                arr = [bytes(b) for b in arr]               # variable-length ASCII strings
            f.create_dataset(key, data=arr)
        gm = f.create_group("metadata")
        for k, v in store.attrs.items():
            gm.attrs[k] = v


class MultiViewStore:
    """The multi-view schema held in memory (:func:`multiview_store`), read
    by :class:`MultiViewHDF5Dataset` and :func:`detect_dataset_type` as they
    read an open HDF5 file: ``store["group/name"][i]`` is a numpy array (the
    JPEG columns: 1-D uint8 buffers), ``store["metadata"].attrs`` the
    metadata. The learning proofs and ``DeviceDataCache`` train on it."""

    def __init__(self, arrays: Dict[str, np.ndarray], attrs: Dict):
        self.arrays = arrays
        self.attrs = attrs

    def __getitem__(self, key: str):
        if key == "metadata":
            return SimpleNamespace(attrs=self.attrs)
        return self.arrays[key]

    def __contains__(self, key: str) -> bool:
        return key == "metadata" or key in self.arrays

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


def _open(source):
    """An HDF5 file at the path ``source``, or the in-memory store."""
    if isinstance(source, MultiViewStore):
        return source
    return hdf5_io.File(source, "r")


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def detect_dataset_type(path: str) -> str:
    """Auto-dispatch on HDF5 metadata (reference UnifiedSMILDataset.from_path,
    smil_datasets.py:147-228)."""
    import os

    if not isinstance(path, MultiViewStore) and os.path.isdir(path):
        return "replicant_raw"
    with _open(path) as f:
        if "metadata" in f:
            attrs = dict(f["metadata"].attrs)
            if attrs.get("is_multiview", False):
                return str(attrs.get("dataset_type", "sleap_multiview"))
            return str(attrs.get("dataset_type", "optimized_hdf5"))
    return "unknown"


class MultiViewHDF5Dataset:
    """Reader for the multi-view schema with lazy per-worker file handles
    (reference SLEAPMultiViewDataset:109,254); ``path`` is an HDF5 file or a
    :class:`MultiViewStore`.

    ``__getitem__`` returns a dict of numpy arrays already padded to
    max_views with ``view_mask``; ``num_views_to_use`` subsamples views
    (random under a numpy Generator, or the first n when deterministic).
    """

    def __init__(
        self,
        path: str,
        num_views_to_use: Optional[int] = None,
        view_sampling: str = "random",
        seed: int = 0,
        world_scale: Optional[float] = None,
        return_single_view: bool = False,
        preferred_view: int = 0,
        camera_centric: bool = False,
        expand_all_views: bool = False,
        min_views: int = 1,
    ):
        self.path = path
        self._file = None
        self.num_views_to_use = num_views_to_use
        self.view_sampling = view_sampling
        self.return_single_view = return_single_view
        self.preferred_view = preferred_view
        self.camera_centric = camera_centric
        self.expand_all_views = expand_all_views
        self.min_views = min_views
        self.rng = np.random.default_rng(seed)
        with _open(path) as f:
            m = dict(f["metadata"].attrs)
            self.num_samples = int(m["num_samples"])
            self.max_views = int(m["max_views"])
            self.n_joints = int(m["n_joints"])
            self.target_resolution = int(m.get("target_resolution", 224))
            self.metadata = {k: (v.item() if getattr(v, "size", 2) == 1 else v) for k, v in m.items()}
            # world-scale heuristic: camera translations with ‖t‖>50 are mm →
            # convert to meters (reference sleap_multiview_dataset.py:143-175)
            t = f["multiview_keypoints/camera_extrinsics_t"][: min(64, self.num_samples)]
            vm = f["multiview_images/view_mask"][: min(64, self.num_samples)]
            norms = np.linalg.norm(t[vm], axis=-1) if vm.any() else np.zeros(1)
            self.world_scale = (
                world_scale
                if world_scale is not None
                else (0.001 if (norms.size and np.median(norms) > 50.0) else 1.0)
            )

        # samples with fewer than min_views valid views are filtered out of
        # the index (reference multiview.min_views_per_sample)
        self._sample_index = None
        if min_views > 1:
            with _open(path) as f:
                counts = f["multiview_images/view_mask"][:].sum(axis=1)
            self._sample_index = np.nonzero(counts >= min_views)[0]
            self.num_samples = len(self._sample_index)

        if self.return_single_view and self.expand_all_views:
            # flat per-view index (reference expand_all_views,
            # sleap_multiview_dataset.py:298): every valid view is an item;
            # item_sample_indices keeps splits at the sample level so no view
            # leaks across train/val/test
            with _open(path) as f:
                vm = f["multiview_images/view_mask"][:]
            keep = (self._sample_index if self._sample_index is not None
                    else range(vm.shape[0]))
            self._sv_items = [(int(s), int(v))
                              for s in keep for v in np.nonzero(vm[s])[0]]
            self.item_sample_indices = np.asarray([s for s, _ in self._sv_items], np.int64)

    def _resolve_sample(self, idx: int) -> int:
        if self._sample_index is not None:
            return int(self._sample_index[idx])
        return idx

    @property
    def file(self):
        if self._file is None:
            self._file = _open(self.path)
        return self._file

    def __getstate__(self):
        # spawn workers reopen the file lazily
        return {**self.__dict__, "_file": None}

    def __len__(self):
        if self.return_single_view and self.expand_all_views:
            return len(self._sv_items)
        return self.num_samples

    def _select_views(self, valid_ids):
        n = self.num_views_to_use
        if n is None or len(valid_ids) <= n:
            return valid_ids
        if self.view_sampling == "random":
            return np.sort(self.rng.choice(valid_ids, size=n, replace=False))
        return valid_ids[:n]

    def _get_single_view(self, idx: int) -> Dict[str, np.ndarray]:
        """One (sample, view) pair as a single-view training sample
        (reference return_single_view / camera_centric modes,
        sleap_multiview_dataset.py:48,67-72,298). Pure numpy — no device
        work inside loader threads."""
        from smilify_tpu_torch.data.canonical_frame import (
            camera_from_opencv_np,
            recanonicalize_single_view,
            rotate_axis_angle_left,
        )

        f = self.file
        if self.expand_all_views:
            s, v = self._sv_items[idx]
        else:
            s = self._resolve_sample(idx)
            valid = np.nonzero(f["multiview_images/view_mask"][s])[0]
            if len(valid) == 0:
                raise IndexError(f"sample {s} has no valid views")
            v = self.preferred_view if self.preferred_view in valid else int(valid[0])

        ws = self.world_scale
        img = decode_jpeg(f[f"multiview_images/image_jpeg_view_{v}"][s]).astype(np.float32) / 255.0
        K = f["multiview_keypoints/camera_intrinsics"][s, v].astype(np.float64)
        R_cv = f["multiview_keypoints/camera_extrinsics_R"][s, v].astype(np.float64)
        t_cv = f["multiview_keypoints/camera_extrinsics_t"][s, v].astype(np.float64) * ws
        size = f["multiview_keypoints/image_sizes"][s, v].astype(np.int32)
        kp3d = f["multiview_keypoints/keypoints_3d"][s].astype(np.float64) * ws

        # multiview stores hold pixel (x, y) keypoints; single-view consumers
        # (loss engine, benchmark, viz) use the normalized (y, x) convention
        # (models/regressor.py:311) — convert at the boundary
        kp_px = f["multiview_keypoints/keypoints_2d"][s, v].astype(np.float32)
        Hc, Wc = img.shape[0], img.shape[1]
        kp_norm_yx = np.stack([kp_px[:, 1] / Hc, kp_px[:, 0] / Wc], axis=-1)
        sample = {
            "image": img,
            "keypoints_2d": kp_norm_yx,
            "keypoint_visibility":
                f["multiview_keypoints/keypoint_visibility"][s, v].astype(np.float32),
            "has_3d_data": bool(f["auxiliary/has_3d_data"][s]),
            "joint_rot": f["parameters/joint_rot"][s],
            "betas": f["parameters/betas"][s],
            "has_pose": bool(f["auxiliary/has_ground_truth_betas"][s]),
            "frame_idx": int(f["auxiliary/frame_idx"][s]),
            "sample_idx": s,
            "view_idx": v,
        }
        g_rot = f["parameters/global_rot"][s].astype(np.float64)
        trans = f["parameters/trans"][s].astype(np.float64) * ws

        if self.camera_centric:
            kp3d_v, R_out, t_out, M, b = recanonicalize_single_view(R_cv, t_cv, kp3d)
            sample["keypoints_3d"] = kp3d_v.astype(np.float32)
            sample["global_rot"] = rotate_axis_angle_left(g_rot, M).astype(np.float32)
            sample["trans"] = (M @ trans + b).astype(np.float32)
            R_cv, t_cv = R_out, t_out
        else:
            sample["keypoints_3d"] = kp3d.astype(np.float32)
            sample["global_rot"] = g_rot.astype(np.float32)
            sample["trans"] = trans.astype(np.float32)

        Rr, T, fov, _aspect = camera_from_opencv_np(
            R_cv, t_cv, K,
            (int(size[1]), int(size[0])) if size[0] and size[1]
            else (img.shape[0], img.shape[1]),
        )
        sample["fov"] = np.asarray([fov], np.float32)
        sample["cam_rot"] = np.asarray(Rr, np.float32).reshape(-1)
        sample["cam_trans"] = np.asarray(T, np.float32)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.return_single_view:
            return self._get_single_view(idx)
        idx = self._resolve_sample(idx)
        f = self.file
        vm_full = f["multiview_images/view_mask"][idx]
        valid = np.nonzero(vm_full)[0]
        chosen = self._select_views(valid)

        V = self.max_views if self.num_views_to_use is None else self.num_views_to_use
        R = self.target_resolution
        K = self.n_joints
        ws = self.world_scale

        images = np.zeros((V, R, R, 3), np.float32)
        view_mask = np.zeros((V,), bool)
        kp2d = np.zeros((V, K, 2), np.float32)
        kpv = np.zeros((V, K), np.float32)
        cam_idx = np.full((V,), -1, np.int32)
        Km = np.zeros((V, 3, 3), np.float32)
        Rm = np.zeros((V, 3, 3), np.float32)
        tv = np.zeros((V, 3), np.float32)
        sizes = np.zeros((V, 2), np.int32)

        for slot, v in enumerate(chosen):
            buf = f[f"multiview_images/image_jpeg_view_{v}"][idx]
            img = decode_jpeg(buf).astype(np.float32) / 255.0
            images[slot, : img.shape[0], : img.shape[1]] = img
            view_mask[slot] = True
            kp2d[slot] = f["multiview_keypoints/keypoints_2d"][idx, v]
            kpv[slot] = f["multiview_keypoints/keypoint_visibility"][idx, v]
            cam_idx[slot] = f["multiview_keypoints/camera_indices"][idx, v]
            Km[slot] = f["multiview_keypoints/camera_intrinsics"][idx, v]
            Rm[slot] = f["multiview_keypoints/camera_extrinsics_R"][idx, v]
            tv[slot] = f["multiview_keypoints/camera_extrinsics_t"][idx, v] * ws
            sizes[slot] = f["multiview_keypoints/image_sizes"][idx, v]

        sample = {
            "images": images,
            "view_mask": view_mask,
            "keypoints_2d": kp2d,
            "keypoint_visibility": kpv,
            "camera_indices": cam_idx,
            "camera_intrinsics": Km,
            "camera_extrinsics_R": Rm,
            "camera_extrinsics_t": tv,
            "image_sizes": sizes,
            "keypoints_3d": f["multiview_keypoints/keypoints_3d"][idx] * ws,
            "has_3d_data": bool(f["auxiliary/has_3d_data"][idx]),
            "global_rot": f["parameters/global_rot"][idx],
            "joint_rot": f["parameters/joint_rot"][idx],
            "betas": f["parameters/betas"][idx],
            "trans": f["parameters/trans"][idx],
            "has_pose": bool(f["auxiliary/has_ground_truth_betas"][idx]),
            "frame_idx": int(f["auxiliary/frame_idx"][idx]),
        }
        return sample

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def collate_multiview(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack already-padded samples into a batch of arrays (replaces the
    reference's list-of-dicts collate — fixed shapes)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class SingleViewHDF5Dataset:
    """Reader for the single-view optimized schema
    (reference OptimizedSMILDataset, optimized_dataset.py:16)."""

    PARAM_KEYS = (
        "global_rot", "joint_rot", "betas", "trans", "fov", "cam_rot", "cam_trans",
        "log_beta_scales", "betas_trans",
    )

    def __init__(self, path: str):
        self.path = path
        self._file = None
        with _open(path) as f:
            m = dict(f["metadata"].attrs)
            self.num_samples = int(m["num_samples"])
            self.n_joints = int(m.get("n_joints", 0))
            self.target_resolution = int(m.get("target_resolution", 224))
            self.metadata = {k: (v.item() if getattr(v, "size", 2) == 1 else v) for k, v in m.items()}

    @property
    def file(self):
        if self._file is None:
            self._file = _open(self.path)
        return self._file

    def __getstate__(self):
        # spawn workers reopen the file lazily
        return {**self.__dict__, "_file": None}

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        f = self.file
        img = decode_jpeg(f["images/image_jpeg"][idx]).astype(np.float32) / 255.0
        sample = {
            "image": img,
            "keypoints_2d": f["keypoints/keypoints_2d"][idx],
            "keypoint_visibility": f["keypoints/keypoint_visibility"][idx],
        }
        for k in self.PARAM_KEYS:
            if k in f.get("parameters", {}):
                sample[k] = f[f"parameters/{k}"][idx]
        if "auxiliary" in f and "silhouette_jpeg" in f["auxiliary"]:
            sil = decode_jpeg(f["auxiliary/silhouette_jpeg"][idx])
            sample["silhouette"] = (sil[..., 0] > 127).astype(np.float32)
        return sample


def write_singleview_hdf5(
    path: str,
    samples: List[Dict],
    target_resolution: int,
    n_pose: int,
    n_betas: int,
    dataset_type: str = "optimized_hdf5",
    jpeg_quality: int = 90,
    extra_metadata: Optional[Dict] = None,
):
    """Write single-view samples (images + keypoints + parameters);
    ``extra_metadata`` joins the metadata attributes."""
    N = len(samples)
    with hdf5_io.File(path, "w") as f:
        gi = f.create_group("images")
        gk = f.create_group("keypoints")
        gp = f.create_group("parameters")
        ga = f.create_group("auxiliary")
        gm = f.create_group("metadata")
        dt_vlen = hdf5_io.vlen_dtype(np.uint8)
        img_ds = gi.create_dataset("image_jpeg", shape=(N,), dtype=dt_vlen)
        K = samples[0]["keypoints_2d"].shape[0]
        kp = np.zeros((N, K, 2), np.float32)
        kv = np.zeros((N, K), np.float32)
        params = {k: [] for k in SingleViewHDF5Dataset.PARAM_KEYS}
        has_sil = all(s.get("silhouette") is not None for s in samples)
        if has_sil:
            sil_ds = ga.create_dataset("silhouette_jpeg", shape=(N,), dtype=dt_vlen)
        for i, s in enumerate(samples):
            img_ds[i] = encode_jpeg(s["image"], jpeg_quality)
            kp[i] = s["keypoints_2d"]
            kv[i] = s["keypoint_visibility"]
            for k in params:
                if s.get(k) is not None:
                    params[k].append(np.asarray(s[k], np.float32))
            if has_sil:
                sil_u8 = (np.asarray(s["silhouette"]) * 255).astype(np.uint8)
                sil_ds[i] = encode_jpeg(np.repeat(sil_u8[..., None], 3, -1), 95)
        gk.create_dataset("keypoints_2d", data=kp)
        gk.create_dataset("keypoint_visibility", data=kv)
        for k, vals in params.items():
            if len(vals) == N:
                gp.create_dataset(k, data=np.stack(vals))
        # provenance + optional extra supervision (reference auxiliary group)
        for key, dtype in (("session_name", None), ("camera_name", None)):
            if all(s.get(key) is not None for s in samples):
                ga.create_dataset(key, data=np.asarray([str(s[key]) for s in samples],
                                                       dtype=hdf5_io.string_dtype()))
        if all(s.get("frame_idx") is not None for s in samples):
            ga.create_dataset("frame_idx",
                              data=np.asarray([int(s["frame_idx"]) for s in samples], np.int64))
        if all(s.get("keypoints_3d_sleap") is not None for s in samples):
            ga.create_dataset("keypoints_3d_sleap",
                              data=np.stack([s["keypoints_3d_sleap"] for s in samples]))
        gm.attrs["num_samples"] = N
        gm.attrs["n_joints"] = K
        gm.attrs["target_resolution"] = target_resolution
        gm.attrs["dataset_type"] = dataset_type
        gm.attrs["is_multiview"] = False
        gm.attrs["n_pose"] = n_pose
        gm.attrs["n_betas"] = n_betas
        for k, v in (extra_metadata or {}).items():
            gm.attrs[k] = v
