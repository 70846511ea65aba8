"""replicAnt (Unreal) synthetic-data loaders — host-side numpy (port of
``smilify_tpu/data/replicant.py``: images are read by
:func:`~smilify_tpu_torch.utils.image_io.read_image`, PNG without imageio and
the JPG frames through it, and resized by
:func:`~smilify_tpu_torch.utils.image_io.resize`; the masks' dilation imports
OpenCV).

Behavioral equivalent of the reference ``smal_fitter/Unreal2Pytorch3D.py``
single-view path: per-frame JSON (+JPG +ID-mask) → training dict with SMIL
parameters, camera in our/PyTorch3D convention, normalized (y, x) keypoints,
visibility, and 3D keypoints re-parameterized to a model-at-origin scene.

Unreal→PyTorch3D conversions preserved exactly:
  * view-matrix decomposition (``parse_projection_components``,
    Unreal2Pytorch3D.py:186-213);
  * x-axis mirroring of rotation/translation plus a −180° yaw correction
    around the model's up axis (:980-1135);
  * per-joint quaternion → intrinsic-zyx euler → axis-angle with the
    (−z, y, −x) sign flips, root zeroed (:366-423);
  * intrinsics from FOV: fx = (W/2)/tan(FOV/2) (:215-254);
  * UE 10× scale convention and translation_factor for PCA translations.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from smilify_tpu_torch.utils.image_io import read_image, resize


def _euler_zyx_to_axis_angle(z: float, y: float, x: float) -> np.ndarray:
    """Intrinsic R = Rz(z) @ Ry(y) @ Rx(x) → axis-angle (nibabel convention)."""
    R = Rotation.from_euler("zyx", [z, y, x]).as_matrix()
    rv = Rotation.from_matrix(R).as_rotvec()
    return rv.astype(np.float32)


def get_joint_angles_from_pose_data(pose_data: Dict, root_key: Optional[str] = None):
    """Per-joint axis-angle from Unreal quaternions (root zeroed)."""
    if root_key is None:
        root_key = next(iter(pose_data))
    angles, names = [], []
    for key, entry in pose_data.items():
        names.append(key)
        q = entry["quaternion"]
        rot_eul = Rotation.from_quat([q["x"], q["y"], q["z"], q["w"]]).as_euler("zyx")
        if key != root_key:
            aa = _euler_zyx_to_axis_angle(-rot_eul[0], rot_eul[1], -rot_eul[2])
        else:
            aa = np.zeros(3, np.float32)
        angles.append(aa)
    return np.asarray(angles, dtype=np.float32), names


def map_joint_order(target_names, source_names, values: np.ndarray) -> np.ndarray:
    """Reorder per-joint values from source order into the model's order."""
    out = np.zeros((len(target_names),) + values.shape[1:], dtype=values.dtype)
    src = {n: i for i, n in enumerate(source_names)}
    for o, name in enumerate(target_names):
        if name in src:
            out[o] = values[src[name]]
    return out


def parse_projection_components(data: Dict):
    """Unreal view matrix → (R 3×3, t 3) components."""
    vm = data["iterationData"]["camera"]["View Matrix"]
    w, x, y, z = vm["wPlane"], vm["xPlane"], vm["yPlane"], vm["zPlane"]
    cam_rot = np.array(
        [[x["x"], y["x"], z["x"]], [x["y"], y["y"], z["y"]], [x["z"], y["z"], z["z"]]]
    )
    cam_trans = np.array([w["x"], w["y"], w["z"]])
    return cam_rot, cam_trans


def parse_camera_intrinsics(batch_data: Dict, data: Dict):
    W = batch_data["Image Resolution"]["x"]
    H = batch_data["Image Resolution"]["y"]
    fov = data["iterationData"]["camera"]["FOV"]
    cx, cy = W / 2, H / 2
    f = cx / np.tan(np.radians(fov) / 2)
    return cx, cy, f, f


def sample_pca_transforms_from_dirs(scaledirs, transdirs, scale_weights, trans_weights):
    """PCA weights → per-joint (translation (J,3), scale (J,3) with base 1.0).

    dirs accepted as (J, 3, C) or (C, J, 3) (model-pkl layout) and normalized.
    """
    def norm_dirs(d):
        d = np.asarray(d, dtype=np.float64)
        if d.ndim != 3:
            raise ValueError(f"dirs must be 3D, got {d.shape}")
        if d.shape[1] == 3:  # (J, 3, C)
            return d
        if d.shape[2] == 3:  # (C, J, 3)
            return np.transpose(d, (1, 2, 0))
        raise ValueError(f"cannot interpret dirs shape {d.shape}")

    sd = norm_dirs(scaledirs)
    td = norm_dirs(transdirs)
    sw = np.asarray(scale_weights, dtype=np.float64).reshape(-1)
    tw = np.asarray(trans_weights, dtype=np.float64).reshape(-1)
    if sw.shape[0] != sd.shape[2] or tw.shape[0] != td.shape[2]:
        raise ValueError("weight count does not match PCA component count")
    translation = np.tensordot(td, tw, axes=([2], [0]))
    scale = 1.0 + np.tensordot(sd, sw, axes=([2], [0]))
    return translation.astype(np.float32), scale.astype(np.float32)


def compute_keypoint_visibility(
    keypoints_norm_yx: np.ndarray, mask: Optional[np.ndarray], width: int, height: int, radius: int = 2
) -> np.ndarray:
    """Visible when inside the frame and on (or near) the subject's ID mask."""
    K = keypoints_norm_yx.shape[0]
    vis = np.ones(K, np.float32)
    for i, (ny, nx) in enumerate(keypoints_norm_yx):
        py, px = ny * height, nx * width
        if not (0 <= py < height and 0 <= px < width):
            vis[i] = 0.0
            continue
        if mask is not None:
            y0, y1 = max(0, int(py) - radius), min(height, int(py) + radius + 1)
            x0, x1 = max(0, int(px) - radius), min(width, int(px) + radius + 1)
            if mask[y0:y1, x0:x1].max() == 0:
                vis[i] = 0.0
    return vis


def refine_visibility_with_depth(
    visibility: np.ndarray,
    keypoints_norm_yx: np.ndarray,
    keypoints_3d_world_raw: np.ndarray,
    camera_location_world_raw: np.ndarray,
    depth_image: Optional[np.ndarray],
    width: int,
    height: int,
    depth_max_cm: float = 1000.0,
    depth_tolerance_cm: float = 5.0,
    neighborhood: int = 1,
) -> np.ndarray:
    """Depth-buffer self-occlusion refinement (reference
    ``Unreal2Pytorch3D.py:664``): replicAnt's depth pass stores the
    camera-to-surface distance in cm in the red channel of an 8-bit PNG via
    ``surface_cm = (R/255) · depth_max_cm``. A joint whose true camera
    distance exceeds the front-most surface distance (min over a small pixel
    neighborhood) by more than the tolerance is self-occluded.

    Monotone: can only turn 1.0 → 0.0. Joints already invisible, without 3D
    GT (NaN), or out of frame are skipped. Raw Unreal world frame (cm, no
    axis mirroring) for both the keypoints and the camera location.
    """
    if depth_image is None:
        return visibility
    if depth_image.ndim == 3:
        depth = depth_image[..., 0].astype(np.float64)
    else:
        depth = depth_image.astype(np.float64)
    if depth.shape != (height, width):
        return visibility

    vis = np.asarray(visibility, np.float32)
    kp = np.asarray(keypoints_norm_yx, np.float64)
    p3 = np.asarray(keypoints_3d_world_raw, np.float64)
    cam = np.asarray(camera_location_world_raw, np.float64)

    active = (
        (vis > 0)
        & np.isfinite(p3).all(axis=1)
        & np.isfinite(kp).all(axis=1)
        & (kp[:, 0] >= 0) & (kp[:, 0] <= 1) & (kp[:, 1] >= 0) & (kp[:, 1] <= 1)
    )
    if not active.any():
        return vis

    rows = np.clip((kp[:, 0] * height).astype(int), 0, height - 1)
    cols = np.clip((kp[:, 1] * width).astype(int), 0, width - 1)
    if neighborhood > 0:
        import scipy.ndimage as ndi

        depth_min = ndi.minimum_filter(depth, size=2 * neighborhood + 1, mode="nearest")
    else:
        depth_min = depth
    surface_cm = depth_min[rows, cols] / 255.0 * depth_max_cm
    dist_cm = np.linalg.norm(p3 - cam, axis=1)
    occluded = active & (dist_cm > surface_cm + depth_tolerance_cm)
    vis = vis.copy()
    vis[occluded] = 0.0
    return vis


_MIRROR_X = np.diag([-1.0, 1.0, 1.0])
_RZ_PI = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]])


def load_smil_unreal_sample(
    json_path: str,
    joint_names,
    load_image: bool = True,
    translation_factor: float = 0.01,
    propagate_scaling: bool = True,
) -> Tuple[Dict, Dict]:
    """Load one replicAnt frame (image + JSON) → (x_output, y_output) dicts.

    y_output holds model-at-origin parameters: joint_angles (J,3), betas,
    scale/trans PCA weights, camera (cam_rot row-convention R, cam_trans T,
    fov), normalized (y, x) keypoints_2d + visibility, and model-centered
    keypoints_3d.
    """
    folder = os.path.dirname(json_path)
    batch_path = os.path.join(folder, f"_BatchData_{os.path.basename(folder)}.json")
    image_path = os.path.splitext(json_path)[0] + ".JPG"

    x_output: Dict = {"input_image": image_path, "input_image_data": None, "input_image_mask": None}
    if load_image and os.path.exists(image_path):
        x_output["input_image_data"] = read_image(image_path)
    mask_path = image_path.replace(".JPG", "_ID.png")
    if os.path.exists(mask_path):
        import cv2

        m = read_image(mask_path)
        if m.ndim > 2:
            m = m[:, :, 0]
        m = (m > 0).astype(np.uint8) * 255
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
        x_output["input_image_mask"] = cv2.dilate(m, kernel, iterations=2)

    with open(json_path) as f:
        data = json.load(f)
    with open(batch_path) as f:
        batch_data = json.load(f)

    subject = data["iterationData"]["subject Data"][0]
    subject = subject[next(iter(subject))]
    pose_data = subject["keypoints"]
    root_key = next(iter(pose_data))

    y: Dict = {"pose_data": pose_data, "translation_factor": translation_factor,
               "propagate_scaling": propagate_scaling}

    cam_rot_orig, cam_trans_orig = parse_projection_components(data)
    cx, cy, fx, fy = parse_camera_intrinsics(batch_data, data)
    y.update(cam_fov=[data["iterationData"]["camera"]["FOV"]], cx=cx, cy=cy, fx=fx, fy=fy,
             cam_rot_orig=cam_rot_orig, cam_trans_orig=cam_trans_orig)

    y["scale_weights"] = subject.get("ScaleWeights")
    y["trans_weights"] = subject.get("TranslationWeights")

    betas = subject.get("shape betas", [])
    if isinstance(betas, dict):
        betas = [v for v in betas.values()]
    y["shape_betas"] = np.asarray(betas, dtype=np.float32)

    joint_angles, src_names = get_joint_angles_from_pose_data(pose_data, root_key)
    y["joint_angles"] = map_joint_order(joint_names, src_names, joint_angles)
    y["joint_names"] = list(joint_names)

    # camera: mirror x then row-vector convention
    R = _MIRROR_X @ cam_rot_orig.T @ _MIRROR_X.T
    T = np.array([-cam_trans_orig[0], cam_trans_orig[1], cam_trans_orig[2]])

    # model root in mirrored coordinates
    p0 = pose_data[root_key]["3DPos"]
    model_loc = np.array([-p0["x"], p0["y"], p0["z"]], dtype=np.float32)

    gq = pose_data[root_key]["globalRotation"]
    rot_model = Rotation.from_quat([-gq["x"], -gq["y"], -gq["z"], gq["w"]]).as_matrix()
    R_model = (_MIRROR_X @ rot_model @ _MIRROR_X.T).astype(np.float32)

    # re-parameterize: model at origin, camera takes the relative transform,
    # then −180° yaw about the model's up axis
    R_cam_new = _RZ_PI @ (R_model @ R)
    T_cam_new = model_loc @ R + T
    y["cam_rot"] = R_cam_new.astype(np.float32)
    y["cam_trans"] = T_cam_new.astype(np.float32)
    y["root_loc"] = np.zeros(3, np.float32)
    y["root_rot"] = np.zeros(3, np.float32)

    # normalized (y, x) 2D keypoints in model joint order
    W = batch_data["Image Resolution"]["x"]
    H = batch_data["Image Resolution"]["y"]
    kp2d, names2d = [], []
    for key, entry in pose_data.items():
        names2d.append(key)
        kp2d.append([entry["2DPos"]["y"] / H, entry["2DPos"]["x"] / W])
    kp2d = map_joint_order(joint_names, names2d, np.asarray(kp2d, np.float32))
    y["keypoints_2d"] = kp2d
    vis = compute_keypoint_visibility(kp2d, x_output["input_image_mask"], W, H)

    # depth-buffer self-occlusion refinement (ANDed onto the id-mask result)
    # when the replicAnt depth pass exists next to the frame
    depth_img = None
    for suffix in ("_D.png", "_Depth.png"):
        dp = image_path.replace(".JPG", suffix)
        if os.path.exists(dp):
            depth_img = read_image(dp)
            break
    if depth_img is not None:
        # NaN-fill unmapped joints so the refinement skips them (map_joint_order
        # zero-fill would alias the Unreal origin)
        kp3d_raw = np.full((len(joint_names), 3), np.nan, np.float64)
        src = {n: i for i, n in enumerate(names2d)}
        for o, name in enumerate(joint_names):
            if name in src:
                p = pose_data[name]["3DPos"]
                kp3d_raw[o] = [p["x"], p["y"], p["z"]]
        cam_loc = data["iterationData"]["camera"]["Location"]
        cam_loc_raw = np.array([cam_loc["x"], cam_loc["y"], cam_loc["z"]], np.float64)
        vis = refine_visibility_with_depth(vis, kp2d, kp3d_raw, cam_loc_raw, depth_img, W, H)
    y["keypoint_visibility"] = vis

    # model-centered 3D keypoints: X' = Rz_inv((X − t) R_modelᵀ)
    kp3d = []
    for key, entry in pose_data.items():
        p = entry["3DPos"]
        kp3d.append([-p["x"], p["y"], p["z"]])
    kp3d = map_joint_order(joint_names, names2d, np.asarray(kp3d, np.float32))
    y["keypoints_3d_original"] = kp3d.copy()
    kp3d_t = (kp3d - model_loc) @ R_model.T @ _RZ_PI.T
    y["keypoints_3d"] = kp3d_t.astype(np.float32)

    return x_output, y


class ReplicantDataset:
    """Directory of replicAnt frames as a map-style dataset (the reference's
    raw-directory dispatch in UnifiedSMILDataset, smil_datasets.py:147-228)."""

    def __init__(self, root: str, joint_names, image_size: Optional[int] = None,
                 translation_factor: float = 0.01):
        self.root = root
        self.joint_names = tuple(joint_names)
        self.image_size = image_size
        self.translation_factor = translation_factor
        self.json_paths = sorted(
            p for p in glob.glob(os.path.join(root, "*.json"))
            if not os.path.basename(p).startswith("_BatchData_")
        )
        if not self.json_paths:
            raise FileNotFoundError(f"no frame JSONs in {root}")

    def __len__(self):
        return len(self.json_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        x, y = load_smil_unreal_sample(
            self.json_paths[idx], self.joint_names, translation_factor=self.translation_factor
        )
        img = x["input_image_data"]
        if img is None:
            raise FileNotFoundError(f"missing image for {self.json_paths[idx]}")
        img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        img = img[..., :3]
        if self.image_size is not None and img.shape[0] != self.image_size:
            img = resize(img, (self.image_size, self.image_size), "linear")
        sample = {
            "image": img,
            "keypoints_2d": y["keypoints_2d"],
            "keypoint_visibility": y["keypoint_visibility"],
            "global_rot": y["root_rot"],
            "joint_rot": y["joint_angles"][1:],  # root handled by global_rot
            "betas": y["shape_betas"],
            "trans": y["root_loc"],
            "fov": np.asarray(y["cam_fov"][0], np.float32),
            "cam_rot": y["cam_rot"],
            "cam_trans": y["cam_trans"],
            "keypoints_3d": y["keypoints_3d"],
        }
        if y["scale_weights"] is not None:
            sample["scale_weights"] = np.asarray(y["scale_weights"], np.float32)
            sample["trans_weights"] = np.asarray(y["trans_weights"], np.float32)
        if x["input_image_mask"] is not None:
            m = x["input_image_mask"].astype(np.float32) / 255.0
            if self.image_size is not None and m.shape[0] != self.image_size:
                m = resize(m, (self.image_size, self.image_size), "nearest")
            sample["silhouette"] = m
        return sample
