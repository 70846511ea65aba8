"""Synthetic stand-ins for the files the CLIs read, made from a seed.

The model pickle, the replicAnt sequences and the scan meshes that the fitter
and registration CLIs take are not in the repository; the CPU tests and
``chip_smoke.py`` write these instead:

  * :func:`write_model_pkl` — a spec's arrays as an L0 model ``.pkl``
    (``utils/authoring.py::export_model_pkl``);
  * :func:`write_replicant_sequence` — a replicAnt COCO folder: ``labels.json``
    with the spec's joints as keypoints, PNG or JPEG frames (the hard Phong
    render on white) and ``SMIL/*_ID.png`` masks, from posed copies of the
    spec; or the same frames in replicAnt's per-frame (Unreal) layout, which
    the regressors' CLIs read;
  * :func:`posed_target_meshes` — posed and scaled copies of a spec, the
    registration's target scans;
  * :func:`write_sleap_session` — a SLEAP session: per camera an MJPG video
    (OpenCV) and the 2D predictions as an analysis-HDF5 export (the first
    camera) or a native ``.slp`` table (the others), written by the port's
    HDF5 codec, and an anipose calibration.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
import torch

from smilify_tpu_torch.core.spec import ModelSpec


def write_model_pkl(path: str, spec: ModelSpec) -> str:
    """``spec`` as a model ``.pkl`` (faces in the spec's order; the loader
    Morton-sorts them). The spec's torso joints take the names the loader
    recognises as torso joints (``DEFAULT_TORSO_JOINT_NAMES``), so that the
    loaded spec aligns stage 0 on the same joints."""
    from smilify_tpu_torch.core.spec import DEFAULT_TORSO_JOINT_NAMES
    from smilify_tpu_torch.utils.authoring import export_model_pkl

    names = list(spec.joint_names)
    for j, name in zip(spec.torso_joints, DEFAULT_TORSO_JOINT_NAMES):
        names[j] = name

    def host(x):
        return x.detach().cpu().double().numpy()

    V, J, B = spec.n_verts, spec.n_joints, spec.n_betas
    kintree = np.stack([np.asarray((-1,) + spec.parents[1:]), np.arange(J)]).astype(np.int32)
    return export_model_pkl(
        path, host(spec.v_template), spec.faces.cpu().numpy(), host(spec.J_regressor).T,
        kintree, host(spec.weights), names,
        shapedirs=host(spec.shapedirs).T.reshape(V, 3, B),
        posedirs=host(spec.posedirs).T.reshape(V, 3, -1),
        shape_cov=host(spec.shape_cov), shape_mean_betas=host(spec.shape_mean_betas),
    )


@torch.no_grad()
def write_frame(path: str, rgb: np.ndarray, image_format: str) -> None:
    """A uint8 RGB frame as ``"png"`` (``image_io.write_png``) or as
    ``"jpeg"`` (``cv2.imwrite`` at OpenCV's default quality, 95)."""
    if image_format == "png":
        from smilify_tpu_torch.utils.image_io import write_png

        write_png(path, rgb)
    elif image_format == "jpeg":
        import cv2

        if not cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)):
            raise OSError(f"cv2.imwrite could not write {path}")
    else:
        raise ValueError(f"image_format must be 'png' or 'jpeg', got {image_format!r}")


@torch.no_grad()
def write_replicant_sequence(root: str, spec: ModelSpec, n_frames: int, size: int,
                             seed: int = 42, layout: str = "coco",
                             image_format: str = "png") -> Tuple[str, List[str]]:
    """``n_frames`` frames of ``spec`` posed by ``synthetic_poses(seed)`` at
    ``size``², seen by the default camera, in one of two replicAnt layouts:

    * ``"coco"`` (what the fitter CLIs read): ``<root>/SMIL_COCO``
      (``labels.json``, ``data/SMIL_<i>_synth.png``, or ``.jpg`` with
      ``image_format="jpeg"``) with masks in ``<root>/SMIL``; returns (the
      COCO folder, the frames' file names);
    * ``"unreal"`` (what ``data.replicant.ReplicantDataset`` reads, and so
      the regressors' CLIs): ``<root>/SMIL_synth/SMIL_synth_<i>.json`` with
      the frame under replicAnt's ``.JPG`` name (PNG data, or JPEG data with
      ``image_format="jpeg"``), its ``_ID.png`` mask and the folder's
      ``_BatchData_SMIL_synth.json``; every joint's local rotation is the
      identity, its 3D position the posed joint in Unreal's mirrored
      centimetres; returns (that folder, the JSON names).

    Frames are written by :func:`write_frame`; masks are always PNG.
    """
    if layout == "unreal":
        return _write_unreal_sequence(root, spec, n_frames, size, seed, image_format)
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.fitter.fitter import synthetic_poses
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.phong import render_phong
    from smilify_tpu_torch.render.rasterizer import soft_silhouette
    from smilify_tpu_torch.utils.image_io import write_png

    dev = spec.device
    coco = os.path.join(root, "SMIL_COCO")
    os.makedirs(os.path.join(coco, "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "SMIL"), exist_ok=True)
    betas, theta, trans = (torch.as_tensor(a).to(dev) for a in synthetic_poses(spec, n_frames, seed))
    out = smil_forward(spec, betas, theta)
    verts, joints = out.verts + trans[:, None], out.joints + trans[:, None]
    cam = default_camera(device=dev)
    images, annotations, names = [], [], []
    for i in range(n_frames):
        pv = cam.world_to_view(verts[i])
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        rgb = render_phong(verts[i], pv, ndc, spec.faces, (size, size))
        sil = soft_silhouette(ndc, spec.faces, (size, size), znear=cam.znear) > 0.5
        name = f"SMIL_{i:02d}_synth." + ("jpg" if image_format == "jpeg" else "png")
        write_frame(os.path.join(coco, "data", name),
                    (rgb * 255.0).round().to(torch.uint8).cpu().numpy(), image_format)
        mask = np.repeat((sil.cpu().numpy() * 255).astype(np.uint8)[..., None], 3, axis=-1)
        write_png(os.path.join(root, "SMIL", f"SMIL_{i:02d}_ID.png"), mask)
        yx = cam.project_points_yx(joints[i], (size, size)).cpu().numpy()
        kp = np.concatenate([yx[:, ::-1], np.full((len(yx), 1), 2.0)], axis=1)
        images.append({"id": i, "file_name": name, "height": size, "width": size})
        annotations.append({"id": i, "image_id": i, "keypoints": kp.reshape(-1).tolist()})
        names.append(name)
    labels = {"images": images, "annotations": annotations,
              "categories": [{"id": 1, "name": "insect", "keypoints": list(spec.joint_names)}]}
    with open(os.path.join(coco, "labels.json"), "w") as f:
        json.dump(labels, f)
    return coco, names


@torch.no_grad()
def posed_target_meshes(spec: ModelSpec, n: int, seed: int = 0) -> List[np.ndarray]:
    """``n`` copies of ``spec``'s mesh (V, 3) float32, each posed (joint
    angles ±0.1 rad, root ±0.3), scaled (0.9-1.1), shaped (betas ±0.5) and
    shifted (±0.05) by draws from ``seed``."""
    from smilify_tpu_torch.core.lbs import smil_forward

    rng = np.random.RandomState(seed)
    theta = rng.uniform(-0.1, 0.1, (n, spec.n_joints, 3))
    theta[:, 0] = rng.uniform(-0.3, 0.3, (n, 3))
    betas = rng.uniform(-0.5, 0.5, (n, spec.n_betas))
    scale = rng.uniform(0.9, 1.1, (n, 1, 1))
    shift = rng.uniform(-0.05, 0.05, (n, 1, 3))
    dev = spec.device
    verts = smil_forward(spec, torch.as_tensor(betas, dtype=torch.float32, device=dev),
                         torch.as_tensor(theta, dtype=torch.float32, device=dev)).verts
    verts = verts.cpu().numpy() * scale + shift
    return [v.astype(np.float32) for v in verts]


@torch.no_grad()
def _write_unreal_sequence(root: str, spec: ModelSpec, n_frames: int, size: int,
                           seed: int, image_format: str) -> Tuple[str, List[str]]:
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.fitter.fitter import synthetic_poses
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.phong import render_phong
    from smilify_tpu_torch.render.rasterizer import soft_silhouette
    from smilify_tpu_torch.utils.image_io import write_png

    dev = spec.device
    name = "SMIL_synth"
    folder = os.path.join(root, name)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"_BatchData_{name}.json"), "w") as f:
        json.dump({"Image Resolution": {"x": size, "y": size}}, f)
    betas, theta, trans = (torch.as_tensor(a).to(dev) for a in synthetic_poses(spec, n_frames, seed))
    out = smil_forward(spec, betas, theta)
    verts, joints = out.verts + trans[:, None], out.joints + trans[:, None]
    cam = default_camera(device=dev)
    ident = {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0}
    view = {"xPlane": {"x": 1.0, "y": 0.0, "z": 0.0}, "yPlane": {"x": 0.0, "y": 1.0, "z": 0.0},
            "zPlane": {"x": 0.0, "y": 0.0, "z": 1.0}, "wPlane": {"x": 0.0, "y": 0.0, "z": 270.0}}
    names = []
    for i in range(n_frames):
        pv = cam.world_to_view(verts[i])
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        rgb = render_phong(verts[i], pv, ndc, spec.faces, (size, size))
        sil = soft_silhouette(ndc, spec.faces, (size, size), znear=cam.znear) > 0.5
        yx = cam.project_points_yx(joints[i], (size, size)).cpu().numpy()
        j3 = joints[i].cpu().numpy() * 100.0
        keypoints = {
            jn: {"quaternion": ident, "globalRotation": ident,
                 "3DPos": {"x": float(-j3[j, 0]), "y": float(j3[j, 1]), "z": float(j3[j, 2])},
                 "2DPos": {"x": float(yx[j, 1]), "y": float(yx[j, 0])}}
            for j, jn in enumerate(spec.joint_names)}
        subject = {"keypoints": keypoints,
                   "shape betas": {f"b{k}": float(v) for k, v in enumerate(betas[i].tolist())}}
        frame = {"iterationData": {"camera": {"View Matrix": view, "FOV": 60.0,
                                              "Location": {"x": 0.0, "y": 0.0, "z": 270.0}},
                                   "subject Data": [{"SMIL_0": subject}]}}
        stem = os.path.join(folder, f"{name}_{i:02d}")
        with open(stem + ".json", "w") as f:
            json.dump(frame, f)
        write_frame(stem + ".JPG", (rgb * 255.0).round().to(torch.uint8).cpu().numpy(),
                    image_format)
        mask = (sil.cpu().numpy() * 255).astype(np.uint8)
        write_png(stem + "_ID.png", np.repeat(mask[..., None], 3, axis=-1))
        names.append(os.path.basename(stem) + ".json")
    return folder, names


SLEAP_NODES = ("Head", "Thorax", "tail_tip", "extra")


def sleap_calibrations(n: int, size: Tuple[int, int] = (64, 48), distort: bool = True):
    """``n`` cameras on a ring around the origin, 3 m away, for images of
    ``size`` (W, H), made from a seed."""
    from smilify_tpu_torch.data.sleap import CameraCalibration

    rng = np.random.default_rng(10)
    W, H = size
    return [CameraCalibration(
        name=f"cam{i}", size=(W, H),
        matrix=np.array([[(80.0 + i) * W / 64, 0, W / 2], [0, 82.0 * H / 48, H / 2], [0, 0, 1]]),
        distortions=np.array([0.01 * distort, -0.002 * distort, 0, 0, 0]),
        rotation=np.array([0.0, 0.5 * i, 0.05 * i]),
        translation=np.array([0.1 * i, 0.0, 3.0]) + rng.normal(0, 0.01, 3)) for i in range(n)]


def _write_sleap_video(path: str, n_frames: int, size: Tuple[int, int]) -> None:
    import cv2

    W, H = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    for i in range(n_frames):
        img = np.zeros((H, W, 3), np.uint8)
        x = 4 + 5 * i % max(W - 16, 1)
        img[10:26, x:x + 12] = (255, 180, 60)
        vw.write(img)
    vw.release()


def _write_slp(path: str, pts: np.ndarray, scores: np.ndarray, nodes) -> None:
    """A native ``.slp`` table: two instances a frame (the readers take the
    first), the skeleton in the JSON metadata attribute."""
    from smilify_tpu_torch.utils import hdf5_io

    F, K, _ = pts.shape
    meta = {"skeletons": [{"nodes": [{"id": 10 + k} for k in range(K)],
                           "links": [{"source": 10, "target": 11}, {"source": 11, "target": 12}]}],
            "nodes": [{"id": 10 + k, "name": n} for k, n in enumerate(nodes)]}
    frames = np.zeros(F, [("frame_id", "<i8")])
    frames["frame_id"] = np.arange(F)
    inst = np.zeros(2 * F, [("frame_id", "<i8"), ("point_id_start", "<i8"), ("point_id_end", "<i8")])
    table = np.zeros(2 * F * K, [("x", "<f8"), ("y", "<f8"), ("score", "<f8")])
    for f in range(F):
        for i in range(2):
            n = 2 * f + i
            inst[n] = (f, n * K, (n + 1) * K)
            table["x"][n * K:(n + 1) * K] = pts[f, :, 0] + 100 * i
            table["y"][n * K:(n + 1) * K] = pts[f, :, 1]
            table["score"][n * K:(n + 1) * K] = scores[f]
    with hdf5_io.File(path, "w") as h:
        h.create_group("metadata").attrs["json"] = json.dumps(meta)
        h["frames"], h["instances"], h["pred_points"] = frames, inst, table


def write_sleap_session(root: str, n_frames: int = 5, cams=("cam0", "cam1"),
                        consistent: bool = False, size: Tuple[int, int] = (64, 48),
                        nodes=SLEAP_NODES) -> str:
    """A SLEAP session in ``root``: per camera an MJPG video of ``size``
    (W, H) and the 2D predictions of ``nodes`` (the first camera's as an
    analysis-HDF5 export, the others' as native ``.slp`` tables), plus
    ``calibration.toml``. The predictions are random, or (``consistent``)
    the calibrated projections of random 3D points with 0.3 px of noise;
    frame 1's first two nodes are missing (NaN). Returns ``root``."""
    from smilify_tpu_torch.data.sleap import save_calibration_toml
    from smilify_tpu_torch.utils import hdf5_io

    rng = np.random.default_rng(12)
    os.makedirs(root, exist_ok=True)
    cals = sleap_calibrations(len(cams), size)
    K = len(nodes)
    pts3d = rng.uniform(-0.3, 0.3, (n_frames, K, 3))
    for ci, cam in enumerate(cams):
        _write_sleap_video(os.path.join(root, f"{cam}.avi"), n_frames, size)
        if consistent:
            pts = np.stack([cals[ci].project(p) for p in pts3d]) + rng.normal(0, 0.3, (n_frames, K, 2))
        else:
            pts = rng.uniform(2, min(size) - 2, (n_frames, K, 2))
        pts[1, :2] = np.nan
        sc = rng.uniform(0.1, 1.0, (n_frames, K)).astype(np.float32)
        if ci == 0:
            with hdf5_io.File(os.path.join(root, f"{cam}.analysis.h5"), "w") as f:
                f["tracks"] = np.transpose(pts, (2, 1, 0))[None]
                f["point_scores"] = sc.T[None]
                f["node_names"] = np.asarray([n.encode() for n in nodes])
                f["edge_inds"] = np.asarray([[0, 1], [1, 2]])
        else:
            _write_slp(os.path.join(root, f"{cam}.slp"), pts, sc, nodes)
    save_calibration_toml(os.path.join(root, "calibration.toml"), cals)
    return root
