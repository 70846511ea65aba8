"""Synthetic stand-ins for the files the CLIs read, made from a seed.

The model pickle, the replicAnt sequences and the scan meshes that the fitter
and registration CLIs take are not in the repository; the CPU tests and
``chip_smoke.py`` write these instead:

  * :func:`write_model_pkl` — a spec's arrays as an L0 model ``.pkl``
    (``utils/authoring.py::export_model_pkl``);
  * :func:`write_replicant_sequence` — a replicAnt COCO folder: ``labels.json``
    with the spec's joints as keypoints, PNG frames (the hard Phong render on
    white) and ``SMIL/*_ID.png`` masks, from posed copies of the spec;
  * :func:`posed_target_meshes` — posed and scaled copies of a spec, the
    registration's target scans.
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
def write_replicant_sequence(root: str, spec: ModelSpec, n_frames: int, size: int,
                             seed: int = 42) -> Tuple[str, List[str]]:
    """``n_frames`` frames of ``spec`` posed by ``synthetic_poses(seed)`` at
    ``size``², as a replicAnt folder ``<root>/SMIL_COCO`` (``labels.json``,
    ``data/SMIL_<i>_synth.png``) with masks in ``<root>/SMIL``. Returns
    (the COCO folder, the frames' file names)."""
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
        name = f"SMIL_{i:02d}_synth.png"
        write_png(os.path.join(coco, "data", name),
                  (rgb * 255.0).round().to(torch.uint8).cpu().numpy())
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
