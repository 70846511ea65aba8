"""Export utilities: PLY/OBJ mesh writers and the per-frame image exporter
(port of ``smilify_tpu/utils/export.py``).

Per frame and stage/epoch :class:`ImageExporter` writes a collage PNG, a
parameter pkl and the posed mesh as ascii PLY, in the JAX package's layout
``<output_dir>/<frame>/st{stage}_ep{epoch}.{png,pkl,ply}``. The PNG goes
through :mod:`smilify_tpu_torch.utils.image_io`, since the card's machine
has no imageio. Not ported yet: ``write_video`` (it needs OpenCV).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from smilify_tpu_torch.utils.image_io import write_png


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write an ascii PLY mesh."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront OBJ mesh (1-indexed faces)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces, dtype=np.int64) + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def load_obj(path: str):
    """Read a Wavefront OBJ mesh → (verts (V,3) f32, faces (F,3) i32).

    Handles v/f lines with polygonal faces (fan-triangulated) and v/vt/vn
    index syntax; ignores materials/normals/uvs.
    """
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)


class ImageExporter:
    """Per-frame output folders with st{stage}_ep{epoch}.{png,pkl,ply} files
    (reference optimize_to_joints.py:29-63)."""

    def __init__(self, output_dir: str, filenames):
        self.output_dirs = []
        os.makedirs(output_dir, exist_ok=True)
        for name in filenames:
            d = os.path.join(output_dir, os.path.splitext(name)[0])
            os.makedirs(d, exist_ok=True)
            self.output_dirs.append(d)
        self.stage_id = 0
        self.epoch_name = "0"

    def export(
        self,
        collage_np: np.ndarray,
        global_id: int,
        img_parameters: Dict[str, np.ndarray],
        vertices: Optional[np.ndarray] = None,
        faces: Optional[np.ndarray] = None,
        epoch=None,
    ):
        ep = epoch if epoch is not None else self.epoch_name
        base = os.path.join(self.output_dirs[global_id], f"st{self.stage_id}_ep{ep}")
        write_png(base + ".png", np.asarray(collage_np).astype(np.uint8))
        with open(base + ".pkl", "wb") as f:
            pickle.dump({k: np.asarray(v) for k, v in img_parameters.items()}, f)
        if vertices is not None and faces is not None:
            save_ply(base + ".ply", np.asarray(vertices), np.asarray(faces))


def load_fitter_checkpoint(checkpoint_dir: str, filenames, stage: int, epoch) -> Dict[str, np.ndarray]:
    """Reload per-frame fitter parameter pkls written by :class:`ImageExporter`
    (reference ``fitter.py:352-371`` load_checkpoint): reads
    ``<dir>/<frame>/st{stage}_ep{epoch}.pkl`` for every frame and stacks the
    per-frame parameters; shared parameters (betas, scales, joint trans) come
    from the first frame. Keys are the fields of ``FitParams``."""
    per_frame = []
    for name in filenames:
        base = os.path.join(checkpoint_dir, os.path.splitext(name)[0],
                            f"st{stage}_ep{epoch}.pkl")
        with open(base, "rb") as f:
            per_frame.append(pickle.load(f))
    out = {
        "global_rot": np.stack([p["global_rotation"] for p in per_frame]),
        "joint_rot": np.stack([p["joint_rotations"] for p in per_frame]),
        "trans": np.stack([p["trans"] for p in per_frame]),
        "fov": np.stack([np.asarray(p["fov"]).reshape(()) for p in per_frame]),
        "betas": np.asarray(per_frame[0]["betas"]),
        "log_beta_scales": np.asarray(per_frame[0]["log_betascale"]),
        "joint_trans": np.asarray(per_frame[0]["betas_trans"]),
    }
    return out
