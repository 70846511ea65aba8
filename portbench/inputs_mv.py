"""The multi-view regressor cell's inputs, made from ``--seed`` by the
benchmark itself and handed alike to the program and to the reference
(``inputs.py`` makes the other cells').

* a rig of the configuration's canonical cameras (OpenCV convention), each
  at a distance, azimuth and elevation drawn from the seed, looking at the
  origin with +z up, its fov drawn from the traffic's range (fx = fy,
  principal point at the image's centre);
* frames: each takes distinct camera ids of the rig, one a view slot; the
  first 2-4 slots hold views (the traffic's shares), the rest are masked
  (zero images, zero visibility, the slot's camera kept); uint8 NHWC noise
  images drawn on the device by a ``torch.Generator`` and kept on the
  host; SMIL targets (small seeded rotations, betas and trans), their 3D
  joints by the reference SMIL forward, their 2D keypoints (pixel x, y) the
  joints' projections through the frame's cameras, each joint of a
  present view visible with the traffic's probability;
* the weights, on the device from one ``torch.Generator`` call: LeCun-
  normal linear layers and patch embedding, the output layers at
  ``inputs.HEAD_SCALE`` of LeCun's scale, the CLS token and position
  embedding at 0.02, the view embeddings at 1/√width (the port's
  initializer), unit norms, zero biases, the IEF start at its identity
  estimate."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference import multiview as ref_mv
from portbench.reference import smil

RIG, FRAMES = 11, 12              # numpy streams of one seed
TOKEN_STD = 0.02
SMIL_CHUNK = 256                  # frames a reference SMIL forward


def rig(n: int, res: int, traffic: dict, g: np.random.Generator):
    """(R (n, 3, 3), t (n, 3), K (n, 3, 3)) of ``n`` OpenCV cameras."""
    az = g.uniform(0.0, 2 * np.pi, n)
    el = g.uniform(*traffic["elevation_rad"], n)
    dist = g.uniform(*traffic["distance"], n)
    fov = np.deg2rad(g.uniform(*traffic["fov_deg"], n))
    C = dist[:, None] * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    z = -C / np.linalg.norm(C, axis=-1, keepdims=True)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], 1)
    t = -np.einsum("nij,nj->ni", R, C)
    f = (res / 2.0) / np.tan(fov / 2.0)
    K = np.zeros((n, 3, 3))
    K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = f, f, 1.0
    K[:, :2, 2] = (res - 1) / 2.0
    return R, t, K


class Frames:
    """The cell's frames as a dataset of dicts of numpy arrays in the port's
    multi-view sample layout (``images`` uint8 (V, res, res, 3), ``view_mask``,
    ``camera_indices``, the OpenCV cameras, ``keypoints_2d`` pixel (x, y),
    ``keypoint_visibility``, ``keypoints_3d`` and the SMIL targets),
    indexable and sized."""

    def __init__(self, cfg: dict, traffic: dict, m: dict, seed: int, device):
        n, V, res = cfg["cache_samples"], cfg["views"], cfg["image_size"]
        J, B = cfg["model"]["J"], cfg["model"]["B"]
        R, t, K = rig(cfg["canonical_cameras"], res, traffic, inputs.rng(seed, RIG))
        g = inputs.rng(seed, FRAMES)
        counts, shares = zip(*traffic["views_present"])
        present = g.choice(np.asarray(counts), size=n, p=np.asarray(shares))
        mask = np.arange(V)[None] < present[:, None]
        ids = np.argsort(g.random((n, cfg["canonical_cameras"])), axis=1)[:, :V]
        params = {"global_rot": g.normal(0, 0.3, (n, 3)),
                  "joint_rot": g.normal(0, 0.05, (n, J - 1, 3)),
                  "betas": g.normal(0, 0.3, (n, B)), "trans": g.normal(0, 0.05, (n, 3))}
        params = {k: v.astype(np.float32) for k, v in params.items()}
        vis = (g.random((n, V, J)) < traffic["visible"]) & mask[..., None]
        joints = np.empty((n, J, 3), np.float32)
        f32 = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        with torch.no_grad():
            for lo in range(0, n, SMIL_CHUNK):
                sl = slice(lo, lo + SMIL_CHUNK)
                theta = torch.cat([f32(params["global_rot"][sl])[:, None],
                                   f32(params["joint_rot"][sl])], 1)
                _, j = smil.smil_forward(m, f32(params["betas"][sl]), theta,
                                         trans=f32(params["trans"][sl]))
                joints[sl] = j.cpu().numpy()
        Rf, tf, Kf = R[ids], t[ids], K[ids]                              # (n, V, ...)
        cam = np.einsum("nvij,nkj->nvki", Rf, joints.astype(np.float64)) + tf[:, :, None]
        uv = cam[..., :2] / cam[..., 2:] * Kf[:, :, None, [0, 1], [0, 1]] + Kf[:, :, None, :2, 2]
        gen = torch.Generator(device=device).manual_seed((int(seed) + FRAMES) % (1 << 63))
        images = torch.randint(0, 256, (n, V, res, res, 3), dtype=torch.uint8, generator=gen,
                               device=device)
        images *= torch.as_tensor(mask, device=device)[:, :, None, None, None]
        self.cols = {
            "images": images.cpu().numpy(),
            "view_mask": mask,
            "camera_indices": ids.astype(np.int32),
            "camera_intrinsics": Kf.astype(np.float32),
            "camera_extrinsics_R": Rf.astype(np.float32),
            "camera_extrinsics_t": tf.astype(np.float32),
            "keypoints_2d": (uv * mask[..., None, None]).astype(np.float32),
            "keypoint_visibility": vis.astype(np.float32),
            "keypoints_3d": joints,
            **params,
        }
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.cols.items()}

    def batch(self, idx, device) -> dict:
        """Rows ``idx`` as device tensors, images float32 in [0, 1] (times
        the float32 reciprocal of 255)."""
        out = {k: torch.as_tensor(v[idx], device=device) for k, v in self.cols.items()}
        out["images"] = out["images"].float() * (1.0 / 255.0)
        return out


def weights(cfg: dict, seed: int, device) -> dict:
    """Every tensor of :func:`portbench.reference.multiview.layout`."""
    J, B = cfg["model"]["J"], cfg["model"]["B"]
    spec = ref_mv.layout(cfg, J, B)
    drawn = [(k, s, kind) for k, s, kind in spec if kind in ("linear", "head", "token", "embed")]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=gen, device=device)
    out, off = {}, 0
    for k, s, kind in spec:
        if kind in ("linear", "head", "token", "embed"):
            n, fan_in = math.prod(s), math.prod(s[1:])
            lecun = math.sqrt(1.0 / fan_in)
            std = {"linear": lecun, "head": inputs.HEAD_SCALE * lecun, "token": TOKEN_STD,
                   "embed": math.sqrt(1.0 / s[-1])}[kind]
            out[k] = flat[off:off + n].view(s) * std
            off += n
        elif kind == "init_estimate":
            out[k] = ref_mv.initial_estimate(J, B).to(device)
        else:
            out[k] = (torch.ones if kind == "one" else torch.zeros)(s, device=device)
    return out


def multiview_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The mesh (numpy and torch), the frames and the weights of the cell."""
    mesh_np = inputs.mesh(cfg["model"], seed)
    m = smil.to_torch(mesh_np, device)
    return {"mesh_np": mesh_np, "m": m, "frames": Frames(cfg, traffic, m, seed, device),
            "weights": weights(cfg, seed, device)}
