"""Every input of a run, made from ``--seed`` by the benchmark itself and
handed alike to the program and to the reference.

* the SMIL mesh: :func:`portbench.reference.smil.procedural_mesh`, its
  shape directions from the seed;
* fit targets: SMILify-on-TPU's ``synthetic_poses`` rule (the head-on root
  turned by up to ±0.15 rad, every other joint by up to ±0.06, betas
  mean + 0.3·U(−½, ½), trans ±0.05) for one fixed set of poses, put in an
  order drawn from the seed, posed by the reference SMIL forward,
  seen by the default camera at fov 60 and rendered by the reference's
  exact raster to a binary silhouette (alpha > ½) plus (row, col) joints;
* the regressor's samples: uint8 NHWC noise images drawn on the device by a
  ``torch.Generator`` and kept on the host, with SMIL targets (small seeded
  rotations, betas and trans, keypoints in [0.2, 0.8]², all visible);
* the regressor's weights, on the device from a ``torch.Generator`` in one
  call: He-normal convolutions, LeCun-normal linear layers, the heads'
  layers at 0.01 of LeCun's scale (the estimate moves a little each
  iteration), unit norms but 0.1 on each residual branch's last BatchNorm,
  zero biases, the IEF start at its identity estimate; then each
  BatchNorm's running statistics set to the reference's batch statistics
  over the first 64 samples.

Seeds may be any non-negative integer: numpy streams take
``[seed, stream]``, the device generator ``seed mod 2⁶³``."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import fit as ref_fit
from portbench.reference import raster, smil
from portbench.reference import regressor as ref_reg

MESH, POSES, SAMPLES, ORDER, CHECK = 1, 2, 3, 4, 5       # numpy streams of one seed
POSE_SET = 0            # the seed of the fit's one set of target poses
# the last BatchNorm of each residual branch starts at this scale, so the
# residual stream does not double a block where the statistics do not
# normalize it (eval mode with its statistics at (0, 1))
RESIDUAL_GAMMA = 0.1
# the output heads' scale against LeCun's: each IEF iteration moves the
# estimate a little, so the 6D rotations stay near orthonormal pairs, as a
# trained model's are (at 0.05, 1% of the joints came out with their two
# vectors at a cosine over 0.92-0.996 and the worst at 0.999999, where
# Gram-Schmidt turns round-off into any rotation at all)
HEAD_SCALE = 0.01
# BatchNorm's running statistics: the reference's train-mode statistics over
# the first samples, so that eval mode normalizes as a trained model's does
BN_SAMPLES = 64


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def mesh(model: dict, seed: int) -> dict:
    return smil.procedural_mesh(model["V_side"], model["J"], model["B"], [int(seed), MESH])


def fit_targets(m: dict, n_frames: int, size, seed: int) -> dict:
    """sil (N, H, W) in {0, 1}, joints (N, J, 2) as (row, col), vis (N, J).
    The clip's poses are one fixed set (drawn from :data:`POSE_SET`), in
    an order drawn from ``seed``: every seed fits frames of the same sizes,
    so the raster's work does not change with the seed."""
    g = rng(POSE_SET, POSES)
    J, B = m["parents"].shape[0], m["shapedirs"].shape[0]
    theta = np.zeros((n_frames, J, 3))
    theta[:, 0] = ref_fit.head_on_rotation() + g.uniform(-0.15, 0.15, (n_frames, 3))
    theta[:, 1:] = g.uniform(-0.06, 0.06, (n_frames, J - 1, 3))
    betas = m["shape_mean_betas"].cpu().numpy()[None] + 0.3 * g.uniform(-0.5, 0.5, (n_frames, B))
    trans = g.uniform(-0.05, 0.05, (n_frames, 3))
    order = rng(seed, POSES).permutation(n_frames)
    theta, betas, trans = theta[order], betas[order], trans[order]
    dev = m["v_template"].device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    H, W = size
    with torch.no_grad():
        verts, joints = smil.smil_forward(m, f32(betas), f32(theta), trans=f32(trans))
        fov = torch.full((n_frames, 1), 60.0, device=dev)
        view = smil.to_view(verts)
        ndc = torch.cat([smil.to_ndc(view, fov), view[..., 2:]], -1)
        sil = raster.soft_silhouette(ndc, m["faces"], H, W)
        yx = smil.ndc_to_yx(smil.to_ndc(smil.to_view(joints), fov), H, W)
    return {"sil": (sil > 0.5).float(), "joints": yx, "vis": torch.ones((n_frames, J), device=dev)}


class Samples:
    """The regressor's samples as a dataset of dicts of numpy arrays
    (images uint8 (res, res, 3), targets float32), indexable and sized."""

    def __init__(self, n: int, res: int, J: int, B: int, seed: int, device):
        g = rng(seed, SAMPLES)
        gen = torch.Generator(device=device).manual_seed((int(seed) + SAMPLES) % (1 << 63))
        images = torch.randint(0, 256, (n, res, res, 3), dtype=torch.uint8, generator=gen,
                               device=device)
        self.cols = {
            "image": images.cpu().numpy(),
            "global_rot": g.normal(0, 0.3, (n, 3)).astype(np.float32),
            "joint_rot": g.normal(0, 0.05, (n, J - 1, 3)).astype(np.float32),
            "betas": g.normal(0, 0.3, (n, B)).astype(np.float32),
            "trans": g.normal(0, 0.05, (n, 3)).astype(np.float32),
            "keypoints_2d": g.uniform(0.2, 0.8, (n, J, 2)).astype(np.float32),
            "kp_visibility": np.ones((n, J), np.float32),
        }
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.cols.items()}

    def batch(self, idx, device) -> dict:
        """Rows ``idx`` as float32 device tensors, images in [0, 1]."""
        out = {k: torch.as_tensor(v[idx], device=device) for k, v in self.cols.items()}
        out["image"] = out["image"].float() / 255.0
        return out


def order_iter(n: int, seed: int, batch: int):
    """Sample indices of batch after batch: seeded shuffles of all ``n``
    samples, each cut into whole batches (the rest dropped, as the trainer's
    cache drops it), so a batch's rows all differ."""
    g, perm = rng(seed, ORDER), np.empty(0, np.int64)
    while True:
        if len(perm) < batch:
            perm = g.permutation(n)
        yield perm[:batch]
        perm = perm[batch:]


def regressor_weights(head: dict, J: int, B: int, seed: int, device) -> dict:
    """Every tensor of :func:`portbench.reference.regressor.layout`."""
    spec = ref_reg.layout(head, J, B)
    drawn = [(k, s, kind) for k, s, kind in spec if kind in ("conv", "linear", "head")]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=gen, device=device)
    out, off = {}, 0
    for k, s, kind in spec:
        if kind in ("conv", "linear", "head"):
            n, fan_in = math.prod(s), math.prod(s[1:])
            std = {"conv": math.sqrt(2.0 / fan_in), "linear": math.sqrt(1.0 / fan_in),
                   "head": HEAD_SCALE * math.sqrt(1.0 / fan_in)}[kind]
            out[k] = flat[off:off + n].view(s) * std
            off += n
        elif kind == "init_estimate":
            out[k] = ref_reg.initial_estimate(J, B).to(device)
        elif kind == "residual_gamma":
            out[k] = torch.full(s, RESIDUAL_GAMMA, device=device)
        elif kind == "count":
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[k] = (torch.ones if kind in ("one", "stat_var") else torch.zeros)(s, device=device)
    return out


def regressor_inputs(cfg: dict, seed: int, device) -> dict:
    """The mesh (numpy and torch), the samples and the weights of a
    regressor cell."""
    J, B = cfg["model"]["J"], cfg["model"]["B"]
    mesh_np = mesh(cfg["model"], seed)
    samples = Samples(cfg["cache_samples"], cfg["image_size"], J, B, seed, device)
    weights = regressor_weights(cfg["head"], J, B, seed, device)
    images = samples.batch(np.arange(min(BN_SAMPLES, len(samples))), device)["image"]
    stats = {}
    with torch.no_grad():
        ref_reg.backbone(weights, images, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"], weights[f"{name}.running_var"] = mean, var
    return {"mesh_np": mesh_np, "m": smil.to_torch(mesh_np, device), "samples": samples,
            "weights": weights}
