"""SMIL/SMAL forward: blendshapes → joint regression → kinematic chain →
skinning (port of ``smilify_tpu/core/lbs.py``).

* shape/pose blendshapes are single matmuls over a (B, 3V) basis;
* the parent-chain forward kinematics runs as **pointer jumping** (a
  parallel prefix over the kintree): ⌈log₂(depth)⌉ rounds of batched 4×4
  products with a jump schedule precomputed from the static parent tuple,
  instead of J−1 serially dependent products — the backward pass is
  log-depth too. Per-joint log-scales and per-joint translation offsets
  (Unreal y-flip) fold into the per-joint local transforms before the jumps;
* skinning uses the relative ``A = results − init_bone`` transforms, applied
  as one (V, J) × (J, 16) matmul.

Every function takes an explicit leading batch axis N (the JAX package
vmaps a single-sample function instead). Matmuls run in full float32: the
card's TF32 matmul mode is off by default and callers must keep it off.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from smilify_tpu_torch._device import shared_constant
from smilify_tpu_torch.core.rotations import rodrigues
from smilify_tpu_torch.core.spec import LEGACY_DOG_EXTRA_VERTEX_IDS, ModelSpec

# Unreal convention: per-joint translation offsets have their y axis flipped.
_UNREAL_Y_FLIP = (1.0, -1.0, 1.0)
_BOTTOM_ROW = (0.0, 0.0, 0.0, 1.0)     # of each joint's homogeneous 4x4


class SmilOutputs(NamedTuple):
    verts: torch.Tensor          # (N, V, 3) skinned vertices (+trans)
    joints: torch.Tensor         # (N, K, 3) joint / keypoint locations
    Rs: torch.Tensor             # (N, J, 3, 3) per-joint rotation matrices
    v_shaped: torch.Tensor       # (N, V, 3) shape-blendshaped template
    j_transformed: torch.Tensor  # (N, J, 3) FK joint locations (pre trans)


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3)."""
    return rodrigues(theta)


@functools.lru_cache(maxsize=32)
def _jump_schedule(parents_key: tuple):
    """Pointer-jumping schedule for a static parent array.

    Returns a tuple of (idx, mask) rounds: with per-joint segment products
    M[i] = A_local[i] and remaining ancestor anc[i] = parent[i] (root: done),
    each round performs ``M[i] ← M[idx[i]] @ M[i] where mask[i]`` and doubles
    the jump distance. ⌈log₂(max depth)⌉ rounds complete every chain."""
    parents = np.asarray(parents_key, dtype=np.int64)
    J = parents.shape[0]
    anc = parents.copy()
    anc[0] = -1  # root segment is already complete
    rounds = []
    # depth ≤ J, so ≤ ⌈log₂(J)⌉+1 rounds; more means a cyclic kintree
    max_rounds = int(np.ceil(np.log2(max(J, 2)))) + 1
    while np.any(anc >= 0):
        if len(rounds) >= max_rounds:
            raise ValueError(
                f"kintree parent array is cyclic (no topological order): {parents}"
            )
        idx = np.maximum(anc, 0)
        mask = anc >= 0
        rounds.append((tuple(int(v) for v in idx), tuple(bool(v) for v in mask)))
        anc = np.where(mask, anc[idx], -1)
    return tuple(rounds)


@functools.lru_cache(maxsize=32)
def _kintree_tensors(parents_key: tuple, device: torch.device):
    """The parent ids and the :func:`_jump_schedule` rounds as tensors on
    ``device``, made once per kintree and device."""
    rounds = tuple(
        (torch.tensor(idx, dtype=torch.int64, device=device),
         torch.tensor(mask, dtype=torch.bool, device=device)[:, None, None])
        for idx, mask in _jump_schedule(parents_key)
    )
    return torch.tensor(parents_key, dtype=torch.int64, device=device), rounds


def global_rigid_transformation(
    Rs: torch.Tensor,
    Js: torch.Tensor,
    parents: Sequence[int],
    log_scales: Optional[torch.Tensor] = None,
    trans_offsets: Optional[torch.Tensor] = None,
    propagate_scaling: bool = False,
):
    """Batched forward kinematics over the kintree.

    Args:
      Rs: (N, J, 3, 3) per-joint rotations.
      Js: (N, J, 3) rest joint locations.
      parents: (J,) parent ids (root's entry unused), a sequence of ints.
      log_scales: optional (N, J, 3) per-joint per-axis log scale factors.
      trans_offsets: optional (N, J, 3) per-joint translation offsets
        (y-flipped internally, Unreal convention).
      propagate_scaling: if True, parent scale is NOT cancelled (scales
        compound down the chain); if False applies S_parent⁻¹·R·S_joint.

    Returns:
      new_J: (N, J, 3) posed joint locations.
      A: (N, J, 4, 4) relative skinning transforms (final − init bone).
    """
    N, J = Rs.shape[0], Rs.shape[1]
    dtype, device = Rs.dtype, Rs.device
    p, rounds = _kintree_tensors(tuple(int(i) for i in parents), device)

    scales = torch.exp(log_scales) if log_scales is not None else torch.ones(
        (N, J, 3), dtype=dtype, device=device)
    inv_scales = torch.ones_like(scales) if propagate_scaling else 1.0 / scales
    if trans_offsets is not None:
        offs = trans_offsets * shared_constant(_UNREAL_Y_FLIP, dtype, device)
    else:
        offs = torch.zeros((N, J, 3), dtype=dtype, device=device)

    # rot_new[i] = diag(1/s[parent]) @ R[i] @ diag(s[i]) — as row/col scaling
    rot_scaled = Rs * inv_scales[:, p][..., :, None] * scales[..., None, :]
    j_offsets = Js - Js[:, p] + offs

    # the root keeps its raw rotation and rest location (scale adjustment
    # applies only below the root)
    rot_local = torch.cat([Rs[:, :1], rot_scaled[:, 1:]], dim=1)
    off_local = torch.cat([Js[:, :1], j_offsets[:, 1:]], dim=1)
    tops = torch.cat([rot_local, off_local[..., None]], dim=-1)           # (N, J, 3, 4)
    bottom = shared_constant(_BOTTOM_ROW, dtype, device)
    A_local = torch.cat([tops, bottom.expand(N, J, 1, 4)], dim=-2)       # (N, J, 4, 4)

    # pointer jumping: log₂(depth) rounds of batched 4x4 chain products
    results = A_local
    for idx, mask in rounds:
        results = torch.where(mask, torch.matmul(results[:, idx], results), results)

    new_J = results[..., :3, 3]
    # A = results − pad(results @ [J_rest; 0]) — skinning uses bone *motion*
    init_bone = torch.einsum("njab,njb->nja", results[..., :3], Js)      # (N, J, 4)
    A = torch.cat([results[..., :3], (results[..., 3] - init_bone)[..., None]], dim=-1)
    return new_J, A


def smil_forward(
    spec: ModelSpec,
    beta: torch.Tensor,
    theta: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
    del_v: Optional[torch.Tensor] = None,
    log_scales: Optional[torch.Tensor] = None,
    joint_trans: Optional[torch.Tensor] = None,
    v_template: Optional[torch.Tensor] = None,
    propagate_scaling: bool = False,
) -> SmilOutputs:
    """Batched SMIL forward.

    Args (N = batch):
      beta: (N, B) shape coefficients (B may be < spec.n_betas; 0 allowed).
      theta: (N, J, 3) axis-angle (root first) or (N, J, 3, 3) matrices.
      trans: (N, 3) global translation (defaults to zero).
      del_v: (N, V, 3) per-vertex offsets.
      log_scales: (N, J, 3) per-joint log scales (limb scaling).
      joint_trans: (N, J, 3) per-joint translation offsets (Unreal y-flip applied).
      v_template: (N, V, 3) per-sample template override.
      propagate_scaling: propagate parent scales instead of cancelling.
    """
    N = theta.shape[0]
    V, J = spec.n_verts, spec.n_joints
    base = spec.v_template[None] if v_template is None else v_template

    # 1. shape blendshapes
    n_b = beta.shape[1]
    if n_b > 0:
        v_shaped = base + torch.matmul(beta, spec.shapedirs[:n_b]).reshape(N, V, 3)
    else:
        v_shaped = base.expand(N, V, 3)
    if del_v is not None:
        v_shaped = v_shaped + del_v

    # 2. joints from shape (or static)
    if spec.static_joint_locations:
        Js = spec.joints_rest.expand(N, J, 3)
    else:
        Js = torch.einsum("nvc,vj->njc", v_shaped, spec.J_regressor)

    # 3. pose rotations + pose blendshapes
    Rs = theta if theta.ndim == 4 else rodrigues(theta)
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    pose_feature = (Rs[:, 1:] - eye).reshape(N, -1)                     # (N, 9(J-1))
    v_posed = v_shaped + torch.matmul(pose_feature, spec.posedirs).reshape(N, V, 3)

    # 4. FK
    j_transformed, A = global_rigid_transformation(
        Rs, Js, spec.parents, log_scales, joint_trans, propagate_scaling
    )

    # 5. skinning: one (V,J)@(J,16) matmul then per-vertex affine apply
    T = torch.matmul(spec.weights, A.reshape(N, J, 16)).reshape(N, V, 4, 4)
    verts = torch.einsum("nvab,nvb->nva", T[..., :3, :3], v_posed) + T[..., :3, 3]
    if trans is not None:
        verts = verts + trans[:, None, :]

    # 6. joints: static → FK results; else re-regress from skinned verts.
    # NOTE reference quirk preserved: in the static path the returned joints
    # do NOT include `trans`; callers like the fitter add translation themselves.
    if spec.static_joint_locations:
        joints = j_transformed
    else:
        joints = torch.einsum("nvc,vj->njc", verts, spec.J_regressor)

    if spec.legacy_dog_keypoints:
        extra = verts[:, list(LEGACY_DOG_EXTRA_VERTEX_IDS)]
        joints = torch.cat([joints, extra], dim=1)

    return SmilOutputs(verts, joints, Rs, v_shaped, j_transformed)
