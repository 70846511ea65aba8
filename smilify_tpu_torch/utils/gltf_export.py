"""Headless glTF 2.0 export of SMIL models and inference animations (port of
``smilify_tpu/utils/gltf_export.py``: numpy and scipy on the host, the
spec's tensors read through host copies; the file it writes is the JAX
package's byte for byte but for ``asset.generator``).

The reference covers this workflow with two interactive Blender operators:
``SMPL_OT_ImportAnimation`` (3D_model_prep/SMIL_processing_addon.py:3442 —
drives a rig from an inference ``.npz`` + sidecar) followed by
``SMPL_OT_ExportAnimationGLTF`` (:3697 — round-trips the scene through
Blender's glTF exporter). Here the same contract is a single pure-python
function: model ``.pkl`` + animation ``.npz`` → a self-contained ``.glb``
with the skinned mesh, skeleton, and per-frame animation — no Blender, no
GUI, usable from a headless training host.

Fidelity notes (each mirrored from the LBS semantics in ``core/lbs.py``):

* **hierarchy mode** (default when no per-joint scales are animated): a real
  parent/child skeleton. Each joint node's local transform is
  ``T(J_i − J_parent + offs_i) · R_i`` which composes to exactly the FK chain
  of ``global_rigid_transformation`` (lbs.py:97-179); the world translation
  folds into the root joint's animated translation. Inverse bind matrices are
  ``T(−J_i)`` — the glTF skin matrix ``G_i · ibm_i`` then equals the
  reference's relative skinning transform ``A = results − init_bone``
  (smal_torch ``batch_lbs.py:188-195``).
* **flat mode** (auto-selected when ``log_beta_scales`` animate): SMIL's
  scale-cancel convention makes joint *local* transforms contain shear
  (``S_par⁻¹·R·S``), which glTF node TRS cannot represent — but the *global*
  transforms telescope to ``R_chain · diag(s_i)`` (for unit root scale), which
  is exactly TRS-decomposable. So joints become siblings of an animated root
  and each carries its polar-decomposed global TRS per frame. Any residual
  shear (non-unit root scale, or ``propagate_scaling=True`` chains) is
  measured and reported, not silently dropped.
* **shape**: clip-averaged betas are baked into the bind mesh and rest
  skeleton (the Blender importer does the same, addon:3526-3533). When the
  animation carries varying ``betas_per_frame`` *and* the model has static
  joint locations, betas export as animated glTF morph targets instead —
  one target per shape component, weights keyframed per frame (the addon's
  per-frame shape-key path; forced off otherwise, matching its
  ``static_shape`` forcing rule, addon:3455-3462).
* **pose correctives** (``posedirs``) have no glTF equivalent and are not
  exported; a warning reports their magnitude when non-zero.

The output is deliberately viewer-friendly: smooth vertex normals, unit
quaternions with sign continuity, LINEAR samplers, POSITION min/max bounds.
"""

from __future__ import annotations

import json
import struct
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from smilify_tpu_torch._device import to_host

_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

# Unreal convention: per-joint translation offsets are y-flipped before use
# (core/lbs.py:43, reference batch_lbs.py:146-148).
_UNREAL_Y_FLIP = np.array([1.0, -1.0, 1.0], np.float32)


# --------------------------------------------------------------------------- math


def _axis_angle_to_quat(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle → (..., 4) glTF-order (x, y, z, w) unit quaternions."""
    from scipy.spatial.transform import Rotation

    flat = aa.reshape(-1, 3).astype(np.float64)
    q = Rotation.from_rotvec(flat).as_quat()  # scipy order is (x, y, z, w)
    return q.reshape(aa.shape[:-1] + (4,)).astype(np.float32)


def _quat_continuity(quats: np.ndarray) -> np.ndarray:
    """Flip signs along the frame axis so consecutive quats interpolate the
    short way (q and −q are the same rotation)."""
    out = quats.copy()
    for f in range(1, out.shape[0]):
        dots = np.sum(out[f] * out[f - 1], axis=-1, keepdims=True)
        out[f] = np.where(dots < 0.0, -out[f], out[f])
    return out


def _numpy_fk(
    Rs: np.ndarray,
    Js: np.ndarray,
    parents: np.ndarray,
    log_scales: Optional[np.ndarray],
    joint_trans: Optional[np.ndarray],
    propagate_scaling: bool,
) -> np.ndarray:
    """Host-side mirror of ``global_rigid_transformation`` (core/lbs.py:97-179)
    returning the absolute per-joint (J, 4, 4) chain products ``results`` (the
    pre-``init_bone`` form)."""
    J = Js.shape[0]
    scales = np.exp(log_scales) if log_scales is not None else np.ones((J, 3))
    inv_scales = np.ones_like(scales) if propagate_scaling else 1.0 / scales
    offs = joint_trans * _UNREAL_Y_FLIP if joint_trans is not None else np.zeros((J, 3))

    parent_inv = inv_scales[parents]
    rot_scaled = Rs * parent_inv[:, :, None] * scales[:, None, :]
    j_offsets = Js - Js[parents] + offs

    results = np.zeros((J, 4, 4))
    results[0, :3, :3] = Rs[0]
    results[0, :3, 3] = Js[0]
    results[0, 3, 3] = 1.0
    for i in range(1, J):
        local = np.eye(4)
        local[:3, :3] = rot_scaled[i]
        local[:3, 3] = j_offsets[i]
        results[i] = results[parents[i]] @ local
    return results


def _polar_trs(G: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(4,4) → translation (3,), rotation quat (4,) xyzw, scale (3,), shear
    residual (relative Frobenius norm of the non-diagonal polar factor)."""
    from scipy.spatial.transform import Rotation

    L = G[:3, :3]
    u, s, vt = np.linalg.svd(L)
    # proper rotation: push any reflection into the scale factor
    det = np.linalg.det(u @ vt)
    d = np.ones(3)
    d[-1] = np.sign(det) if det != 0 else 1.0
    Q = u @ np.diag(d) @ vt
    P = vt.T @ np.diag(s * d) @ vt  # symmetric factor, L = Q @ P
    scale = np.diag(P).copy()
    shear = float(np.linalg.norm(P - np.diag(scale)) / max(np.linalg.norm(P), 1e-12))
    quat = Rotation.from_matrix(Q).as_quat()
    return G[:3, 3].copy(), quat.astype(np.float32), scale.astype(np.float32), shear


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def _top4_skin(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(V, J) dense LBS weights → glTF JOINTS_0 (V,4) ushort + WEIGHTS_0
    (V,4) float32, renormalized over the kept entries."""
    V = weights.shape[0]
    top = np.argsort(-weights, axis=1)[:, :4]
    w = np.take_along_axis(weights, top, axis=1).astype(np.float64)
    total = w.sum(axis=1, keepdims=True)
    dead = total[:, 0] <= 0.0
    if dead.any():  # degenerate rows: bind fully to the root
        w[dead] = 0.0
        w[dead, 0] = 1.0
        top[dead] = 0
        total[dead] = 1.0
    w = w / total
    return top.astype(np.uint16), w.astype(np.float32)


# --------------------------------------------------------------------------- buffer builder


class _BinBuilder:
    """Accumulates the GLB binary chunk and its bufferViews/accessors."""

    _CTYPE = {np.float32: 5126, np.uint32: 5125, np.uint16: 5123, np.uint8: 5121}
    _NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

    def __init__(self):
        self.blob = bytearray()
        self.buffer_views: List[Dict] = []
        self.accessors: List[Dict] = []

    def add(self, array: np.ndarray, kind: str, *, target: Optional[int] = None,
            minmax: bool = False) -> int:
        """Append `array` (frames-major, C-contiguous) and return its accessor id."""
        arr = np.ascontiguousarray(array)
        ctype = self._CTYPE[arr.dtype.type]
        ncomp = self._NCOMP[kind]
        count = arr.size // ncomp

        while len(self.blob) % 4:
            self.blob.append(0)
        view = {"buffer": 0, "byteOffset": len(self.blob), "byteLength": arr.nbytes}
        if target is not None:
            view["target"] = target
        self.blob.extend(arr.tobytes())
        self.buffer_views.append(view)

        acc = {
            "bufferView": len(self.buffer_views) - 1,
            "componentType": ctype,
            "count": count,
            "type": kind,
        }
        if minmax:
            flat = arr.reshape(count, ncomp)
            acc["min"] = [float(v) for v in flat.min(axis=0)]
            acc["max"] = [float(v) for v in flat.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1


# --------------------------------------------------------------------------- animation parsing


def _parse_animation(data: Dict[str, np.ndarray], sidecar: Dict, n_joints: int):
    """Normalize the AMASS-style npz payload (utils/animation_export.py) into
    per-frame arrays shaped for export."""
    poses = np.asarray(data["poses"], np.float64)
    F = poses.shape[0]
    P = (poses.shape[1] - 3) // 3
    if P != n_joints - 1:
        raise ValueError(
            f"animation has {P} pose joints but the model has {n_joints - 1} "
            "(n_joints − root); wrong model for this clip?"
        )
    theta = np.concatenate(
        [poses[:, :3].reshape(F, 1, 3), poses[:, 3:].reshape(F, P, 3)], axis=1
    )  # (F, J, 3) axis-angle, root first
    trans = np.asarray(data["trans"], np.float64).reshape(F, 3)

    betas = np.asarray(data.get("betas", np.zeros(0)), np.float64).reshape(-1)
    betas_pf = data.get("betas_per_frame")
    if betas_pf is not None:
        betas_pf = np.asarray(betas_pf, np.float64).reshape(F, -1)

    scales = data.get("log_beta_scales")
    if scales is not None:
        scales = np.asarray(scales, np.float64).reshape(F, n_joints, 3)
        if np.allclose(scales, 0.0):
            scales = None
    jtrans = data.get("betas_trans")
    if jtrans is not None:
        jtrans = np.asarray(jtrans, np.float64).reshape(F, n_joints, 3)
        if np.allclose(jtrans, 0.0):
            jtrans = None

    fps = float(np.asarray(data.get("mocap_framerate", sidecar.get("fps", 30.0))).reshape(()))
    return theta, trans, betas, betas_pf, scales, jtrans, fps


# --------------------------------------------------------------------------- export


def export_animation_gltf(
    spec,
    animation: Dict[str, np.ndarray],
    out_path: str,
    *,
    sidecar: Optional[Dict] = None,
    mode: str = "auto",
    apply_joint_scales: bool = True,
    static_shape: bool = False,
    propagate_scaling: bool = False,
    fps: Optional[float] = None,
) -> str:
    """Write a skinned, animated ``.glb`` for `animation` on `spec`.

    Args:
      spec: a :class:`~smilify_tpu_torch.core.spec.ModelSpec` (on any device).
      animation: dict of arrays as produced by
        :class:`~smilify_tpu_torch.utils.animation_export.AnimationRecorder`
        (``poses``/``trans``/``betas`` [+ ``betas_per_frame``,
        ``log_beta_scales``, ``betas_trans``, ``mocap_framerate``]).
      mode: ``"hierarchy"`` | ``"flat"`` | ``"auto"`` (flat only when
        per-joint scales animate — see module docstring).
      apply_joint_scales: honor ``log_beta_scales`` (addon's
        ``apply_joint_scales`` toggle, SMIL_processing_addon.py:3463-3467).
      static_shape: force clip-averaged betas even when ``betas_per_frame``
        is present (addon's ``static_shape`` toggle).
      propagate_scaling: FK scale convention (core/lbs.py propagate mode).

    Returns the written path.
    """
    sidecar = sidecar or {}
    J = spec.n_joints
    theta, trans, betas, betas_pf, scales, jtrans, anim_fps = _parse_animation(
        animation, sidecar, J
    )
    if fps is not None:
        anim_fps = float(fps)
    if not apply_joint_scales:
        scales = None
    F = theta.shape[0]

    v_template = to_host(spec.v_template).astype(np.float64)
    faces = to_host(spec.faces).astype(np.int64)
    shapedirs = to_host(spec.shapedirs).astype(np.float64)  # (B, 3V)
    n_betas_model = shapedirs.shape[0]

    posedirs = to_host(spec.posedirs)
    pose_mag = float(np.abs(posedirs).max()) if posedirs.size else 0.0
    if pose_mag > 0.0:
        warnings.warn(
            f"model has pose correctives (|posedirs|max={pose_mag:.2e}) which glTF "
            "cannot represent; the exported mesh skins without them",
            stacklevel=2,
        )

    # ---- shape: bake averaged betas, or emit morph targets for per-frame shape
    betas_avg = betas_pf.mean(axis=0) if betas_pf is not None else betas
    betas_avg = betas_avg[:n_betas_model]
    animate_shape = (
        betas_pf is not None
        and not static_shape
        and spec.static_joint_locations  # addon forces static shape otherwise
        and n_betas_model > 0
    )
    if betas_pf is not None and not spec.static_joint_locations and not static_shape:
        warnings.warn(
            "betas_per_frame present but the model regresses joints from shape; "
            "falling back to clip-averaged betas (the Blender importer forces the "
            "same, SMIL_processing_addon.py:3455-3462)",
            stacklevel=2,
        )

    if animate_shape:
        v_bind = v_template  # morph targets carry the deltas
    else:
        dv = (betas_avg @ shapedirs[: betas_avg.shape[0]]).reshape(-1, 3) if betas_avg.size else 0.0
        v_bind = v_template + dv

    # rest joints from the bind mesh (static models pin them; addon recomputes
    # once from the averaged shape otherwise)
    if spec.static_joint_locations:
        Js = to_host(spec.joints_rest).astype(np.float64)
    else:
        Js = (v_bind.T @ to_host(spec.J_regressor).astype(np.float64)).T

    parents = np.asarray(spec.parents, np.int64)
    joint_names = list(spec.joint_names) or [f"joint_{i}" for i in range(J)]

    if mode == "auto":
        mode = "flat" if scales is not None else "hierarchy"
    if mode == "hierarchy" and scales is not None:
        raise ValueError(
            "hierarchy mode cannot represent per-joint scales exactly under the "
            "scale-cancel convention (shear in local transforms); use mode='flat' "
            "or apply_joint_scales=False"
        )

    # ---- per-frame node animation data
    from scipy.spatial.transform import Rotation  # noqa: F401  (dependency check)

    times = (np.arange(F) / anim_fps).astype(np.float32)

    if mode == "hierarchy":
        node_rot = _quat_continuity(_axis_angle_to_quat(theta))        # (F, J, 4)
        rest_local = Js - Js[parents]
        rest_local[0] = Js[0]
        node_tr = np.broadcast_to(rest_local, (F, J, 3)).copy()
        if jtrans is not None:
            node_tr[:, 1:] = node_tr[:, 1:] + jtrans[:, 1:] * _UNREAL_Y_FLIP
        node_tr[:, 0] = Js[0] + trans                                   # world trans on root
        node_tr = node_tr.astype(np.float32)
        node_scale = None
        max_shear = 0.0
    else:
        Rs = Rotation.from_rotvec(theta.reshape(-1, 3)).as_matrix().reshape(F, J, 3, 3)
        node_tr = np.empty((F, J, 3), np.float32)
        node_rot = np.empty((F, J, 4), np.float32)
        node_scale = np.empty((F, J, 3), np.float32)
        max_shear = 0.0
        for f in range(F):
            G = _numpy_fk(
                Rs[f], Js, parents,
                scales[f] if scales is not None else None,
                jtrans[f] if jtrans is not None else None,
                propagate_scaling,
            )
            for i in range(J):
                t, q, s, shear = _polar_trs(G[i])
                node_tr[f, i] = t + trans[f]  # flat joints live in world space
                node_rot[f, i] = q
                node_scale[f, i] = s
                max_shear = max(max_shear, shear)
        node_rot = _quat_continuity(node_rot)
        if max_shear > 1e-4:
            warnings.warn(
                f"FK globals contain shear (max relative residual {max_shear:.2e}) "
                "that glTF TRS nodes drop — non-unit root scale or propagate-scaling "
                "chains are only approximated",
                stacklevel=2,
            )

    # ---- binary payload
    b = _BinBuilder()
    pos_acc = b.add(v_bind.astype(np.float32), "VEC3", target=34962, minmax=True)
    nrm_acc = b.add(_vertex_normals(v_bind, faces), "VEC3", target=34962)
    dense_w = to_host(spec.weights).astype(np.float64)
    dropped = np.sort(dense_w, axis=1)[:, ::-1][:, 4:].sum(axis=1).max() if dense_w.shape[1] > 4 else 0.0
    if dropped > 1e-6:
        warnings.warn(
            f"glTF skins carry 4 influences per vertex; truncation drops up to "
            f"{dropped:.2e} weight mass on this model",
            stacklevel=2,
        )
    jnt_ids, jnt_w = _top4_skin(dense_w)
    joints_acc = b.add(jnt_ids, "VEC4", target=34962)
    weights_acc = b.add(jnt_w, "VEC4", target=34962)
    idx_dtype = np.uint16 if v_bind.shape[0] < 65536 else np.uint32
    idx_acc = b.add(faces.astype(idx_dtype).reshape(-1), "SCALAR", target=34963)

    # inverse bind matrices: T(−J_i); glTF matrices are column-major
    ibm = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    ibm[:, :3, 3] = -Js
    ibm_acc = b.add(np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(J, 16), "MAT4")

    time_acc = b.add(times, "SCALAR", minmax=True)

    # ---- nodes
    # node 0: named root empty (the addon parents everything under
    # SMIL_Animation_Root, SMIL_processing_addon.py:3715); node 1: skinned
    # mesh; nodes 2..2+J: joints.
    first_joint = 2
    joint_nodes = list(range(first_joint, first_joint + J))
    nodes: List[Dict] = [
        {"name": "SMIL_Animation_Root", "children": [1, first_joint]},
        {"name": "SMIL_Mesh", "mesh": 0, "skin": 0},
    ]
    for i in range(J):
        # Rest-pose TRS on every joint node: consumers that never sample the
        # animation (static viewers, bind-pose extraction) must still see the
        # skeleton posed — without this the joints sit at identity and the
        # skin matrices collapse to T(-J). Animation channels override these
        # during playback.
        node: Dict = {"name": joint_names[i]}
        if mode == "hierarchy":
            rest_t = node_tr[0, i] if i == 0 else rest_local[i]
            node["translation"] = [float(v) for v in rest_t]
            kids = [int(first_joint + c) for c in np.nonzero(parents == i)[0] if c != 0]
            if kids:
                node["children"] = kids
        else:
            node["translation"] = [float(v) for v in node_tr[0, i]]
            node["rotation"] = [float(v) for v in node_rot[0, i]]
            if node_scale is not None:
                node["scale"] = [float(v) for v in node_scale[0, i]]
        nodes.append(node)
    if mode == "flat":
        nodes[0]["children"] = [1] + joint_nodes

    # ---- animation channels
    samplers: List[Dict] = []
    channels: List[Dict] = []

    def channel(node_id: int, path: str, out_acc: int):
        samplers.append({"input": time_acc, "output": out_acc, "interpolation": "LINEAR"})
        channels.append(
            {"sampler": len(samplers) - 1, "target": {"node": node_id, "path": path}}
        )

    for i in range(J):
        channel(first_joint + i, "rotation", b.add(node_rot[:, i], "VEC4"))
        channel(first_joint + i, "translation", b.add(node_tr[:, i], "VEC3"))
        if node_scale is not None:
            channel(first_joint + i, "scale", b.add(node_scale[:, i], "VEC3"))

    # ---- mesh (+ optional morph targets)
    primitive: Dict = {
        "attributes": {
            "POSITION": pos_acc,
            "NORMAL": nrm_acc,
            "JOINTS_0": joints_acc,
            "WEIGHTS_0": weights_acc,
        },
        "indices": idx_acc,
        "material": 0,
        "mode": 4,
    }
    mesh: Dict = {"name": "SMIL", "primitives": [primitive]}
    if animate_shape:
        targets = []
        for k in range(n_betas_model):
            tgt = shapedirs[k].reshape(-1, 3).astype(np.float32)
            targets.append({"POSITION": b.add(tgt, "VEC3", target=34962, minmax=True)})
        primitive["targets"] = targets
        # mesh.weights length must equal the morph-target count; pad like the
        # animated weights-per-frame channel below.
        mesh["weights"] = [float(v) for v in betas_avg] + [0.0] * (
            n_betas_model - len(betas_avg)
        )
        wpf = np.zeros((F, n_betas_model), np.float32)
        wpf[:, : betas_pf.shape[1]] = betas_pf[:, :n_betas_model]
        channel(1, "weights", b.add(wpf.reshape(-1), "SCALAR"))

    gltf = {
        "asset": {
            "version": "2.0",
            "generator": "smilify_tpu_torch.utils.gltf_export",
        },
        "scene": 0,
        "scenes": [{"name": "SMIL_Animation", "nodes": [0]}],
        "nodes": nodes,
        "meshes": [mesh],
        "skins": [
            {
                "name": "SMIL_Skeleton",
                "joints": joint_nodes,
                "inverseBindMatrices": ibm_acc,
                # glTF 2.0 requires `skeleton` to be a common root of the
                # joints; in flat mode the joints are siblings, so the shared
                # scene root (node 0) is the only valid choice.
                "skeleton": first_joint if mode == "hierarchy" else 0,
            }
        ],
        "materials": [
            {
                "name": "SMIL_Material",
                "pbrMetallicRoughness": {
                    "baseColorFactor": [0.74, 0.68, 0.6, 1.0],
                    "metallicFactor": 0.0,
                    "roughnessFactor": 0.8,
                },
                "doubleSided": True,
            }
        ],
        "animations": [
            {"name": "SMIL_Inference", "samplers": samplers, "channels": channels}
        ],
        "buffers": [{"byteLength": 0}],  # patched below
        "bufferViews": b.buffer_views,
        "accessors": b.accessors,
        "extras": {
            "smilify_tpu": {
                "mode": mode,
                "fps": anim_fps,
                "num_frames": F,
                "model": spec.source_path,
                "static_joint_locations": bool(spec.static_joint_locations),
                "animate_shape": bool(animate_shape),
                "max_shear_residual": max_shear,
                "schema": sidecar.get("schema_version", ""),
            }
        },
    }

    # ---- GLB container
    while len(b.blob) % 4:
        b.blob.append(0)
    gltf["buffers"][0]["byteLength"] = len(b.blob)
    payload = json.dumps(gltf, separators=(",", ":")).encode()
    while len(payload) % 4:
        payload += b" "
    total = 12 + 8 + len(payload) + 8 + len(b.blob)
    out = out_path if out_path.endswith((".glb", ".gltf")) else out_path + ".glb"
    with open(out, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(payload), _CHUNK_JSON))
        f.write(payload)
        f.write(struct.pack("<II", len(b.blob), _CHUNK_BIN))
        f.write(bytes(b.blob))
    return out


def load_glb(path: str) -> Tuple[Dict, bytes]:
    """Parse a .glb container back into (gltf json dict, binary chunk)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, total = struct.unpack_from("<III", raw, 0)
    if magic != _MAGIC or version != 2:
        raise ValueError(f"{path}: not a glTF 2.0 binary")
    if total != len(raw):
        raise ValueError(f"{path}: declared length {total} != file size {len(raw)}")
    off = 12
    gltf = None
    blob = b""
    while off < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        off += 8
        chunk = raw[off : off + clen]
        off += clen
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode())
        elif ctype == _CHUNK_BIN:
            blob = chunk
    if gltf is None:
        raise ValueError(f"{path}: missing JSON chunk")
    return gltf, blob


_DTYPES = {5126: np.float32, 5125: np.uint32, 5123: np.uint16, 5121: np.uint8}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def read_accessor(gltf: Dict, blob: bytes, acc_id: int) -> np.ndarray:
    """Decode accessor `acc_id` from a parsed glb (tightly-packed views only,
    which is all this exporter writes)."""
    acc = gltf["accessors"][acc_id]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _DTYPES[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    count = acc["count"] * ncomp
    arr = np.frombuffer(blob, dtype=dtype, count=count, offset=start)
    if ncomp > 1:
        arr = arr.reshape(acc["count"], ncomp)
    return arr
