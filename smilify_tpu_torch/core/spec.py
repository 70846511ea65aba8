"""ModelSpec — the immutable, explicit model description (port of
``smilify_tpu/core/spec.py``).

A frozen dataclass of tensors plus static metadata, built once by
:func:`load_model_spec` (from a ``.pkl`` asset), :func:`spec_from_numpy`
(from arrays, e.g. the JAX package's spec carried across as numpy) or
:func:`toy_model_spec` (a procedural mesh), and passed explicitly through
every call chain. Unlike the JAX spec, the kintree ``parents`` is static host
metadata (a tuple): the forward kinematics schedule is built from it on the
host, so reading it never waits for the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.core.io import load_raw_model
from smilify_tpu_torch.core.symmetry import align_template_to_symmetry_axis

# Default torso-joint names used for stage-0 camera alignment on SMIL insect
# models and joints whose annotations are ignored.
DEFAULT_TORSO_JOINT_NAMES = ("b_a_1", "l_1_co_r", "l_1_co_l", "b_h", "ma_l", "ma_r")
DEFAULT_IGNORE_JOINT_NAMES = ("b_t", "b_a_4", "b_a_5")

# Legacy 35-joint quadruped (WLDO/SMAL dog) surface keypoints appended to the
# regressed joints.
LEGACY_DOG_EXTRA_VERTEX_IDS = (1863, 26, 2124, 150, 3055, 1097)

# tensor fields, in the order spec_from_numpy expects them
ARRAY_FIELDS = (
    "v_template", "faces", "shapedirs", "posedirs", "J_regressor", "weights",
    "joints_rest", "shape_mean_betas", "shape_cov", "scaledirs", "transdirs",
)


@dataclass(frozen=True)
class ModelSpec:
    # --- tensors (one device) ---
    v_template: torch.Tensor          # (V, 3) f32 — symmetry-aligned template
    faces: torch.Tensor               # (F, 3) int64
    shapedirs: torch.Tensor           # (B, 3V) f32 — betas @ shapedirs → Δverts
    posedirs: torch.Tensor            # (9(J-1), 3V) f32 — pose feature → Δverts
    J_regressor: torch.Tensor         # (V, J) f32 — verts.T @ Jr → joints
    weights: torch.Tensor             # (V, J) f32 — LBS skinning weights
    joints_rest: torch.Tensor         # (J, 3) f32 — rest joints (static-joint models)
    shape_mean_betas: torch.Tensor    # (B,) f32 — zeros when absent
    shape_cov: torch.Tensor           # (B, B) f32 — identity when absent
    scaledirs: Optional[torch.Tensor] = None   # (B, J, 3)
    transdirs: Optional[torch.Tensor] = None   # (B, J, 3)

    # --- static metadata ---
    parents: Tuple[int, ...] = ()     # (J,) parent joint ids (root → 0)
    joint_names: Tuple[str, ...] = ()
    n_verts: int = 0
    n_faces: int = 0
    n_joints: int = 0
    n_betas: int = 0
    static_joint_locations: bool = False
    has_shape_prior: bool = False
    legacy_dog_keypoints: bool = False
    root_joint: str = ""
    torso_joints: Tuple[int, ...] = ()
    ignore_joints: Tuple[int, ...] = ()
    left_inds: Tuple[int, ...] = ()
    right_inds: Tuple[int, ...] = ()
    center_inds: Tuple[int, ...] = ()
    source_path: str = ""

    @property
    def n_pose(self) -> int:
        """Number of posable joints excluding the root."""
        return self.n_joints - 1

    @property
    def total_keypoints(self) -> int:
        return self.n_joints + (6 if self.legacy_dog_keypoints else 0)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "ModelSpec":
        """The same spec with every tensor on ``device``."""
        dev = resolve_device(device)
        moved = {
            f: getattr(self, f).to(dev)
            for f in ARRAY_FIELDS if getattr(self, f) is not None
        }
        return dataclasses.replace(self, **moved)


def _normalize_parents(kintree_row: np.ndarray, n_joints: int) -> np.ndarray:
    """Root parent is stored as -1 (or uint32 wraparound); remap to 0 — the
    root's parent entry is never used by the FK."""
    parents = kintree_row.astype(np.int64)
    parents[(parents < 0) | (parents >= n_joints)] = 0
    return parents.astype(np.int32)


def _morton_order(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    """Spatial sort of face centroids along a Morton (Z-order) curve.

    Faces that are close in space end up close in memory, which tightens the
    8-face subgroup bounding boxes the rasterizer culls against."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-12) * (2**bits - 1)).astype(np.uint64)

    def spread(x):
        x &= np.uint64((1 << bits) - 1)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def spec_from_numpy(arrays: dict, device="cuda", dtype=torch.float32, **meta) -> ModelSpec:
    """Build a :class:`ModelSpec` from numpy arrays.

    ``arrays`` maps each name of :data:`ARRAY_FIELDS` plus ``parents`` to an
    array (``scaledirs``/``transdirs`` may be missing or None); ``meta`` sets
    the static fields (``joint_names``, ``torso_joints``, flags, ...). The
    counts ``n_verts``/``n_faces``/``n_joints``/``n_betas`` default to the
    array shapes. This is how a spec of the JAX package is carried across:
    ``np.asarray`` of each of its array leaves plus its static fields."""
    dev = resolve_device(device)
    tensors = {}
    for name in ARRAY_FIELDS:
        a = arrays.get(name)
        if a is None:
            tensors[name] = None
            continue
        kind = torch.int64 if name == "faces" else dtype
        tensors[name] = torch.as_tensor(np.array(a), dtype=kind).to(dev)
    parents = tuple(int(p) for p in np.asarray(arrays["parents"]).reshape(-1))
    shapes = {
        "n_verts": tensors["v_template"].shape[0],
        "n_faces": tensors["faces"].shape[0],
        "n_joints": len(parents),
        "n_betas": tensors["shapedirs"].shape[0],
    }
    for k, v in shapes.items():
        meta.setdefault(k, int(v))
    for k in ("joint_names", "torso_joints", "ignore_joints",
              "left_inds", "right_inds", "center_inds"):
        if k in meta:
            meta[k] = tuple(meta[k])
    return ModelSpec(**tensors, parents=parents, **meta)


def load_model_spec(
    path: str,
    *,
    align_symmetry: bool = True,
    spatial_sort_faces: bool = True,
    shape_family: int = -1,
    smal_data_file: Optional[str] = None,
    dtype=torch.float32,
    device="cuda",
) -> ModelSpec:
    """Load a ``.pkl`` model asset into a :class:`ModelSpec`.

    ``align_symmetry=False`` uses the template as-is. ``spatial_sort_faces``
    reorders the (semantically order-free) face list along a Morton curve for
    rasterizer cull locality. ``shape_family >= 0`` bakes that family's
    cluster-mean betas (from the legacy SMAL data file) into the template;
    SMIL models use -1."""
    dd = load_raw_model(path)

    v_template = np.asarray(dd["v_template"], dtype=np.float64)
    if shape_family is not None and shape_family >= 0:
        if not smal_data_file:
            raise ValueError("shape_family >= 0 needs smal_data_file (cluster means)")
        data = load_raw_model(smal_data_file)
        betas_fam = np.asarray(data["cluster_means"][shape_family], dtype=np.float64)
        sdir = np.asarray(dd["shapedirs"], dtype=np.float64).reshape(-1, betas_fam.shape[0])
        v_template = v_template + (sdir @ betas_fam).reshape(v_template.shape)
    faces = np.asarray(dd["f"], dtype=np.int32)
    V = v_template.shape[0]
    if spatial_sort_faces and len(faces):
        centroids = v_template[faces].mean(axis=1)
        faces = faces[_morton_order(centroids)]

    left_inds = right_inds = center_inds = np.empty(0, dtype=int)
    if align_symmetry:
        sym_verts = dd.get("sym_verts")
        if sym_verts is None:
            raise ValueError(f"{path}: align_symmetry requested but no 'sym_verts' in model")
        v_template, left_inds, right_inds, center_inds = align_template_to_symmetry_axis(
            v_template, np.asarray(sym_verts, dtype=int)
        )

    # shape blendshapes → (B, 3V) so that `betas @ shapedirs` gives row-major (V,3)
    sdir = dd.get("shapedirs")
    if sdir is not None and np.asarray(sdir).size > 0:
        sdir = np.asarray(sdir, dtype=np.float64)
        n_betas = sdir.shape[-1]
        shapedirs = sdir.reshape(-1, n_betas).T
    else:
        n_betas = 0
        shapedirs = np.zeros((0, 3 * V))

    # J_regressor stored (J, V); keep (V, J) for verts-major matmuls
    Jr = np.asarray(dd["J_regressor"], dtype=np.float64)
    n_joints = Jr.shape[0]

    # pose blendshapes → (9(J-1), 3V); zero matrix when the model ships none
    pdir = dd.get("posedirs")
    if pdir is not None and np.asarray(pdir).size > 0:
        pdir = np.asarray(pdir, dtype=np.float64)
        posedirs = pdir.reshape(-1, pdir.shape[-1]).T
    else:
        posedirs = np.zeros((9 * (n_joints - 1), 3 * V))

    kintree_row = np.asarray(dd["kintree_table"])[0]
    raw_names = dd.get("J_names")
    joint_names = tuple(str(n) for n in raw_names) if raw_names is not None else tuple(
        f"joint_{i}" for i in range(n_joints)
    )
    has_prior = "shape_cov" in dd and "shape_mean_betas" in dd
    name2id = {n: i for i, n in enumerate(joint_names)}
    roots = np.nonzero(kintree_row.astype(np.int64) < 0)[0]
    root_idx = int(roots[0]) if len(roots) else 0

    arrays = {
        "v_template": v_template,
        "faces": faces,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": Jr.T,
        "weights": np.asarray(dd["weights"], dtype=np.float64),
        "joints_rest": (np.asarray(dd["J"], dtype=np.float64) if "J" in dd
                        else np.zeros((n_joints, 3))),
        "shape_mean_betas": (np.asarray(dd["shape_mean_betas"], dtype=np.float64)[:n_betas]
                             if has_prior else np.zeros(max(n_betas, 1))),
        "shape_cov": (np.asarray(dd["shape_cov"], dtype=np.float64)
                      if has_prior else np.eye(max(n_betas, 1))),
        "scaledirs": dd.get("scaledirs"),
        "transdirs": dd.get("transdirs"),
        "parents": _normalize_parents(kintree_row, n_joints),
    }
    return spec_from_numpy(
        arrays, device=device, dtype=dtype,
        joint_names=joint_names,
        n_betas=n_betas,
        static_joint_locations=bool(dd.get("static_joint_locs", False)),
        has_shape_prior=has_prior,
        legacy_dog_keypoints=(n_joints == 35 and raw_names is None),
        root_joint=joint_names[root_idx],
        torso_joints=tuple(name2id[n] for n in DEFAULT_TORSO_JOINT_NAMES if n in name2id),
        ignore_joints=tuple(name2id[n] for n in DEFAULT_IGNORE_JOINT_NAMES if n in name2id),
        left_inds=tuple(int(i) for i in left_inds),
        right_inds=tuple(int(i) for i in right_inds),
        center_inds=tuple(int(i) for i in center_inds),
        source_path=str(path),
    )


def toy_model_spec(V_side: int = 8, J: int = 6, B: int = 3, seed: int = 0,
                   device="cuda") -> ModelSpec:
    """A procedural but fully valid ModelSpec: an elongated sphere mesh of
    V_side² vertices and 2(V_side−1)² faces skinned to a chain of J joints.

    A copy of ``toy_model_spec`` in ``smilify_tpu/train/multidevice.py``: the
    same seed gives the same arrays. With ``V_side=55, J=55, B=5`` it has the
    width of the SMILy_STICK model (V=3025, F=5832, J=55)."""
    rng = np.random.RandomState(seed)
    n = V_side
    u, w = np.meshgrid(np.linspace(0.15, np.pi - 0.15, n), np.linspace(0, 2 * np.pi, n))
    verts = 0.3 * np.stack(
        [np.sin(u) * np.cos(w), np.sin(u) * np.sin(w), np.cos(u)], -1
    ).reshape(-1, 3).astype(np.float64)
    verts[:, 0] *= 2.0  # elongate along the chain axis
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1
            faces += [[a, b, c], [b, d, c]]
    faces = np.asarray(faces, np.int32)
    V = len(verts)

    joints = np.zeros((J, 3))
    joints[:, 0] = np.linspace(-0.5, 0.5, J)
    parents = np.asarray([0] + list(range(J - 1)), np.int32)

    d = np.linalg.norm(verts[:, None] - joints[None], axis=-1)  # (V, J)
    wts = np.exp(-8.0 * d)
    wts = wts / wts.sum(axis=1, keepdims=True)
    Jr = wts / wts.sum(axis=0, keepdims=True)                   # columns sum to 1

    shapedirs = (rng.randn(B, 3 * V) * 0.02).astype(np.float64)
    posedirs = np.zeros((9 * (J - 1), 3 * V))
    names = tuple(f"j{i}" for i in range(J))
    arrays = dict(
        v_template=verts, faces=faces, shapedirs=shapedirs, posedirs=posedirs,
        J_regressor=Jr, weights=wts, joints_rest=joints,
        shape_mean_betas=np.zeros((B,)), shape_cov=np.eye(B),
        scaledirs=None, transdirs=None, parents=parents,
    )
    return spec_from_numpy(
        arrays, device=device, joint_names=names, n_verts=V, n_faces=len(faces),
        n_joints=J, n_betas=B, static_joint_locations=False, has_shape_prior=True,
        legacy_dog_keypoints=False, root_joint=names[0], torso_joints=(0, 1),
        source_path="<toy>",
    )
