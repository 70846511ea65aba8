"""Model authoring: build SMIL ``.pkl`` assets programmatically (port of
``smilify_tpu/utils/authoring.py``).

Non-Blender equivalents of the reference's Blender addon operators
(``3D_model_prep/SMIL_processing_addon.py``):
  * :func:`compute_pca_shape_space` — PCA over registered meshes →
    v_template / shapedirs / shape_mean_betas / shape_cov;
  * :func:`compute_entangled_pca` — joint PCA over vertices ⊕ per-joint
    scales ⊕ per-joint translations → shapedirs + scaledirs + transdirs;
  * :func:`j_regressor_from_weights` — vertex→joint regressor from skinning
    weights;
  * :func:`build_model_from_registration` — a registration's ``.npz``
    (``fitter/fitter3d.py::StageManager``) → a new model ``.pkl``;
  * :func:`pose_corrective_offsets`, :func:`make_symmetrical`, the joint
    distance and mesh measurement CSVs;
  * :func:`export_model_pkl` / :func:`import_model_pkl` — the L0 asset format
    round trip (the dict schema the reference loader reads).

The maths is numpy in float64 on the host, as in the JAX package; a spec's
tensors are read through host copies. The two measurement CSVs run the SMIL
forward once, on the spec's device, for all 2B+1 shape configurations.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smilify_tpu_torch._device import to_host
from smilify_tpu_torch.core.io import load_raw_model
from smilify_tpu_torch.core.symmetry import (  # noqa: F401  (rebuild_symmetry_array: re-export)
    compute_symmetric_pairs,
    rebuild_symmetry_array,
)


def _pca(data: np.ndarray, n_components: int):
    """Rows = samples. Returns (mean, components (B, D), coefficients (N, B),
    covariance of coefficients (B, B))."""
    mean = data.mean(axis=0)
    X = data - mean
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    B = min(n_components, Vt.shape[0])
    components = Vt[:B]
    coeffs = X @ components.T
    cov = np.cov(coeffs.T) if B > 1 else np.atleast_2d(np.var(coeffs[:, 0]))
    return mean, components, coeffs, np.atleast_2d(cov)


def compute_pca_shape_space(registered_verts: np.ndarray, n_components: int = 5):
    """(N, V, 3) registered meshes → shape space.

    Returns dict with v_template (V, 3), shapedirs (V, 3, B),
    shape_mean_betas (B,), shape_cov (B, B), betas (N, B).
    """
    N, V, _ = registered_verts.shape
    mean, comps, coeffs, cov = _pca(registered_verts.reshape(N, -1), n_components)
    B = comps.shape[0]
    return {
        "v_template": mean.reshape(V, 3),
        "shapedirs": comps.T.reshape(V, 3, B),
        "shape_mean_betas": coeffs.mean(axis=0),
        "shape_cov": cov,
        "betas": coeffs,
    }


def compute_entangled_pca(
    registered_verts: np.ndarray,
    joint_log_scales: np.ndarray,
    joint_translations: np.ndarray,
    n_components: int = 5,
    scale_weight: float = 1.0,
    trans_weight: float = 1.0,
):
    """Joint PCA over vertices ⊕ per-joint scales ⊕ translations.

    Args: (N, V, 3) verts, (N, J, 3) log scales, (N, J, 3) translations.
    Returns dict adding scaledirs/transdirs (B, J, 3) to the shape space —
    the entangled components that the model's betas drive jointly
    (reference apply_entangled_pca_and_create_shapekeys:1037).
    """
    N, V, _ = registered_verts.shape
    J = joint_log_scales.shape[1]
    stacked = np.concatenate(
        [
            registered_verts.reshape(N, -1),
            joint_log_scales.reshape(N, -1) * scale_weight,
            joint_translations.reshape(N, -1) * trans_weight,
        ],
        axis=1,
    )
    mean, comps, coeffs, cov = _pca(stacked, n_components)
    B = comps.shape[0]
    v_dim = V * 3
    s_dim = J * 3
    return {
        "v_template": mean[:v_dim].reshape(V, 3),
        "shapedirs": comps[:, :v_dim].T.reshape(V, 3, B),
        "scaledirs": comps[:, v_dim : v_dim + s_dim].reshape(B, J, 3) / scale_weight,
        "transdirs": comps[:, v_dim + s_dim :].reshape(B, J, 3) / trans_weight,
        "shape_mean_betas": coeffs.mean(axis=0),
        "shape_cov": np.atleast_2d(cov),
        "betas": coeffs,
        "mean_log_scales": mean[v_dim : v_dim + s_dim].reshape(J, 3) / scale_weight,
        "mean_translations": mean[v_dim + s_dim :].reshape(J, 3) / trans_weight,
    }


def j_regressor_from_weights(
    weights: np.ndarray, top_k: Optional[int] = None, power: float = 2.0
) -> np.ndarray:
    """Skinning weights (V, J) → J_regressor (J, V).

    Each joint's regressor is its (optionally sharpened and top-k-sparsified)
    skinning-weight column normalized over vertices — locating the joint at
    the weighted centroid of its strongly-bound vertices."""
    w = np.asarray(weights, dtype=np.float64) ** power
    J = w.shape[1]
    reg = w.T.copy()  # (J, V)
    if top_k is not None:
        for j in range(J):
            idx = np.argsort(reg[j])[:-top_k]
            reg[j, idx] = 0.0
    sums = reg.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    return reg / sums


def validate_model_dict(dd: Dict) -> List[str]:
    """Schema check for the L0 asset format; returns a list of problems."""
    problems = []
    required = ("v_template", "f", "J_regressor", "kintree_table", "weights")
    for k in required:
        if k not in dd:
            problems.append(f"missing required key '{k}'")
    if problems:
        return problems
    V = np.asarray(dd["v_template"]).shape[0]
    J = np.asarray(dd["J_regressor"]).shape[0]
    if np.asarray(dd["weights"]).shape != (V, J):
        problems.append(f"weights shape {np.asarray(dd['weights']).shape} != ({V}, {J})")
    if np.asarray(dd["kintree_table"]).shape[1] != J:
        problems.append("kintree_table joint count mismatch")
    if np.asarray(dd["f"]).max() >= V:
        problems.append("face index out of range")
    if "shapedirs" in dd and np.asarray(dd["shapedirs"]).size:
        if np.asarray(dd["shapedirs"]).shape[:2] != (V, 3):
            problems.append("shapedirs must be (V, 3, B)")
    if "J_names" in dd and len(dd["J_names"]) != J:
        problems.append("J_names length mismatch")
    return problems


def export_model_pkl(
    path: str,
    v_template: np.ndarray,
    faces: np.ndarray,
    J_regressor: np.ndarray,
    kintree_table: np.ndarray,
    weights: np.ndarray,
    J_names: Sequence[str],
    shapedirs: Optional[np.ndarray] = None,
    posedirs: Optional[np.ndarray] = None,
    J: Optional[np.ndarray] = None,
    static_joint_locs: bool = False,
    sym_verts: Optional[np.ndarray] = None,
    shape_cov: Optional[np.ndarray] = None,
    shape_mean_betas: Optional[np.ndarray] = None,
    scaledirs: Optional[np.ndarray] = None,
    transdirs: Optional[np.ndarray] = None,
) -> str:
    """Write the L0 ``.pkl`` asset (readable by both packages and the
    reference's loader)."""
    dd = {
        "v_template": np.asarray(v_template, np.float64),
        "f": np.asarray(faces, np.int32),
        "J_regressor": np.asarray(J_regressor, np.float64),
        "kintree_table": np.asarray(kintree_table, np.int32),
        "weights": np.asarray(weights, np.float64),
        "J_names": list(J_names),
        "posedirs": np.asarray(posedirs, np.float64) if posedirs is not None else np.empty(0),
        "bs_style": "lbs",
        "bs_type": "lrotmin",
    }
    optional = {"shapedirs": (shapedirs, np.float64), "J": (J, np.float64),
                "sym_verts": (sym_verts, np.int64), "shape_cov": (shape_cov, np.float64),
                "shape_mean_betas": (shape_mean_betas, np.float64),
                "scaledirs": (scaledirs, np.float64), "transdirs": (transdirs, np.float64)}
    for key, (value, dtype) in optional.items():
        if value is not None:
            dd[key] = np.asarray(value, dtype)
    if static_joint_locs:
        dd["static_joint_locs"] = True

    problems = validate_model_dict(dd)
    if problems:
        raise ValueError("invalid model dict: " + "; ".join(problems))
    with open(path, "wb") as f:
        pickle.dump(dd, f, protocol=2)
    return path


def import_model_pkl(path: str) -> Dict:
    """A model ``.pkl`` as a dict of plain numpy values."""
    return load_raw_model(path)


def build_model_from_registration(
    npz_path: str,
    base_spec,
    n_components: int = 5,
    entangled: bool = True,
    out_path: Optional[str] = None,
):
    """A registration's results (the ``.npz`` that ``StageManager`` writes:
    ``verts`` (N, V, 3), ``log_beta_scales`` and ``betas_trans`` (N, J, 3))
    → a new model ``.pkl``: the PCA of the fitted meshes (entangled with the
    joints' scales and translations where the npz has them) on the base
    spec's faces, regressor, skinning weights and kintree. Returns its path."""
    data = np.load(npz_path, allow_pickle=True)
    verts = data["verts"]
    if entangled and "log_beta_scales" in data:
        space = compute_entangled_pca(
            verts, data["log_beta_scales"], data["betas_trans"], n_components
        )
    else:
        space = compute_pca_shape_space(verts, n_components)

    out = out_path or npz_path.replace(".npz", "_model.pkl")
    kintree = np.stack([np.asarray(base_spec.parents), np.arange(base_spec.n_joints)])
    kintree[0, 0] = -1
    return export_model_pkl(
        out,
        v_template=space["v_template"],
        faces=to_host(base_spec.faces),
        J_regressor=to_host(base_spec.J_regressor).T,
        kintree_table=kintree,
        weights=to_host(base_spec.weights),
        J_names=base_spec.joint_names,
        shapedirs=space["shapedirs"],
        shape_cov=space["shape_cov"],
        shape_mean_betas=space["shape_mean_betas"],
        scaledirs=space.get("scaledirs"),
        transdirs=space.get("transdirs"),
    )


# ---------------------------------------------------------------------------
# authoring extras: pose correctives, symmetrization, measurement exports
# (reference 3D_model_prep/SMIL_processing_addon.py:643, 1452, 1841-2110)
# ---------------------------------------------------------------------------


def pose_corrective_offsets(posedirs, joint_rotations_aa: np.ndarray) -> np.ndarray:
    """Pose-dependent corrective vertex offsets for one pose.

    The addon's apply_pose_correctives (:643): feature = vec(R_j − I) over all
    non-root joints; offsets = posedirs · feature.

    Args:
      posedirs: (V, 3, (J−1)·9) (the pkl's layout) or (9(J−1), 3V) (the
        spec's), an array or a tensor.
      joint_rotations_aa: (J−1, 3) non-root axis-angle rotations.
    Returns (V, 3) offsets.
    """
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(np.asarray(joint_rotations_aa, np.float64)).as_matrix()
    feature = (R - np.eye(3)[None]).reshape(-1)
    pd = to_host(posedirs)
    if pd.ndim == 3:          # raw pkl/addon layout (V, 3, P)
        mat = pd.reshape(-1, pd.shape[-1])   # (3V, P)
    else:                     # ModelSpec layout (P, 3V)
        mat = pd.T
    V = mat.shape[0] // 3
    return (mat @ feature).reshape(V, 3).astype(np.float32)


def make_symmetrical(verts: np.ndarray, axis: str = "y",
                     center_tolerance: float = 0.005) -> np.ndarray:
    """Force a template mesh exactly symmetric about an axis plane (the
    addon's make_symmetrical operator, :1452): near-plane vertices snap onto
    the plane; mirrored pairs are averaged with their reflections.

    Returns the symmetrized copy of ``verts``.
    """
    a = "xyz".index(axis)
    out = np.asarray(verts, np.float64).copy()
    on_plane = np.abs(out[:, a]) < center_tolerance
    out[on_plane, a] = 0.0

    pairs = compute_symmetric_pairs(out, axis=axis, tolerance=center_tolerance * 10)
    done = set()
    for i, j in pairs:
        if i in done or j in done or i == j:
            continue
        mi, mj = out[i].copy(), out[j].copy()
        mj_ref = mj.copy()
        mj_ref[a] = -mj_ref[a]
        mean = (mi + mj_ref) / 2.0
        out[i] = mean
        out[j] = mean
        out[j, a] = -mean[a]
        done.update((i, j))
    return out.astype(verts.dtype if hasattr(verts, "dtype") else np.float32)


def joint_distances(joint_positions: np.ndarray, joint_names) -> List[Tuple[str, str, float]]:
    """All-pairs joint distances (addon get_joint_distances_from_positions,
    :1855)."""
    out = []
    J = len(joint_names)
    for i in range(J):
        for j in range(i + 1, J):
            out.append((str(joint_names[i]), str(joint_names[j]),
                        float(np.linalg.norm(joint_positions[i] - joint_positions[j]))))
    return out


def mesh_surface_area(verts: np.ndarray, faces: np.ndarray) -> float:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return float(0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1).sum())


def mesh_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """Signed-tetrahedra volume (divergence theorem; |·| like the addon's
    bmesh calc_volume, :2060)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return float(abs(np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() / 6.0))


def _shape_configs(n_betas: int, beta_range: float):
    """The neutral shape, then each beta at +beta_range and −beta_range."""
    configs = [("neutral", np.zeros(n_betas))]
    for b in range(n_betas):
        for sgn, tag in ((+1, "+"), (-1, "-")):
            v = np.zeros(n_betas)
            v[b] = sgn * beta_range
            configs.append((f"beta{b}{tag}{beta_range}", v))
    return configs


@torch.no_grad()
def _posed_configs(spec, configs):
    """(verts (2B+1, V, 3), joints (2B+1, J, 3)) of the rest pose at each
    configuration's betas: one forward on the spec's device."""
    from smilify_tpu_torch.core.lbs import smil_forward

    dev = spec.device
    betas = torch.as_tensor(np.stack([b for _, b in configs]), dtype=torch.float32, device=dev)
    out = smil_forward(spec, betas, torch.zeros((len(configs), spec.n_joints, 3), device=dev))
    return out.verts.cpu().numpy(), out.joints.cpu().numpy()


def export_joint_distances_csv(spec, out_path: str, beta_range: float = 2.0) -> str:
    """Per-shape-component joint-distance CSV (addon export_joint_distances,
    :1868): rows = joint pairs, columns = neutral plus each beta at
    ±beta_range std devs."""
    import csv

    configs = _shape_configs(spec.n_betas, beta_range)
    _, joints = _posed_configs(spec, configs)
    cols = {name: {(a, b): d for a, b, d in joint_distances(joints[i], spec.joint_names)}
            for i, (name, _) in enumerate(configs)}

    pairs = list(next(iter(cols.values())).keys())
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["joint_a", "joint_b"] + [n for n, _ in configs])
        for pair in pairs:
            w.writerow([pair[0], pair[1]] + [f"{cols[n][pair]:.6f}" for n, _ in configs])
    return out_path


def export_mesh_measurements_csv(spec, out_path: str, beta_range: float = 2.0) -> str:
    """Surface-area / volume CSV across shape components (addon
    export_mesh_measurements, :2080)."""
    import csv

    configs = _shape_configs(spec.n_betas, beta_range)
    verts, _ = _posed_configs(spec, configs)
    faces = to_host(spec.faces)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["config", "surface_area", "volume"])
        for i, (name, _) in enumerate(configs):
            w.writerow([name, f"{mesh_surface_area(verts[i], faces):.6f}",
                        f"{mesh_volume(verts[i], faces):.6f}"])
    return out_path
