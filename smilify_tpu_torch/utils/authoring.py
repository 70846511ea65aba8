"""Model authoring: the ``.pkl`` asset round trip (port of
``export_model_pkl`` / ``import_model_pkl`` and their schema check from
``smilify_tpu/utils/authoring.py``; numpy only).

:func:`export_model_pkl` writes the L0 asset format (the dict schema the
reference loader reads) and :func:`import_model_pkl` reads it back through
the port's chumpy-tolerant loader. The rest of the JAX module (PCA shape
spaces, regressors from weights, building a model from registrations) is
not ported yet.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from smilify_tpu_torch.core.io import load_raw_model


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
