"""Template symmetry alignment (host-side, numpy).

Behavioral equivalent of the reference ``smal_model/smal_basics.py:53-246``:
center the template, snap the symmetry-plane vertices onto y=0, then force the
right half to be an exact mirror of the left half. Pair discovery uses a
KD-tree over the reflected vertices (``compute_symmetric_pairs``,
``smal_basics.py:9-31``).

Runs once at model-load time; stays numpy/scipy on the host.

A copy of ``smilify_tpu/core/symmetry.py``: the port keeps its own copy of this
JAX-free module so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

_AXIS_IDX = {"x": 0, "y": 1, "z": 2}


def compute_symmetric_pairs(vertices: np.ndarray, axis: str = "y", tolerance: float = 0.01) -> np.ndarray:
    """Find (i, j) vertex pairs that mirror each other across ``axis``.

    ``tolerance`` is relative to the template's max |coordinate|.
    """
    ax = _AXIS_IDX[axis]
    tol = np.max(np.abs(vertices)) * tolerance

    reflected = vertices.copy()
    reflected[:, ax] *= -1
    tree = cKDTree(reflected)

    dists, idx = tree.query(vertices, distance_upper_bound=tol)
    found = dists < tol
    pairs = np.stack([np.nonzero(found)[0], idx[found]], axis=1)
    return pairs


def rebuild_symmetry_array(
    on_axis_vertices: np.ndarray, all_vertices: np.ndarray, axis: str = "y", tolerance: float = 0.001
) -> np.ndarray:
    """Build ``symIdx`` mapping each vertex to its mirror partner (self on axis)."""
    sym_idx = np.arange(len(all_vertices))
    sym_idx[np.asarray(on_axis_vertices, dtype=int)] = np.asarray(on_axis_vertices, dtype=int)
    for a, b in compute_symmetric_pairs(all_vertices, axis, tolerance):
        sym_idx[a] = b
        sym_idx[b] = a
    return sym_idx


def align_template_to_symmetry_axis(v: np.ndarray, on_axis_vertices: np.ndarray, sym_idx: np.ndarray | None = None):
    """Center ``v``, zero the symmetry-plane vertices' y, mirror left→right.

    Returns (v_sym, left_inds, right_inds, center_inds). Mirrors the reference's
    ``align_smal_template_to_symmetry_axis`` including its quirks: the initial
    centering subtracts the *scalar* mean over all coordinates, and the
    left/right split uses an absolute 0.01 band around the plane.
    """
    v = np.array(v, dtype=np.float64, copy=True)
    I = np.asarray(on_axis_vertices, dtype=int)

    v = v - np.mean(v)  # scalar mean over every coordinate (reference behavior)
    v[:, 1] = v[:, 1] - np.mean(v[I, 1])
    v[I, 1] = 0.0

    center_tolerance = 0.01
    left = v[:, 1] <= -center_tolerance
    right = v[:, 1] >= center_tolerance
    center = ~(left | right)

    if sym_idx is None:
        sym_idx = rebuild_symmetry_array(I, v, axis="y", tolerance=0.001)

    v[left[sym_idx]] = np.array([1.0, -1.0, 1.0]) * v[left]

    left_inds = np.where(left)[0]
    right_inds = np.where(right)[0]
    center_inds = np.where(center)[0]

    if len(left_inds) != len(right_inds):
        raise ValueError(
            f"asymmetric template: {len(left_inds)} left vs {len(right_inds)} right vertices; "
            "check sym_verts or disable symmetry alignment"
        )
    return v, left_inds, right_inds, center_inds
