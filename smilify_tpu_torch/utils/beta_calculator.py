"""Shape coefficients from body measurements, Virtual-Caliper style (port of
``smilify_tpu/utils/beta_calculator.py``).

Equivalent of the reference ``custom_processing/smpl_beta_calculator.py``:
solve for the betas that make the model match a set of measured distances
(e.g. body length, limb spans) — a linear least-squares problem because
vertex positions are affine in betas (v = template + betas · shapedirs).

Measurements are defined as euclidean distances between pairs of vertex ids
(or the bounding-box extent along an axis). Since distances are non-linear in
betas we Gauss-Newton a few steps on the linearized system; with the small
shape spaces here this converges in 2-3 iterations. The solve runs in
float64 on the host, from host copies of the spec's tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from smilify_tpu_torch._device import to_host


def vertex_pair_distance(verts: np.ndarray, a: int, b: int) -> float:
    return float(np.linalg.norm(verts[a] - verts[b]))


def measure(verts: np.ndarray, measurements: Dict[str, Tuple[int, int]]) -> Dict[str, float]:
    return {name: vertex_pair_distance(verts, a, b) for name, (a, b) in measurements.items()}


def betas_from_measurements(
    spec,
    targets: Dict[str, float],
    measurements: Dict[str, Tuple[int, int]],
    n_iters: int = 3,
    damping: float = 1e-4,
) -> np.ndarray:
    """Solve for betas matching target distances (Gauss-Newton on the
    linearized measurement system, Tikhonov-damped toward the prior mean)."""
    v0 = to_host(spec.v_template).astype(np.float64)  # (V, 3)
    B = spec.n_betas
    dirs = to_host(spec.shapedirs).astype(np.float64).T.reshape(v0.shape[0], 3, B)  # (V, 3, B)
    mean = to_host(spec.shape_mean_betas).astype(np.float64)

    names = list(targets)
    betas = mean.copy()
    for _ in range(n_iters):
        verts = v0 + dirs @ betas
        r = np.zeros(len(names))
        Jm = np.zeros((len(names), B))
        for i, name in enumerate(names):
            a, b = measurements[name]
            d = verts[a] - verts[b]
            dist = np.linalg.norm(d) + 1e-12
            r[i] = targets[name] - dist
            # ∂dist/∂betas = d̂ · (dirs[a] − dirs[b])
            Jm[i] = (d / dist) @ (dirs[a] - dirs[b])
        A = Jm.T @ Jm + damping * np.eye(B)
        betas = betas + np.linalg.solve(A, Jm.T @ r)
    return betas


def report(spec, betas: np.ndarray, targets: Dict[str, float],
           measurements: Dict[str, Tuple[int, int]]) -> str:
    v0 = to_host(spec.v_template).astype(np.float64)
    dirs = to_host(spec.shapedirs).astype(np.float64).T.reshape(v0.shape[0], 3, spec.n_betas)
    verts = v0 + dirs @ np.asarray(betas, np.float64)
    lines = [f"{'measurement':20s} {'target':>10s} {'achieved':>10s}"]
    for name, (a, b) in measurements.items():
        got = vertex_pair_distance(verts, a, b)
        lines.append(f"{name:20s} {targets.get(name, float('nan')):10.4f} {got:10.4f}")
    return "\n".join(lines)
