"""Mesh preparation + quality statistics, host-side numpy (a copy of
``smilify_tpu/utils/mesh_prep.py``: the port imports nothing of the JAX
package).

Portable re-implementation of the reference's Blender-based scan-prep
toolchain (``custom_processing/prepare_antscan_data_for_mesh_fitting.py``:
largest-component extraction, hole counting, face-size CoV, smoothness,
decimation; ``3D_model_prep/SMPL_exporter.py``: mesh → npy/obj exports;
``antscan_proofread_stats_and_caste_separation.py``: per-mesh stats tables).
The scraping / Blender-UI parts are out of scope (no egress, no Blender);
everything that operates on mesh arrays is reproduced here.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Binary or ASCII STL → (verts (V,3), faces (F,3)) with vertex welding."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head.lower() == b"solid":
        try:
            return _load_stl_ascii(path)
        except ValueError:
            pass  # 'solid'-prefixed binary files exist in the wild
    return _load_stl_binary(path)


def _load_stl_binary(path: str):
    with open(path, "rb") as f:
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tris = data[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    return _weld(tris.astype(np.float64))


def _load_stl_ascii(path: str):
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                pts.append([float(x) for x in parts[1:4]])
    tris = np.asarray(pts, np.float64)
    if len(tris) % 3:
        raise ValueError("malformed ascii stl")
    return _weld(tris.reshape(-1, 3, 3))


def _weld(tris: np.ndarray, decimals: int = 8):
    flat = tris.reshape(-1, 3)
    keys = np.round(flat, decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[ok]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in np.asarray(faces) + 1:
            f.write(f"f {a} {b} {c}\n")
    return path


def export_mesh_npy(out_prefix: str, verts: np.ndarray, faces: np.ndarray):
    """verts/faces .npy pair (reference SMPL_exporter export_*_to_npy)."""
    vp, fp = out_prefix + "_vertices.npy", out_prefix + "_faces.npy"
    np.save(vp, np.asarray(verts, np.float32))
    np.save(fp, np.asarray(faces, np.int32))
    return vp, fp


# ---------------------------------------------------------------------------
# topology / cleanup
# ---------------------------------------------------------------------------


def connected_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Vertex-connectivity component label per face (union-find)."""
    parent = np.arange(n_verts)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in np.asarray(faces):
        r0 = find(f[0])
        for v in f[1:]:
            r = find(v)
            if r != r0:
                parent[r] = r0
    roots = np.asarray([find(f[0]) for f in faces])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the face-count-largest connected component, reindexed (reference
    find_largest_component)."""
    labels = connected_components(faces, len(verts))
    keep = labels == np.bincount(labels).argmax()
    f_keep = faces[keep]
    used = np.unique(f_keep)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[f_keep].astype(np.int32)


def _edges_with_counts(faces: np.ndarray):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, counts = np.unique(e, axis=0, return_counts=True)
    return uniq, counts


def count_holes(faces: np.ndarray) -> int:
    """Number of boundary loops (reference count_holes): trace cycles over
    edges that belong to exactly one face."""
    uniq, counts = _edges_with_counts(faces)
    boundary = uniq[counts == 1]
    if len(boundary) == 0:
        return 0
    nxt: Dict[int, List[int]] = {}
    for a, b in boundary:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    visited = set()
    loops = 0
    for start in list(nxt):
        if start in visited:
            continue
        loops += 1
        stack = [start]
        while stack:
            v = stack.pop()
            if v in visited:
                continue
            visited.add(v)
            stack.extend(n for n in nxt[v] if n not in visited)
    return loops


def face_size_cov(verts: np.ndarray, faces: np.ndarray) -> float:
    """Coefficient of variation of face areas (reference calculate_face_size_cov
    — a scan-quality indicator)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    m = areas.mean()
    return float(areas.std() / m) if m > 0 else 0.0


def mesh_smoothness(verts: np.ndarray, faces: np.ndarray) -> float:
    """Mean angular deviation (degrees) between adjacent face normals
    (reference calculate_mesh_smoothness; lower = smoother)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    fidx = np.tile(np.arange(len(faces)), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e_s, f_s = e[order], fidx[order]
    same = (e_s[1:] == e_s[:-1]).all(axis=1)
    a, b = f_s[:-1][same], f_s[1:][same]
    if len(a) == 0:
        return 0.0
    d = np.clip(np.abs(np.sum(n[a] * n[b], axis=-1)), -1.0, 1.0)
    return float(np.degrees(np.arccos(d)).mean())


def decimate_vertex_clustering(verts: np.ndarray, faces: np.ndarray,
                               target_vertices: int, max_iterations: int = 24):
    """Grid vertex-clustering decimation until ≤ target_vertices (the
    reference iterates Blender's decimate modifier,
    reduce_vertices_by_distance; clustering gives the same contract —
    bounded vertex count, preserved gross shape — without Blender)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    if len(v) <= target_vertices:
        return v.astype(np.float32), f.astype(np.int32)
    lo, hi = v.min(axis=0), v.max(axis=0)
    extent = float((hi - lo).max()) or 1.0
    cell = extent / max(2, int(np.cbrt(target_vertices) * 2))
    for _ in range(max_iterations):
        keys = np.floor((v - lo) / cell).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        new_v = np.zeros((len(uniq), 3))
        np.add.at(new_v, inv, v)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        new_v /= counts[:, None]
        new_f = inv[f]
        ok = ((new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
              & (new_f[:, 0] != new_f[:, 2]))
        new_f = new_f[ok]
        if len(new_v) <= target_vertices:
            return new_v.astype(np.float32), new_f.astype(np.int32)
        cell *= 1.3
    return new_v.astype(np.float32), new_f.astype(np.int32)


def mesh_stats(verts: np.ndarray, faces: np.ndarray) -> Dict[str, float]:
    """Per-mesh quality table row (reference proofread stats)."""
    labels = connected_components(faces, len(verts)) if len(faces) else np.zeros(0)
    return {
        "n_vertices": int(len(verts)),
        "n_faces": int(len(faces)),
        "n_components": int(labels.max()) + 1 if len(labels) else 0,
        "n_holes": count_holes(faces),
        "face_size_cov": face_size_cov(verts, faces),
        "smoothness_deg": mesh_smoothness(verts, faces),
    }


def separate_by_caste(names: List[str], lookup: Dict[str, str]) -> Dict[str, List[str]]:
    """Group specimen names into caste buckets via a lookup table (reference
    antscan_proofread_stats_and_caste_separation.py). Unmatched → 'unknown'."""
    out: Dict[str, List[str]] = {}
    for name in names:
        caste = "unknown"
        for key, c in lookup.items():
            if key in name:
                caste = c
                break
        out.setdefault(caste, []).append(name)
    return out
