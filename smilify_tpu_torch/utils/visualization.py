"""Visualization: joint markers, fitting collages, silhouette metrics and the
fitter_3d plots (port of ``smilify_tpu/utils/visualization.py``).

``draw_joints`` draws OpenCV's ``MARKER_STAR`` in numpy (the card's machine
has no OpenCV): at thickness 1 a star of size s is four 1-pixel lines of
half-length s // 2 through the joint — horizontal, vertical and the two
diagonals — clipped at the image border, pixel for pixel what
``cv2.drawMarker`` draws. The plots import matplotlib when called; the
card's machine lacks it, and no path run there calls them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# MARKER_STAR's four lines through the joint, as (dx, dy) steps
_STAR_STEPS = ((1, 0), (0, 1), (1, 1), (1, -1))


def rainbow_colors(n: int):
    """Reference config.py:125-128 marker colors."""
    return [
        (int(255 - i * 255 / n), int(i * 255 / n), 100) for i in range(n)
    ]


def _draw_star(img: np.ndarray, x: int, y: int, color, marker_size: int) -> None:
    H, W = img.shape[:2]
    t = np.arange(-(marker_size // 2), marker_size // 2 + 1)
    for dx, dy in _STAR_STEPS:
        xs, ys = x + dx * t, y + dy * t
        inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img[ys[inside], xs[inside]] = color


def draw_joints(
    image: np.ndarray,
    joints_yx: np.ndarray,
    visible: Optional[np.ndarray] = None,
    marker_size: int = 6,
) -> np.ndarray:
    """Draw star markers at (row, col) joints on a (H, W, 3) image.

    Accepts float [0,1] (returns float) or uint8 (returns uint8)."""
    was_u8 = image.dtype == np.uint8
    if was_u8:
        img = np.ascontiguousarray(image).copy()
    else:
        img = (np.ascontiguousarray(image) * 255.0).astype(np.uint8)
    H, W = img.shape[:2]
    n = len(joints_yx)
    colors = rainbow_colors(n)
    for k, (y, x) in enumerate(np.asarray(joints_yx)):
        if visible is not None and not bool(visible[k]):
            continue
        if not (0 <= y < H and 0 <= x < W):
            continue
        _draw_star(img, int(x), int(y), colors[k], marker_size)
    return img if was_u8 else img.astype(np.float32) / 255.0


def fit_collage(
    rgb: np.ndarray,
    rendered: np.ndarray,
    sil_target: np.ndarray,
    sil_rendered: np.ndarray,
    target_joints_yx: np.ndarray,
    rendered_joints_yx: np.ndarray,
    visibility: Optional[np.ndarray] = None,
    rev_rendered: Optional[np.ndarray] = None,
) -> np.ndarray:
    """5-panel collage row: target+joints | render+joints | overlay | sil error | rotated."""
    target_vis = draw_joints(rgb, target_joints_yx, visibility)
    rendered_vis = draw_joints(rendered, rendered_joints_yx, visibility)
    overlay = draw_joints(rendered * 0.5 + rgb * 0.5, rendered_joints_yx, visibility)
    sil_err = 1.0 - np.abs(sil_target - sil_rendered)
    sil_err_rgb = np.repeat(sil_err[..., None], 3, axis=-1)
    panels = [target_vis, rendered_vis, overlay, sil_err_rgb]
    if rev_rendered is not None:
        panels.append(rev_rendered)
    return np.concatenate(panels, axis=1)


def silhouette_iou(a, b, threshold: float = 0.5) -> float:
    """IoU between two silhouettes (soft maps thresholded at ``threshold``;
    tensors on any device or arrays); 1.0 when both are empty."""
    A = _host(a) > threshold
    B = _host(b) > threshold
    inter = np.logical_and(A, B).sum()
    union = np.logical_or(A, B).sum()
    return float(inter) / float(union) if union else 1.0


def pck(pred_yx, gt_yx, visibility, threshold_px: float) -> float:
    """Percentage of correct keypoints at a pixel threshold."""
    err = np.linalg.norm(_host(pred_yx) - _host(gt_yx), axis=-1)
    vis = _host(visibility) > 0
    if not vis.any():
        return 0.0
    return float((err[vis] <= threshold_px).mean())


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# fitter_3d plot suite (reference fitter_3d/utils.py:102-135) + sphere-scene
# debug renderer (reference Unreal2Pytorch3D.py:1771-1874)
# ---------------------------------------------------------------------------


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_mesh(verts, faces, out_path: str, title: str = "", color="lightblue",
              elev: float = 20.0, azim: float = -60.0):
    """Matplotlib trisurf plot of a mesh (reference plot_mesh)."""
    plt = _pyplot()
    v = _host(verts)
    f = _host(faces)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=f, color=color,
                    edgecolor="none", alpha=0.9)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    _equal_3d_axes(ax, v)
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


def plot_pointclouds(clouds, out_path: str, labels=None, title: str = ""):
    """Overlayed 3D scatter of point clouds (reference plot_pointcloud)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    allpts = []
    for i, c in enumerate(clouds):
        c = _host(c)
        allpts.append(c)
        ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=4,
                   label=(labels[i] if labels else f"cloud {i}"))
    ax.legend()
    ax.set_title(title)
    _equal_3d_axes(ax, np.concatenate(allpts))
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


def plot_mesh_heatmap(verts, faces, face_values, out_path: str, title: str = "",
                      cmap: str = "viridis"):
    """Per-face scalar heatmap on the mesh (reference thinness/error plots)."""
    plt = _pyplot()
    import matplotlib.cm as cm
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    v = _host(verts)
    f = _host(faces)
    vals = _host(face_values).astype(np.float64)
    rng = vals.max() - vals.min()
    norm = (vals - vals.min()) / (rng if rng > 0 else 1.0)
    colors = cm.get_cmap(cmap)(norm)

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.add_collection3d(Poly3DCollection(v[f], facecolors=colors, edgecolor="none"))
    ax.set_title(title)
    _equal_3d_axes(ax, v)
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


def _equal_3d_axes(ax, pts):
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = (lo + hi) / 2
    r = float((hi - lo).max() / 2) or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)


@torch.no_grad()
def render_scene_debug(spec, camera, verts, keypoints_3d=None, image_size=(256, 256),
                       sphere_px: int = 4):
    """Sphere-scene debug render: Phong mesh + keypoint markers through the
    SAME camera (reference scene renderer, Unreal2Pytorch3D.py:1771-1874 —
    used to validate camera geometry against dataset keypoints). ``verts``
    (V, 3) and ``keypoints_3d`` (K, 3) on the spec's device.

    Returns an (H, W, 3) float numpy image."""
    from smilify_tpu_torch.render.phong import render_phong

    H, W = image_size
    verts = torch.as_tensor(verts, dtype=torch.float32, device=spec.device)
    pv = camera.world_to_view(verts)
    ndc = torch.cat([camera.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
    img = _host(render_phong(verts, pv, ndc, spec.faces, (H, W)))
    if keypoints_3d is not None:
        kp = torch.as_tensor(keypoints_3d, dtype=torch.float32, device=spec.device)
        yx = _host(camera.project_points_yx(kp, (H, W)))
        img = draw_joints(img, yx, np.ones(len(yx)), marker_size=sphere_px)
    return img
