"""Dataset inspector — static HTML report.

Replaces the reference's Streamlit+Plotly viewer
(``multiview_common/dataset_viewer.py``) with a dependency-free static HTML
report: per-sample image grids with keypoint/reprojection overlays, view
masks, parameter summaries, and dataset statistics.

Port of ``smilify_tpu/cli/dataset_viewer.py``. It runs on ``--device``
(default ``cuda``; it raises when there is no card): ``--render-smal`` poses
the model and renders it with the Phong renderer there. The panels are PNG
(``utils/image_io.write_png``); an HDF5 dataset is read by the port's codec
(``utils/hdf5_io.py``), its JPEG images through OpenCV.

Usage:
  python -m smilify_tpu_torch.cli.dataset_viewer --dataset <h5|dir> --output report/ \
      [--samples 8] [--model <pkl>] [--device cuda]
"""

from __future__ import annotations

import argparse
import html
import os

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.utils.image_io import write_png


def _overlay_sample_sv(sample, out_path):
    from smilify_tpu_torch.utils.visualization import draw_joints

    img = sample["image"]
    H, W = img.shape[:2]
    kp = sample["keypoints_2d"].copy()
    if kp.max() <= 1.5:  # normalized (y, x)
        kp = kp * [H, W]
    vis = sample.get("keypoint_visibility")
    over = draw_joints(img, kp, vis)
    write_png(out_path, (over * 255).astype(np.uint8))


def _overlay_sample_mv(sample, out_path):
    from smilify_tpu_torch.data.canonical_frame import project_world_to_pixel
    from smilify_tpu_torch.utils.visualization import draw_joints

    panels = []
    V = sample["images"].shape[0]
    for v in range(V):
        if not sample["view_mask"][v]:
            continue
        img = sample["images"][v]
        H, W = img.shape[:2]
        kp = sample["keypoints_2d"][v][:, ::-1]  # stored (x, y)? keep raw pixels
        over = draw_joints(img, sample["keypoints_2d"][v], sample["keypoint_visibility"][v])
        # reprojection overlay when 3D GT exists
        if sample.get("has_3d_data"):
            uv = project_world_to_pixel(
                sample["keypoints_3d"],
                sample["camera_extrinsics_R"][v],
                sample["camera_extrinsics_t"][v],
                sample["camera_intrinsics"][v],
            )
            over = draw_joints(over, uv[:, ::-1], marker_size=4)
        panels.append(over)
    grid = np.concatenate(panels, axis=1) if panels else np.zeros((64, 64, 3), np.float32)
    write_png(out_path, (grid * 255).astype(np.uint8))


def _smal_overlay_mv(sample, spec, out_path):
    """Render the GT-posed SMAL model through each view's camera and blend it
    over the images (reference multiview_common/smal_render.py used by the
    Streamlit viewer) on the spec's device. Needs GT pose in the sample
    (has_pose)."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.data.canonical_frame import camera_from_opencv_np
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.phong import render_phong

    dev = spec.device

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    theta = torch.cat([t32(sample["global_rot"])[None, None, :], t32(sample["joint_rot"])[None]],
                      dim=1)
    with torch.no_grad():
        out = smil_forward(spec, t32(sample["betas"][: spec.n_betas])[None], theta)
    verts = out.verts[0] + t32(sample["trans"])

    panels = []
    for v in range(sample["images"].shape[0]):
        if not sample["view_mask"][v]:
            continue
        img = sample["images"][v]
        H, W = img.shape[:2]
        Rr, T, fov, aspect = camera_from_opencv_np(
            sample["camera_extrinsics_R"][v], sample["camera_extrinsics_t"][v],
            sample["camera_intrinsics"][v], (H, W))
        cam = default_camera(device=dev).replace(R=t32(Rr), T=t32(T), fov=t32(fov),
                                                 aspect_ratio=t32(aspect))
        pv = cam.world_to_view(verts)
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        shaded = render_phong(verts, pv, ndc, spec.faces, (H, W)).cpu().numpy()
        mask = (shaded < 0.999).any(axis=-1, keepdims=True)  # off-background
        panels.append(np.where(mask, shaded * 0.65 + img * 0.35, img))
    if panels:
        grid = np.concatenate(panels, axis=1)
        write_png(out_path, (np.clip(grid, 0, 1) * 255).astype(np.uint8))
        return True
    return False


def main(argv=None):
    ap = argparse.ArgumentParser(description="Static HTML dataset inspector")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--output", default="dataset_report")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--model", default=None, help="model pkl for raw replicAnt dirs")
    ap.add_argument("--render-smal", action="store_true",
                    help="blend the GT-posed SMAL render over each view "
                         "(needs --model and GT pose in the dataset)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model spec (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from smilify_tpu_torch.data.combined import open_dataset
    from smilify_tpu_torch.data.hdf5_dataset import detect_dataset_type

    joint_names, spec = None, None
    if args.model:
        from smilify_tpu_torch.core.spec import load_model_spec

        spec = load_model_spec(args.model, align_symmetry=False, device=dev)
        joint_names = spec.joint_names
    if args.render_smal and spec is None:
        raise SystemExit("--render-smal needs --model")

    kind = detect_dataset_type(args.dataset)
    ds = open_dataset(args.dataset, joint_names=joint_names)
    n = min(args.samples, len(ds))
    os.makedirs(args.output, exist_ok=True)

    is_mv = "multiview" in kind
    rows = []
    for i in range(n):
        s = ds[i]
        img_name = f"sample_{i}.png"
        if is_mv:
            _overlay_sample_mv(s, os.path.join(args.output, img_name))
            info = (f"views={int(np.sum(s['view_mask']))} "
                    f"has_3d={bool(s.get('has_3d_data'))} "
                    f"vis={float(np.mean(s['keypoint_visibility'])):.2f}")
            if args.render_smal and s.get("has_pose"):
                smal_name = f"sample_{i}_smal.png"
                if _smal_overlay_mv(s, spec, os.path.join(args.output, smal_name)):
                    rows.append(f"<div class='card'><img src='{smal_name}'>"
                                f"<p>#{i} SMAL overlay</p></div>")
        else:
            _overlay_sample_sv(s, os.path.join(args.output, img_name))
            info = f"vis={float(np.mean(s['keypoint_visibility'])):.2f}"
        rows.append(f"<div class='card'><img src='{img_name}'><p>#{i} {html.escape(info)}</p></div>")

    meta = getattr(ds, "metadata", {})
    meta_rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in sorted(meta.items())
    )
    page = f"""<!doctype html><html><head><meta charset='utf-8'>
<title>dataset report</title>
<style>body{{font-family:sans-serif;margin:2em}}.card{{display:inline-block;margin:8px;
vertical-align:top}}.card img{{max-width:640px;border:1px solid #ccc}}table{{border-collapse:
collapse}}td{{border:1px solid #ddd;padding:4px 8px;font-size:13px}}</style></head><body>
<h1>{html.escape(os.path.basename(args.dataset))}</h1>
<p>type: {html.escape(kind)} &middot; {len(ds)} samples</p>
<h2>metadata</h2><table>{meta_rows}</table>
<h2>samples</h2>{''.join(rows)}
</body></html>"""
    index = os.path.join(args.output, "index.html")
    with open(index, "w") as f:
        f.write(page)
    print(f"report → {index}")


if __name__ == "__main__":
    main()
