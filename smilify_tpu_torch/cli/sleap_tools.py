"""SLEAP/multi-view dataset toolchain CLIs.

One entry point with subcommands covering the reference's six standalone
scripts (each cites its counterpart):

  triangulate     sleap_data/triangulate_3d_points.py — per-camera SLEAP
                  predictions + anipose calibration.toml → points3d.h5 (DLT,
                  min_views / min_confidence gating, optional undistortion)
  refine-cameras  sleap_data/refine_camera_params.py — alternating
                  triangulate → per-camera 10-parameter reprojection
                  refinement → refined calibration.toml
  reproject       sleap_data/generate_reprojections.py — points3d.h5 +
                  calibration → ideal-pinhole reprojections.h5 (per-camera
                  datasets, the undistorted 2D supervision consumed by
                  --use-reprojections in the preprocessors)
  merge           multiview_common/merge_multiview_datasets.py — concatenate
                  multi-view HDF5 datasets (pad to widest max_views, optional
                  per-dataset world-scale factors)
  filter          multiview_common/filter_multiview_dataset.py — supervision-
                  quality filtering (low-visibility views masked, behind-camera
                  views masked, under-viewed samples dropped)
  match-scale     multiview_common/match_scale_multiview_dataset.py — estimate
                  (median camera-distance ratio) and/or apply a world-scale
                  factor so cross-domain datasets share units

Usage:
  python -m smilify_tpu_torch.cli.sleap_tools triangulate --session <dir> \
      [--calibration cal.toml] [--output points3d.h5] [--min-views 2]
  python -m smilify_tpu_torch.cli.sleap_tools refine-cameras --session <dir> \
      --output refined.toml [--iters 3]
  python -m smilify_tpu_torch.cli.sleap_tools reproject --points3d p.h5 \
      --calibration cal.toml --output reprojections.h5
  python -m smilify_tpu_torch.cli.sleap_tools merge a.h5 b.h5 --output out.h5 \
      [--scale-factors 1.0,27.0]
  python -m smilify_tpu_torch.cli.sleap_tools filter in.h5 --output out.h5 \
      [--min-visible-keypoints 5] [--min-views 2] [--keep-behind-camera]
  python -m smilify_tpu_torch.cli.sleap_tools match-scale a.h5 --output out.h5 \
      (--scale 27.0 | --reference-dataset b.h5) [--estimate-only]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_session_tracks(session_dir, cams, track=0):
    """Session dir → synchronized (F, V, K, 2) tracks + (F, V, K) scores.

    V follows the calibration's camera order; a camera without predictions
    contributes NaNs (it simply never meets min_views). F is the max track
    length across cameras; shorter tracks are NaN-padded at the tail."""
    from smilify_tpu_torch.data.sleap_raw import find_session_layout, read_sleap_predictions

    layout = find_session_layout(session_dir)
    per_cam = {}
    K = None
    for cam in cams:
        entry = layout.get(cam.name)
        if entry is None or "predictions" not in entry:
            print(f"warning: no predictions for camera {cam.name!r} in {session_dir}")
            continue
        pts, scores, _nodes = read_sleap_predictions(entry["predictions"], track=track)
        per_cam[cam.name] = (pts, scores)
        if K is None:
            K = pts.shape[1]
        elif pts.shape[1] != K:
            raise SystemExit(
                f"camera {cam.name!r} has {pts.shape[1]} nodes, expected {K} "
                "(all cameras must share one skeleton)"
            )
    if not per_cam:
        raise SystemExit(f"no per-camera predictions found in {session_dir}")
    F = max(p.shape[0] for p, _ in per_cam.values())
    V = len(cams)
    points2d = np.full((F, V, K, 2), np.nan, np.float64)
    conf = np.zeros((F, V, K), np.float64)
    for v, cam in enumerate(cams):
        if cam.name not in per_cam:
            continue
        pts, scores = per_cam[cam.name]
        points2d[: pts.shape[0], v] = pts
        conf[: scores.shape[0], v] = np.nan_to_num(scores)
    return points2d, conf


def _resolve_calibration(args):
    from smilify_tpu_torch.data.sleap import load_calibration_toml

    path = args.calibration
    if path is None and getattr(args, "session", None):
        cand = os.path.join(args.session, "calibration.toml")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise SystemExit("no --calibration given and none found in the session")
    return load_calibration_toml(path)


def cmd_triangulate(args):
    from smilify_tpu_torch.data.sleap import triangulate_frames, write_points3d_h5

    cams = _resolve_calibration(args)
    points2d, scores = load_session_tracks(args.session, cams, track=args.track)
    pts3d, valid = triangulate_frames(
        points2d, scores, cams, min_views=args.min_views,
        min_confidence=args.min_confidence, undistort=not args.no_undistort,
    )
    out = args.output or os.path.join(args.session, "points3d.h5")
    write_points3d_h5(out, pts3d, metadata={
        "min_views": args.min_views, "min_confidence": args.min_confidence,
        "undistort": not args.no_undistort, "n_cameras": len(cams),
    })
    F, K = valid.shape
    print(f"triangulated {int(valid.sum())}/{F * K} joints "
          f"({F} frames x {K} joints, {len(cams)} cameras) → {out}")


def cmd_refine_cameras(args):
    from smilify_tpu_torch.data.sleap import (
        refine_cameras,
        reprojection_error,
        save_calibration_toml,
        triangulate_frames,
    )

    cams = _resolve_calibration(args)
    points2d, scores = load_session_tracks(args.session, cams, track=args.track)
    pts3d, _ = triangulate_frames(points2d, scores, cams,
                                  min_views=args.min_views,
                                  min_confidence=args.min_confidence)
    before = reprojection_error(cams, pts3d, points2d, scores, args.min_confidence)
    refined, after = refine_cameras(
        points2d, scores, cams, n_outer=args.iters,
        min_views=args.min_views, min_confidence=args.min_confidence,
        verbose=True,
    )
    save_calibration_toml(args.output, refined)
    print(f"mean reprojection error {before:.4f} → {after:.4f} px → {args.output}")


def cmd_reproject(args):
    from smilify_tpu_torch.data.sleap import generate_reprojections, read_points3d_h5
    from smilify_tpu_torch.utils import hdf5_io

    cams = _resolve_calibration(args)
    pts3d = read_points3d_h5(args.points3d)
    reproj = generate_reprojections(pts3d, cams)  # (F, V, K, 2)
    with hdf5_io.File(args.output, "w") as f:
        for v, cam in enumerate(cams):
            f.create_dataset(cam.name, data=reproj[:, v])
        f.attrs["n_cameras"] = len(cams)
        f.attrs["source_points3d"] = os.path.abspath(args.points3d)
    finite = int(np.isfinite(reproj).all(axis=-1).sum())
    print(f"wrote {finite} reprojected joints over {len(cams)} cameras → {args.output}")


def cmd_merge(args):
    from smilify_tpu_torch.data.dataset_tools import merge_multiview_datasets

    scales = None
    if args.scale_factors:
        scales = [float(s) for s in args.scale_factors.split(",")]
        if len(scales) != len(args.inputs):
            raise SystemExit(
                f"--scale-factors has {len(scales)} entries for {len(args.inputs)} inputs"
            )
    merge_multiview_datasets(list(args.inputs), args.output, scale_factors=scales)
    print(f"merged {len(args.inputs)} datasets → {args.output}")


def cmd_filter(args):
    from smilify_tpu_torch.data.dataset_tools import filter_multiview_dataset

    _, stats = filter_multiview_dataset(
        args.input, args.output,
        min_visible_keypoints=args.min_visible_keypoints,
        min_views=args.min_views,
        drop_behind_camera=not args.keep_behind_camera,
    )
    print(f"masked {stats['views_masked']} views, dropped "
          f"{stats['samples_dropped']} samples → {args.output}")


def cmd_match_scale(args):
    from smilify_tpu_torch.data.dataset_tools import (
        estimate_world_scale_ratio,
        match_scale_multiview_dataset,
    )

    scale = args.scale
    if scale is None:
        if not args.reference_dataset:
            raise SystemExit("give --scale or --reference-dataset to estimate it")
        scale = estimate_world_scale_ratio(args.reference_dataset, args.input)
        print(f"estimated world-scale ratio (reference/input): {scale:.4f}")
    if args.estimate_only:
        return
    if not args.output:
        raise SystemExit("--output required unless --estimate-only")
    match_scale_multiview_dataset(args.input, args.output, scale)
    print(f"applied scale {scale:.4f} → {args.output}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m smilify_tpu_torch.cli.sleap_tools",
        description="SLEAP/multi-view dataset toolchain",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    tri = sub.add_parser("triangulate", help="2D predictions → points3d.h5 (DLT)")
    tri.add_argument("--session", required=True, help="session dir (per-camera predictions)")
    tri.add_argument("--calibration", default=None, help="anipose calibration.toml")
    tri.add_argument("--output", default=None, help="default <session>/points3d.h5")
    tri.add_argument("--min-views", type=int, default=2)
    tri.add_argument("--min-confidence", type=float, default=0.3)
    tri.add_argument("--no-undistort", action="store_true")
    tri.add_argument("--track", type=int, default=0, help="track/instance index")
    tri.set_defaults(func=cmd_triangulate)

    ref = sub.add_parser("refine-cameras", help="alternating camera refinement")
    ref.add_argument("--session", required=True)
    ref.add_argument("--calibration", default=None)
    ref.add_argument("--output", required=True, help="refined calibration.toml")
    ref.add_argument("--iters", type=int, default=3)
    ref.add_argument("--min-views", type=int, default=2)
    ref.add_argument("--min-confidence", type=float, default=0.3)
    ref.add_argument("--track", type=int, default=0)
    ref.set_defaults(func=cmd_refine_cameras)

    rp = sub.add_parser("reproject", help="points3d + calibration → reprojections.h5")
    rp.add_argument("--points3d", required=True)
    rp.add_argument("--calibration", required=True)
    rp.add_argument("--output", required=True)
    rp.set_defaults(func=cmd_reproject)

    mg = sub.add_parser("merge", help="concatenate multi-view HDF5 datasets")
    mg.add_argument("inputs", nargs="+")
    mg.add_argument("--output", required=True)
    mg.add_argument("--scale-factors", default=None,
                    help="comma-separated per-input world-scale factors")
    mg.set_defaults(func=cmd_merge)

    fl = sub.add_parser("filter", help="supervision-quality filtering")
    fl.add_argument("input")
    fl.add_argument("--output", required=True)
    fl.add_argument("--min-visible-keypoints", type=int, default=5)
    fl.add_argument("--min-views", type=int, default=2)
    fl.add_argument("--keep-behind-camera", action="store_true")
    fl.set_defaults(func=cmd_filter)

    ms = sub.add_parser("match-scale", help="estimate/apply a world-scale factor")
    ms.add_argument("input")
    ms.add_argument("--output", default=None)
    ms.add_argument("--scale", type=float, default=None)
    ms.add_argument("--reference-dataset", default=None,
                    help="estimate scale as median camera-distance ratio vs this dataset")
    ms.add_argument("--estimate-only", action="store_true")
    ms.set_defaults(func=cmd_match_scale)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
