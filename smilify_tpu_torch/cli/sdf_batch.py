"""Batch SDF computation CLI (port of ``smilify_tpu/cli/sdf_batch.py``; the
reference ``fitter_3d/SDF_batch.py``): the Spatial Diameter Function of
every ``.obj`` in a directory (ray-cast sampling + kNN smoothing +
per-vertex assignment), stored as a pickle the 3D registration's SDF loss
reads (``fitter_3d/optimise.py:113-171``).

Usage:
  python -m smilify_tpu_torch.cli.sdf_batch --mesh_dir <dir> --output sdf_values.pkl \\
      [--num-samples 1000] [--num-rays 30] [--smooth-k 100] [--assign-k 10] [--device cuda]

The draws come from one ``torch.Generator`` seeded from ``--seed``.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import time

import torch

from smilify_tpu_torch._device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch spatial-diameter-function computation")
    ap.add_argument("--mesh_dir", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--num-samples", type=int, default=1000)
    ap.add_argument("--num-rays", type=int, default=30)
    ap.add_argument("--smooth-k", type=int, default=100)
    ap.add_argument("--assign-k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the rays are cast: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    from smilify_tpu_torch.ops.sdf import assign_vertex_sdf, compute_sdf, smooth_sdf
    from smilify_tpu_torch.utils.export import load_obj

    paths = sorted(glob.glob(os.path.join(args.mesh_dir, "*.obj")))
    if not paths:
        raise SystemExit(f"no .obj files in {args.mesh_dir}")
    out_path = args.output or os.path.join(args.mesh_dir, "sdf_values.pkl")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    results = {}
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        verts_np, faces_np = load_obj(p)
        verts, faces = torch.from_numpy(verts_np).to(dev), torch.from_numpy(faces_np).to(dev)
        t0 = time.time()
        with torch.no_grad():
            pts, diam = compute_sdf(verts, faces, gen, num_samples=args.num_samples,
                                    num_rays=args.num_rays)
            smoothed = smooth_sdf(pts, diam, k=min(args.smooth_k, args.num_samples))
            vertex_sdf = assign_vertex_sdf(verts, pts, smoothed, k=args.assign_k)
        results[name] = {
            "vertex_sdf": vertex_sdf.cpu().numpy(),
            "sample_points": pts.cpu().numpy(),
            "sample_sdf": smoothed.cpu().numpy(),
        }
        print(f"{name}: V={len(verts_np)} F={len(faces_np)} "
              f"sdf range [{float(vertex_sdf.min()):.4f}, {float(vertex_sdf.max()):.4f}] "
              f"({time.time()-t0:.1f}s)")

    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    print(f"→ {out_path} ({len(results)} meshes)")
    return out_path


if __name__ == "__main__":
    main()
