"""Scan-mesh preparation CLI — stl/obj → cleaned, decimated obj + stats
(port of ``smilify_tpu/cli/prepare_meshes.py``; host numpy, no device).

Equivalent of the reference ``custom_processing/prepare_antscan_data_for_mesh_fitting.py``
(Blender batch pipeline) + ``batch_process_models.py`` + the proofread stats /
caste separation script, minus the Blender-only and scraping parts: per input
mesh it extracts the largest connected component, decimates to a vertex
budget, writes an .obj ready for ``cli.optimise_3d`` mesh fitting, and
appends a quality-stats row (components, holes, face-size CoV, smoothness).

Usage:
  python -m smilify_tpu_torch.cli.prepare_meshes IN_DIR OUT_DIR \
      [--max-vertices 20000] [--caste-lookup lookup.csv] [--report stats.csv]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np


def load_any_mesh(path: str):
    from smilify_tpu_torch.utils.export import load_obj
    from smilify_tpu_torch.utils.mesh_prep import load_stl

    if path.lower().endswith(".stl"):
        return load_stl(path)
    return load_obj(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--max-vertices", type=int, default=20000)
    ap.add_argument("--keep-all-components", action="store_true")
    ap.add_argument("--caste-lookup", default=None,
                    help="substring→caste CSV; outputs are grouped into caste subdirs")
    ap.add_argument("--report", default=None, help="stats CSV (default OUT/stats.csv)")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.utils.mesh_prep import (
        decimate_vertex_clustering,
        largest_component,
        mesh_stats,
        save_obj,
        separate_by_caste,
    )

    files = sorted(
        p for ext in ("*.stl", "*.STL", "*.obj", "*.OBJ")
        for p in glob.glob(os.path.join(args.input_dir, ext))
    )
    if not files:
        raise SystemExit(f"no .stl/.obj meshes under {args.input_dir}")

    lookup = {}
    if args.caste_lookup:
        with open(args.caste_lookup, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2 and row[0].strip():
                    lookup[row[0].strip()] = row[1].strip()
    names = [os.path.splitext(os.path.basename(p))[0] for p in files]
    castes = separate_by_caste(names, lookup) if lookup else {"": names}
    caste_of = {n: c for c, ns in castes.items() for n in ns}

    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    for path, name in zip(files, names):
        # unlike the JAX CLI, a mesh that fails stops the run (with its name)
        # instead of being skipped with a warning
        try:
            verts, faces = load_any_mesh(path)
        except Exception as e:
            raise RuntimeError(f"{path}: {type(e).__name__}: {e}") from e
        raw_stats = mesh_stats(verts, faces)
        if not args.keep_all_components:
            verts, faces = largest_component(np.asarray(verts), np.asarray(faces))
        verts, faces = decimate_vertex_clustering(verts, faces, args.max_vertices)
        sub = caste_of.get(name, "")
        out_dir = os.path.join(args.output_dir, sub) if sub else args.output_dir
        os.makedirs(out_dir, exist_ok=True)
        out = save_obj(os.path.join(out_dir, name + ".obj"), verts, faces)
        row = {"name": name, "caste": sub or "n/a", **raw_stats,
               "out_vertices": len(verts), "out_faces": len(faces)}
        rows.append(row)
        print(f"{name}: {raw_stats['n_vertices']}→{len(verts)} verts, "
              f"{raw_stats['n_components']} comps, {raw_stats['n_holes']} holes → {out}")

    report = args.report or os.path.join(args.output_dir, "stats.csv")
    if rows:
        with open(report, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"stats → {report} ({len(rows)} meshes)")


if __name__ == "__main__":
    main()
