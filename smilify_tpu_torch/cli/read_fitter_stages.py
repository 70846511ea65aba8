"""Inspect fitter_3d stage results (port of
``smilify_tpu/cli/read_fitter_stages.py``; host numpy, no device) —
equivalent of the reference ``fitter_3d/read_out_fitter_stages.py``: print
parameter summaries from the registration's stage .npz exports
(``fitter/fitter3d.py::StageManager``) and optionally dump posed meshes as
OBJ.

Usage:
  python -m smilify_tpu_torch.cli.read_fitter_stages --npz results/Stage2.npz [--export-obj dir]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", required=True)
    ap.add_argument("--export-obj", default=None)
    args = ap.parse_args(argv)

    data = np.load(args.npz, allow_pickle=True)
    labels = [str(x) for x in data["labels"]] if "labels" in data else None
    n = data["verts"].shape[0]
    print(f"{args.npz}: {n} fitted meshes")
    for i in range(n):
        name = labels[i] if labels else f"mesh_{i}"
        parts = [name]
        if "betas" in data:
            parts.append("betas=" + np.array2string(data["betas"][i], precision=3))
        if "trans" in data:
            parts.append("trans=" + np.array2string(data["trans"][i], precision=3))
        if "global_rot" in data:
            parts.append("rot=" + np.array2string(data["global_rot"][i], precision=3))
        if "deform_verts" in data:
            parts.append(f"|deform|max={np.abs(data['deform_verts'][i]).max():.4f}")
        print("  " + "  ".join(parts))

    if args.export_obj:
        from smilify_tpu_torch.utils.export import save_obj

        os.makedirs(args.export_obj, exist_ok=True)
        faces = data["faces"]
        for i in range(n):
            name = labels[i] if labels else f"mesh_{i}"
            path = os.path.join(args.export_obj, f"{name}.obj")
            save_obj(path, data["verts"][i], faces)
            print(f"  → {path}")


if __name__ == "__main__":
    main()
