"""Scatter plots of PCA morph-data CSVs (port of
``smilify_tpu/cli/plot_pca_data.py``) — equivalent of the reference root
``plot_pca_data.py``: visualize the per-bone scale/translation principal
components exported by the authoring tools (the replicAnt plugin's CSV
schema), read through the native loader (``utils/smil_tools_native.py``).

Host only; the plots are drawn by ``utils/plotting.py`` (numpy and OpenCV),
at the JAX CLI's file names and sizes.

Usage:
  python -m smilify_tpu_torch.cli.plot_pca_data --csv pca.csv [--out plots/]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="PCA morph-data CSV → per-component scatter plots")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--out", default="pca_plots")
    ap.add_argument("--components", type=int, default=None, help="first N PCs to plot")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.utils import plotting
    from smilify_tpu_torch.utils.smil_tools_native import PCAMorphData

    d = PCAMorphData(args.csv)
    os.makedirs(args.out, exist_ok=True)
    C = min(args.components or d.num_components, d.num_components)
    xs = np.arange(d.num_bones)

    for c in range(C):
        fig, axes = plotting.subplots(2, 1, figsize=(max(8, d.num_bones * 0.35), 6), sharex=True)
        for ax, data, title in (
            (axes[0], d.scaledirs[:, :, c], f"PC_{c+1} scale"),
            (axes[1], d.transdirs[:, :, c], f"PC_{c+1} translation"),
        ):
            for i, lbl in enumerate("xyz"):
                ax.scatter(xs, data[:, i], s=14, label=lbl)
            ax.axhline(0, color="gray", lw=0.5)
            ax.set_title(title)
            ax.legend(loc="upper right", fontsize=8)
        axes[1].set_xticks(xs)
        axes[1].set_xticklabels(d.bone_names, rotation=90, fontsize=7)
        path = os.path.join(args.out, f"pc_{c+1}.png")
        fig.savefig(path, dpi=120)
        print(f"→ {path}")


if __name__ == "__main__":
    main()
