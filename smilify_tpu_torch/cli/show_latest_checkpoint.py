"""Show the latest fitting-checkpoint results (a copy of
``smilify_tpu/cli/show_latest_checkpoint.py``; host only) — equivalent of
the reference ``utilities/show_latest_checkpoint_results.py``: find the
newest checkpoint directory and print the most recent stage/epoch exports
per frame.

Usage:
  python -m smilify_tpu_torch.cli.show_latest_checkpoint [--root checkpoints] [--copy-to dir]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil


def latest_run(root: str):
    runs = sorted(
        (d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d)),
        key=os.path.getmtime,
    )
    return runs[-1] if runs else None


def latest_exports(run_dir: str):
    """Per frame dir, the highest (stage, epoch) png/pkl/ply triple."""
    out = {}
    pat = re.compile(r"st(\d+)_ep(\d+)\.png$")
    for frame_dir in sorted(glob.glob(os.path.join(run_dir, "*"))):
        if not os.path.isdir(frame_dir):
            continue
        best = None
        for png in glob.glob(os.path.join(frame_dir, "st*_ep*.png")):
            m = pat.search(png)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                if best is None or key > best[0]:
                    best = (key, png)
        if best:
            out[os.path.basename(frame_dir)] = best[1]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="checkpoints")
    ap.add_argument("--run", default=None, help="specific run directory (default: newest)")
    ap.add_argument("--copy-to", default=None, help="copy the latest pngs here")
    args = ap.parse_args(argv)

    run = args.run or latest_run(args.root)
    if run is None:
        raise SystemExit(f"no runs under {args.root}")
    exports = latest_exports(run)
    print(f"run: {run} ({len(exports)} frames)")
    for frame, png in exports.items():
        print(f"  {frame}: {png}")
        if args.copy_to:
            os.makedirs(args.copy_to, exist_ok=True)
            shutil.copy(png, os.path.join(args.copy_to, f"{frame}_{os.path.basename(png)}"))
    if args.copy_to:
        print(f"copied → {args.copy_to}")


if __name__ == "__main__":
    main()
