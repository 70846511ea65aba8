"""Progressive (coarse-to-fine) against fixed-resolution fitting over a whole
schedule (port of ``tools/bench_progressive.py``).

    python -m smilify_tpu_torch.tools.bench_progressive [--size 512] [--chunk 10]
        [--scales 1,4,2,1] [--model PKL] [--device cuda]
        [--out build/progressive_bench.json]

Fits a rendered target (``synthetic_fit_data``, 1 frame) with the reference
schedule ``OPT_WEIGHTS`` (600 + 400 + 600 + 600 steps) at fixed resolution
and with the pyramid, and reports wall time and fit quality (IoU at full
resolution, mean keypoint error). Two passes each: the first includes the kernel build and the
allocator's warm-up, the second is the steady state. Writes ``--out`` and
prints the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from smilify_tpu_torch._device import card_line, resolve_device
from smilify_tpu_torch.bench import load_spec
from smilify_tpu_torch.fitter.fitter import SmalFitter, render_frame, synthetic_fit_data
from smilify_tpu_torch.fitter.progressive import ProgressiveFitter
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
from smilify_tpu_torch.render.cameras import default_camera
from smilify_tpu_torch.tools._timing import sync
from smilify_tpu_torch.utils.visualization import silhouette_iou

OUT = Path(__file__).resolve().parents[2] / "build" / "progressive_bench.json"


def fit_quality(spec, fitter, data, image_size):
    """(IoU of the fitted silhouette with the target, mean |keypoint error| px)
    of frame 0 at full resolution."""
    verts, joints3d = fitter.forward_frames()
    cam = default_camera(device=spec.device).replace(fov=fitter.params.fov[0])
    with torch.no_grad():
        sil_r, kp_yx = render_frame(spec, cam, verts[0], joints3d[0], image_size)
    iou = silhouette_iou(sil_r, data.sil[0])
    kp_err = float(torch.abs(kp_yx - data.joints[0]).mean())
    return iou, kp_err


def run(mode, spec, data, size, chunk, scales, schedule):
    """(wall seconds, IoU, keypoint error) of one whole fit."""
    dev = spec.device
    if mode == "progressive":
        fitter = ProgressiveFitter(spec, data, (size, size), scales=scales, device=dev)
    else:
        fitter = SmalFitter(spec, data, (size, size), device=dev)
    t0 = time.perf_counter()
    fitter.fit(schedule, chunk=chunk)
    sync(fitter.params)
    wall = time.perf_counter() - t0
    iou, kp = fit_quality(spec, fitter, data, (size, size))
    return wall, iou, kp


def main(argv=None):
    ap = argparse.ArgumentParser(description="progressive against fixed-resolution fitting")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--scales", default="1,4,2,1")
    ap.add_argument("--model", default=None, help="model pickle (default: the STICK-width toy spec)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    spec, name = load_spec(args.model, dev)
    data = synthetic_fit_data(spec, 1, (args.size, args.size))
    scales = tuple(int(s) for s in args.scales.split(","))

    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "card": card_line() if dev.type == "cuda" else None, "model": name,
           "size": args.size, "chunk": args.chunk, "scales": list(scales),
           "schedule_iters": [w.num_iters for w in OPT_WEIGHTS]}
    for mode in ("fixed", "progressive"):
        walls = []
        for p in range(2):
            wall, iou, kp = run(mode, spec, data, args.size, args.chunk, scales, OPT_WEIGHTS)
            walls.append(wall)
            print(f"{mode} pass{p}: {wall:.3f}s  IoU={iou:.4f}  kp={kp:.3f}px", flush=True)
        out[mode] = {"wall_first_s": walls[0], "wall_steady_s": walls[1],
                     "final_iou": iou, "final_kp_err_px": kp}
    out["steady_speedup"] = out["fixed"]["wall_steady_s"] / out["progressive"]["wall_steady_s"]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
