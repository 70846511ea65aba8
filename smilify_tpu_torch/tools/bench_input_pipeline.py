"""Does the host input pipeline starve the single-view trainer? (port of
``tools/bench_input_pipeline.py``)

    python -m smilify_tpu_torch.tools.bench_input_pipeline [--modes synthetic serial ...]
        [--batch 8] [--steps 10] [--workers 8] [--res 224] [--frames 32] [--device cuda]

Times the single-view train step (ResNet-50, IEF head 2 deep × 2
iterations, AdamW 1e-4, rotation and shape losses) a step at batch 8 with
its batches from each loader mode:

  * synthetic       — one batch already on the device, replayed (the step alone),
  * serial          — the dataset read in the loop,
  * threaded        — ``iterate_batches``' thread pool,
  * process         — its spawn process pools,
  * cached          — ``DecodedSampleCache`` (decode once),
  * cached_threaded — the cache and the thread pool,
  * cached_staged   — the cache and ``StagingCollator``'s pinned ring (the
                      trainer CLIs' host pipeline).

The data is a replicAnt folder of ``--frames`` PNG frames that
``tools/synthetic_data.py::write_replicant_sequence(layout="unreal")``
writes under ``--work`` (the JAX bench's reference data is not in the
repository). Each mode runs in a process of its own, so that one mode's
allocations and worker pools do not weigh on the next. The pipeline is
healthy when the best loader mode is within ~2× of synthetic. Prints one
JSON line: ms a step for each mode, and the seconds of each mode's set-up
(model, data, two warm-up steps) and of its whole process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device

MODES = ("synthetic", "serial", "threaded", "process", "cached", "cached_threaded",
         "cached_staged")
WORK = Path(__file__).resolve().parents[2] / "build" / "input_pipeline"


def write_data(work: Path, frames: int, res: int, device="cpu") -> tuple:
    """(model pickle, replicAnt folder) of the STICK-width toy spec, its
    frames rendered on ``device``."""
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence

    work.mkdir(parents=True, exist_ok=True)
    spec, _ = load_spec(None, torch.device(device))
    pkl = write_model_pkl(str(work / "stick_width.pkl"), spec)
    folder, _ = write_replicant_sequence(str(work / "seq"), spec, frames, res, layout="unreal")
    return pkl, folder


def run_mode(args) -> dict:
    """ms a step of ``args.mode`` (this process runs that mode alone), and
    the seconds its set-up (model, data, first steps) took."""
    t_setup = time.perf_counter()
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data.cache import DecodedSampleCache
    from smilify_tpu_torch.data.replicant import ReplicantDataset
    from smilify_tpu_torch.models.regressor import RegressorConfig, SMILRegressor, compute_batch_loss
    from smilify_tpu_torch.tools._timing import sync
    from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn
    from smilify_tpu_torch.train.trainer import (
        PlainAdam,
        StagingCollator,
        iterate_batches,
        make_train_step,
        narrow_floats,
    )

    dev = resolve_device(args.device)
    spec = load_model_spec(args.model_pkl, align_symmetry=False, device=dev)
    ds = ReplicantDataset(args.data, spec.joint_names, image_size=args.res)
    torch.manual_seed(0)
    cfg = RegressorConfig(backbone="resnet50", n_pose=spec.n_joints - 1, n_betas=spec.n_betas,
                          n_joints=spec.n_joints, decoder_depth=2, ief_iters=2)
    model = SMILRegressor(cfg, img_size=args.res).to(dev).train()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    def loss_fn(preds, batch):
        targets = {"global_rot": batch["global_rot"], "joint_rot": batch["joint_rot"],
                   "betas": batch["betas"][..., : spec.n_betas]}
        return compute_batch_loss(spec, cfg, preds, targets,
                                  {"global_rot": 1.0, "joint_rot": 1.0, "betas": 1.0},
                                  image_size=(args.res, args.res))

    step = make_train_step(model, make_singleview_apply_fn(cfg, spec), loss_fn,
                           PlainAdam(model, 1e-4, weight_decay=1e-4))
    staging = StagingCollator()
    rng = np.random.default_rng(0)

    def on_device(b):
        return narrow_floats(staging.to_device(b, dev) if isinstance(b["image"], torch.Tensor)
                             else {k: torch.as_tensor(v).to(dev) for k, v in b.items()})

    def loader(dataset, workers=0, mode="thread", collate=None):
        while True:      # cycle the folder to fill the steps
            for b in iterate_batches(dataset, args.batch, rng, num_workers=workers,
                                     worker_mode=mode, collate=collate):
                yield on_device(b)

    warm = on_device(next(iterate_batches(ds, args.batch, rng, shuffle=False)))
    for _ in range(2):
        loss, _ = step(warm)
    sync(loss)
    mode = args.mode
    if mode == "synthetic":
        def replay():
            while True:
                yield warm
        batches = replay()
    elif mode in ("serial", "threaded", "process"):
        workers = {"serial": 0, "threaded": args.workers,
                   "process": min(args.workers, os.cpu_count() or 1)}[mode]
        batches = loader(ds, workers, "process" if mode == "process" else "thread")
    else:
        cached = DecodedSampleCache(ds, eager=True)
        batches = {"cached": lambda: loader(cached),
                   "cached_threaded": lambda: loader(cached, args.workers),
                   "cached_staged": lambda: loader(cached, collate=staging)}[mode]()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss, _ = step(next(batches))
    sync(loss)          # a value fetch: the device has finished every step
    return {"step_ms": (time.perf_counter() - t0) / args.steps * 1000,
            "setup_s": t0 - t_setup}


def main(argv=None):
    ap = argparse.ArgumentParser(description="the single-view trainer's input pipeline, mode by mode")
    ap.add_argument("--modes", nargs="*", default=list(MODES), choices=MODES)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--frames", type=int, default=32, help="frames in the replicAnt folder")
    ap.add_argument("--work", type=Path, default=WORK)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=MODES, default=None, help="(internal) run one mode here")
    ap.add_argument("--data", default=None, help="(internal) the replicAnt folder")
    ap.add_argument("--model-pkl", default=None, help="(internal) the model pickle")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode:
        print(json.dumps({"mode": args.mode, **run_mode(args)}), flush=True)
        return None

    pkl, folder = write_data(args.work, args.frames, args.res, dev)
    results, setup, wall = {}, {}, {}
    for mode in args.modes:
        cmd = [sys.executable, "-m", "smilify_tpu_torch.tools.bench_input_pipeline",
               "--mode", mode, "--data", folder, "--model-pkl", pkl, "--batch", str(args.batch),
               "--steps", str(args.steps), "--workers", str(args.workers), "--res", str(args.res),
               "--device", dev.type]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                             cwd=Path(__file__).resolve().parents[2])
        wall[mode] = time.perf_counter() - t0
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or not lines:
            raise RuntimeError(f"mode {mode} failed (exit {out.returncode}):\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        rec = json.loads(lines[-1])
        results[mode], setup[mode] = rec["step_ms"], rec["setup_s"]
        print(f"{mode}: {results[mode]:.2f} ms/step (set-up {setup[mode]:.1f} s, process "
              f"{wall[mode]:.1f} s)", flush=True)
    loaders = [v for m, v in results.items() if m != "synthetic"]
    report = {"batch": args.batch, "resolution": args.res, "steps": args.steps,
              "dataset": "replicant_raw (PNG)", "frames": args.frames, "device": dev.type,
              "host_cores": os.cpu_count(),
              **{f"{m}_step_ms": v for m, v in results.items()},
              **{f"{m}_setup_s": v for m, v in setup.items()},
              **{f"{m}_process_s": v for m, v in wall.items()}}
    if "synthetic" in results and loaders:
        report["best_loader_overhead_vs_synthetic_pct"] = 100 * (
            min(loaders) / results["synthetic"] - 1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
