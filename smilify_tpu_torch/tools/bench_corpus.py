"""Corpus-fitting throughput: ``BatchedFitter`` over S clips in one
optimization against one ``SmalFitter`` clip (port of ``tools/bench_corpus.py``).

    python -m smilify_tpu_torch.tools.bench_corpus [--clips 8] [--size 256] [--chunk 10]
        [--model PKL] [--device cuda]

The reference fits one clip per process, so its corpus throughput is the
single-clip rate at best; the batched fitter puts all S clips' frames into
each raster launch. Both fit the same kind of target, random noise
silhouettes and joints (``make_data``), in stage 1 (full loss, raster on),
one frame a clip. Prints one JSON line with the batched and single-clip
step times and the speedup.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from smilify_tpu_torch._device import card_line, resolve_device, set_float32_matmul
from smilify_tpu_torch.bench import load_spec
from smilify_tpu_torch.fitter.fitter import FitData, SmalFitter
from smilify_tpu_torch.fitter.fitter_batch import BatchedFitter
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
from smilify_tpu_torch.tools._timing import sync


def make_data(spec, S, N, H, W, seed=0):
    """Noise targets: (S, N, ...) clips, or one (N, ...) clip when S is 0."""
    rng = np.random.RandomState(seed)
    shape = (S, N) if S else (N,)
    dev = spec.device
    return FitData(
        rgb=None,
        sil=torch.as_tensor((rng.rand(*shape, H, W) > 0.7).astype(np.float32)).to(dev),
        joints=torch.as_tensor(rng.rand(*shape, spec.n_joints, 2).astype(np.float32) * H).to(dev),
        visibility=torch.ones(shape + (spec.n_joints,), device=dev),
    )


def time_stage(fitter, stage_weights, chunk, warm_iters=1):
    """Wall seconds per optimization iteration of stage 1 (full loss, raster on)."""
    fitter.run_stage(1, stage_weights._replace(num_iters=chunk * warm_iters), chunk=chunk)
    n = chunk * 4
    w = stage_weights._replace(num_iters=n)
    sync(fitter.params)
    t0 = time.perf_counter()
    fitter.run_stage(1, w, chunk=chunk)
    sync(fitter.params)
    return (time.perf_counter() - t0) / n


def run(spec, model_name, clips=8, size=256, chunk=10) -> dict:
    S, N, H = clips, 1, size
    stage = OPT_WEIGHTS[1]
    dev = spec.device
    # one clip's iteration time: S clips one after another cost S× this
    single = SmalFitter(spec, make_data(spec, 0, N, H, H), (H, H), device=dev)
    t_single = time_stage(single, stage, chunk)
    batched = BatchedFitter(spec, make_data(spec, S, N, H, H), (H, H), device=dev)
    t_batched = time_stage(batched, stage, chunk)
    clip_iters_batched = S / t_batched
    clip_iters_seq = 1.0 / t_single
    return {
        "clips": S, "frames_per_clip": N, "image": H, "chunk": chunk,
        "single_clip_iter_ms": t_single * 1e3,
        "batched_step_ms": t_batched * 1e3,
        "clip_iters_per_s_batched": clip_iters_batched,
        "clip_iters_per_s_sequential": clip_iters_seq,
        "speedup_vs_sequential": clip_iters_batched / clip_iters_seq,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "model": model_name,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="BatchedFitter over S clips against one SmalFitter clip")
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--model", default=None, help="model pickle (default: the STICK-width toy spec)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_matmul(dev)
    spec, name = load_spec(args.model, dev)
    print(json.dumps(run(spec, name, args.clips, args.size, args.chunk)), flush=True)


if __name__ == "__main__":
    main()
