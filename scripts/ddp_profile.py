"""One-off measurement: config 4b's data-parallel train step (ResNet-50 +
IEF at 224², bf16, Adam) over every rank of a torch.distributed.run launch,
one rank a card over NCCL, at a global batch of 128.

    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \\
        scripts/ddp_profile.py [--steps 10] [--out build/ddp_profile.json]

The step runs with its BatchNorms' statistics taken three ways:

* ``fused``: the global batch's, through the fused passes the card uses
  (``models/backbones.py::_GlobalBatchNorm``);
* ``plain``: the global batch's, through the per-channel sums in float64
  the CPU uses (``FlaxBatchNorm2d._global_batch_forward``), put on the card
  for this comparison;
* ``local``: each rank's own rows (DistributedDataParallel's default).

For each, images/s over ``--steps`` steps after two, then one step under
torch.profiler on rank 0: the step's wall, the device time of its kernels
by class (convolutions and matrix products, batch normalization, NCCL,
the rest), the launches of each class, the share of the wall the busiest
stream was busy, and the kernels that took the most device time. Rank 0 alone then times the undistributed step at the global
batch and at one rank's rows (does a rank's host time shrink with its
batch?). Prints the card's name and power limit, then one JSON line, which
``--out`` also gets.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GLOBAL_B = 128
TOP_KERNELS = 8
RANGES = ("DistributedDataParallel", "nccl:", "gloo:", "ProfilerStep")
CLASSES = (("nccl", ("nccl",)),
           ("batch_norm", ("batch_norm", "bn_", "welford", "batchnorm")),
           ("conv_matmul", ("conv", "gemm", "sm90", "sm80", "cutlass", "cudnn", "xmma", "implicit")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def rate(step, batch, images, steps):
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch)
    torch.cuda.synchronize()
    return images * steps / (time.perf_counter() - t0)


def profile_step(step, batch):
    """One step under torch.profiler: wall, device time by class, NCCL launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class = {cls: 0.0 for cls, _ in CLASSES}
    by_class["other"] = 0.0
    launches = {cls: 0 for cls in by_class}
    busy_streams, kernels = {}, {}
    for evt in prof.events():
        # device work only: record_function ranges (DistributedDataParallel.forward,
        # nccl:all_reduce, ...) appear on the device timeline too and span many kernels
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or evt.name.startswith(RANGES)):
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        cls = kernel_class(evt.name)
        by_class[cls] += ms
        launches[cls] += 1
        stream = getattr(evt, "device_resource_id", 0)
        busy_streams[stream] = busy_streams.get(stream, 0.0) + ms
        ms_n = kernels.get(evt.name, (0.0, 0))
        kernels[evt.name] = (ms_n[0] + ms, ms_n[1] + 1)
    compute = max(busy_streams.values(), default=0.0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {"wall_ms": wall * 1e3, "device_ms_by_class": by_class, "launches_by_class": launches,
            "busiest_stream_ms": compute, "busiest_stream_share_of_wall": compute / (wall * 1e3),
            "top_kernels": [[name[:100], ms, n] for name, (ms, n) in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--backend", default=None,
                    help="nccl (default) or gloo (to try the script with two ranks on one card)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ddp_profile.json")
    args = ap.parse_args(argv)

    from smilify_tpu_torch._device import card_line
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.models.backbones import FlaxBatchNorm2d, sync_batchnorm
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.train.multihost import maybe_initialize_multihost, rank_device
    from smilify_tpu_torch.train.trainer import data_mesh, shard_batch

    maybe_initialize_multihost(True, device="cuda", backend=args.backend)
    dev = rank_device("cuda", args.backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    spec, _ = load_spec(device=dev)
    mesh = data_mesh(dev)
    out = {"world": world, "backend": dist.get_backend(), "global_batch": GLOBAL_B,
           "steps": args.steps}

    fused = FlaxBatchNorm2d._global_batch_forward_fused
    for variant in ("fused", "plain", "local"):
        FlaxBatchNorm2d._global_batch_forward_fused = (
            FlaxBatchNorm2d._global_batch_forward if variant == "plain" else fused)
        _, model, step, make_batch = bench_all.singleview_train_setup(spec, mesh=mesh)
        if variant == "local":
            sync_batchnorm(model, None)
        local = shard_batch(mesh, make_batch(GLOBAL_B, np.random.RandomState(3)))
        rec = {"images_per_s": rate(step, local, GLOBAL_B, args.steps)}
        if rank == 0:
            rec.update(profile_step(step, local))
        else:
            step(local)
        out[variant] = rec
        del model, step, local
        torch.cuda.empty_cache()
        dist.barrier()
    FlaxBatchNorm2d._global_batch_forward_fused = fused

    if rank == 0:
        for b in (GLOBAL_B, GLOBAL_B // world):
            _, model, step, make_batch = bench_all.singleview_train_setup(spec)
            batch = make_batch(b, np.random.RandomState(3))
            rec = {"images_per_s": rate(step, batch, b, args.steps)}
            rec.update(profile_step(step, batch))
            out[f"undistributed_b{b}"] = rec
            del model, step, batch
            torch.cuda.empty_cache()
        print(card_line(), flush=True)
        line = json.dumps(out)
        print(line, flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
