"""One-off measurement: how far rounding alone moves the frame fit at
STICK's width (``bench.load_spec``) at 512², on one NVIDIA GPU, beside how
far the frame-sharded fit lands from it.

    python3 scripts/fit_witness.py [--frames 12] [--out build/fit_witness.json]
    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \\
        scripts/fit_witness.py --frames 12 --backend gloo

Alone, it fits ``--frames`` synthetic frames with SmalFitter (the JAX frame
test's two-stage schedule, exact and capped at 800 faces a tile) three
times: twice as they are, once on 2D joints moved by one float32 ulp
(× (1 + 2⁻²³)). Under torch.distributed.run each rank fits the same frames
with SmalFitter and with ShardedSequenceFitter over a ``('frames',)`` mesh of
every rank (``--backend gloo`` lets the ranks share one card). Every fit is
held to the first SmalFitter fit in units of the JAX test's gates (loss
trajectory rtol 1e-3, atol 1e-6; end parameters rtol 3e-3, atol 3e-3,
``tests/test_fitter_frames.py``): a gap of 1 is the gate. Prints the card's
name and power limit, then one JSON line (rank 0), which ``--out`` also gets.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SIZE = (512, 512)
CAP = 800
TRAJ_TOL, PARAM_TOL = (1e-3, 1e-6), (3e-3, 3e-3)     # (rtol, atol)
SCHEDULE = (
    dict(num_iters=3, lr=1e-2, w_j2d=1.0, w_reproj=0.0, w_betas=0.0, w_pose=0.0, w_limit=0.0,
         w_splay=0.0, w_temp=0.0),
    dict(num_iters=4, lr=1e-2, w_j2d=1.0, w_reproj=0.5, w_betas=0.1, w_pose=0.01, w_limit=0.01,
         w_splay=0.01, w_temp=0.5),
)


def fit(fitter):
    """The fit's loss a step and its end parameters (full, on every rank)."""
    from smilify_tpu_torch.fitter.fitter import FitParams
    from smilify_tpu_torch.fitter.stages import StageWeights

    traj = []
    fitter.fit([StageWeights(**w) for w in SCHEDULE], chunk=2,
               callback=lambda s, i, loss, o: traj.append(float(loss)))
    params = fitter.gathered_params() if hasattr(fitter, "gathered_params") else fitter.params
    return np.asarray(traj), {k: getattr(params, k).detach().double().cpu()
                              for k in FitParams.fields()}


def gap(run, ref):
    """``run`` against ``ref`` in units of the gates: trajectory, end
    parameters, and the worst parameter's name."""
    (traj, params), (ref_traj, ref_params) = run, ref
    t = float(np.max(np.abs(traj - ref_traj) / (TRAJ_TOL[1] + TRAJ_TOL[0] * np.abs(ref_traj))))
    worst = {k: float(torch.max(torch.abs(params[k] - ref_params[k])
                                / (PARAM_TOL[1] + PARAM_TOL[0] * torch.abs(ref_params[k]))))
             for k in params}
    return {"traj_of_gate": t, "params_of_gate": max(worst.values()),
            "worst": max(worst, key=worst.get)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--backend", default=None, help="under torch.distributed.run: nccl or gloo")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fit_witness.json")
    args = ap.parse_args(argv)

    import os

    from smilify_tpu_torch._device import card_line
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.fitter.fitter import SmalFitter, synthetic_fit_data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranked = "WORLD_SIZE" in os.environ
    rank, world = 0, 1
    if ranked:
        import torch.distributed as dist

        from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter
        from smilify_tpu_torch.train.multihost import (
            make_mesh,
            maybe_initialize_multihost,
            rank_device,
        )

        maybe_initialize_multihost(True, device="cuda", backend=args.backend)
        dev = rank_device("cuda", args.backend)
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = make_mesh((world,), ("frames",), dev)
    else:
        dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    spec, _ = load_spec(device=dev)
    data = synthetic_fit_data(spec, args.frames, SIZE)
    nudged = data._replace(joints=data.joints * (1 + 2.0 ** -23))
    out = {"frames": args.frames, "ranks": world}
    for mode, cap in (("exact", None), ("capped", CAP)):
        ref = fit(SmalFitter(spec, data, SIZE, approx_max_faces=cap, device=dev))
        if ranked:
            sharded = ShardedSequenceFitter(spec, data, SIZE, mesh=mesh, approx_max_faces=cap,
                                            device=dev)
            out[mode] = {"sharded": gap(fit(sharded), ref)}
        else:
            out[mode] = {
                "again": gap(fit(SmalFitter(spec, data, SIZE, approx_max_faces=cap, device=dev)), ref),
                "one_ulp": gap(fit(SmalFitter(spec, nudged, SIZE, approx_max_faces=cap, device=dev)),
                               ref)}
    if rank == 0:
        print(card_line(), flush=True)
        line = json.dumps(out)
        print(line, flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    if ranked:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
