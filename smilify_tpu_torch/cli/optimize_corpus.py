"""Corpus fitting CLI — batched optimization over many independent clips
(port of ``smilify_tpu/cli/optimize_corpus.py``).

Stacks S clips on a leading sequence axis and runs the staged schedule with
one optimizer (:class:`~smilify_tpu_torch.fitter.fitter_batch.BatchedFitter`):
the S·N frames go to the raster kernels in one launch a step, and the result
is S independent fits.

Usage:
  python -m smilify_tpu_torch.cli.optimize_corpus \\
      --model 3D_model_prep/SMILy_STICK.pkl \\
      --data-root data/replicAnt_trials/SMIL_COCO \\
      --sequences replicAnt:SMIL_00_synth.jpg replicAnt:SMIL_01_synth.jpg \\
      [--all-replicant] [--crop-size 256 --use-crop] [--test] [--device cuda]

Every clip must load to the same (frames, H, W) shape — use ``--use-crop`` to
square-crop to ``--crop-size`` and ``--max-frames`` to truncate video
sequences to a common length.

Over several ranks (launch under torchrun, one rank a card): ``--shard``
cuts the clips over every rank (:class:`~smilify_tpu_torch.fitter.fitter_batch.ShardedBatchedFitter`),
``--shard-grid CxF`` clips and frames over a C×F mesh of the C·F ranks
(:class:`~smilify_tpu_torch.fitter.fitter_batch.GridShardedFitter`). The
corpus is padded by repeating clips to a multiple of the clip ranks, the
padding dropped from the exports; rank 0 writes. ``--multihost`` starts the
process group from the flag (torchrun's environment starts it anyway).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from smilify_tpu_torch.cli.optimize_to_joints import (
    frame_collage,
    frame_params,
    gathered_params,
    load_priors,
    load_sequence,
    resolve_approx_max_faces,
    setup_device,
)


def _load_clip(seq: str, args, spec):
    dataset, name = seq.split(":")
    arrays, filenames = load_sequence(dataset, name, args, spec)
    rgb, sil, joints, vis = arrays
    if args.max_frames and rgb.shape[0] > args.max_frames:
        rgb, sil, joints, vis = (a[: args.max_frames] for a in (rgb, sil, joints, vis))
        filenames = filenames[: args.max_frames]
    return (rgb, sil, joints, vis), filenames, os.path.splitext(os.path.basename(name))[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="batched SMIL corpus fitter")
    ap.add_argument("--model", required=True, help="model .pkl file")
    ap.add_argument("--sequences", nargs="+", default=None,
                    help="dataset:name entries (all must share frame count and size)")
    ap.add_argument("--all-replicant", action="store_true",
                    help="fit every image in <data-root>/labels.json as a 1-frame clip")
    ap.add_argument("--data-root", default="data/replicAnt_trials/SMIL_COCO")
    ap.add_argument("--crop-size", type=int, default=512)
    ap.add_argument("--use-crop", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="truncate every clip to N frames (videos of unequal length)")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--vis-frequency", type=int, default=50)
    ap.add_argument("--test", action="store_true", help="10-iteration test schedule")
    ap.add_argument("--test-stages", type=int, default=None)
    ap.add_argument("--limb-scaling", action=argparse.BooleanOptionalAction, default=True,
                    help="optimize per-joint limb scales (--no-limb-scaling freezes them)")
    ap.add_argument("--unity-prior", default=None, metavar="NPZ")
    ap.add_argument("--walking-prior", default=None, metavar="PKL")
    ap.add_argument("--approx-max-faces", default="auto",
                    help="work-list raster per-tile z-nearest face cap: 'auto' (default) = "
                         "the IoU-gated resolution-scaled cap on the card, exact on the "
                         "CPU; an integer pins; --exact opts out")
    ap.add_argument("--exact", action="store_true",
                    help="exact all-faces SoftRas (disable the auto work-list cap)")
    ap.add_argument("--iter-chunk", type=int, default=10,
                    help="optimization steps run back to back between loss read-backs "
                         "(1 = every step)")
    ap.add_argument("--shard", action="store_true",
                    help="cut the clips over the ranks of the process group (launch under "
                         "torchrun; the corpus is padded by repeating clips to a multiple of "
                         "the rank count, the padding dropped from the exports)")
    ap.add_argument("--shard-grid", default=None, metavar="CxF",
                    help="a 2-D ('clips', 'frames') mesh of the C·F ranks, e.g. 2x2: clips "
                         "AND frames cut at once (long-clip corpora); the frame count must "
                         "divide by F")
    ap.add_argument("--multihost", action="store_true",
                    help="start the process group (torchrun's or SLURM's environment starts "
                         "it anyway); exports are written by rank 0")
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = setup_device(args)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.fitter.fitter import FitData
    from smilify_tpu_torch.fitter.fitter_batch import (
        BatchedFitter,
        GridShardedFitter,
        ShardedBatchedFitter,
        posed_clips,
        sequence_params,
    )
    from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS, test_schedule
    from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces
    from smilify_tpu_torch.train.multihost import is_primary, make_mesh, process_count
    from smilify_tpu_torch.utils.export import ImageExporter

    spec = load_model_spec(args.model, align_symmetry=False, device=dev)
    out_dir = args.output_dir or os.path.join("checkpoints", time.strftime("%Y%m%d-%H%M%S"))

    sequences = list(args.sequences or [])
    if args.all_replicant:
        with open(os.path.join(args.data_root, "labels.json")) as f:
            meta = json.load(f)
        sequences += [f"replicAnt:{e['file_name']}" for e in meta["images"]]
    if len(sequences) < 1:
        raise SystemExit("no sequences: pass --sequences and/or --all-replicant")

    clips, clip_names, clip_filenames = [], [], []
    for seq in sequences:
        arrays, filenames, clip_name = _load_clip(seq, args, spec)
        clips.append(arrays)
        clip_names.append(clip_name)
        clip_filenames.append(filenames)

    shapes = {c[1].shape for c in clips}
    if len(shapes) != 1:
        detail = ", ".join(f"{n}: {c[1].shape}" for n, c in zip(clip_names, clips))
        raise SystemExit(
            f"clips disagree on (frames, H, W) — {detail}; use --use-crop/"
            f"--crop-size and --max-frames to make them uniform"
        )

    n_real = len(clips)
    grid = None
    if args.shard_grid:
        grid = tuple(int(v) for v in args.shard_grid.lower().split("x"))
        if grid[0] * grid[1] != process_count():
            raise SystemExit(f"--shard-grid {args.shard_grid} needs {grid[0] * grid[1]} ranks, "
                             f"the process group has {process_count()}")
    if args.shard or grid:
        pad_to = grid[0] if grid else process_count()
        while len(clips) % pad_to:  # pad by cycling; padded fits are discarded
            i = len(clips) % n_real
            clips.append(clips[i])
            clip_names.append(f"_pad_{clip_names[i]}")
            clip_filenames.append(clip_filenames[i])
    S = len(clips)
    N, H, W = clips[0][1].shape
    print(f"Corpus: {S} clips x {N} frames  image {H}x{W}  model J={spec.n_joints}")

    rgb, sil, joints, vis = (np.stack([c[k] for c in clips]) for k in range(4))
    data = FitData(rgb=rgb, sil=torch.from_numpy(sil), joints=torch.from_numpy(joints),
                   visibility=torch.from_numpy(vis))
    pose_prior, shape_prior = load_priors(args, spec, dev)

    approx = resolve_approx_max_faces(args, (H, W),
                                      lambda size: auto_approx_max_faces(size, device=dev))
    kwargs = dict(allow_limb_scaling=args.limb_scaling, pose_prior=pose_prior,
                  shape_prior=shape_prior, approx_max_faces=approx, device=dev)
    if grid:
        print(f"sharding {S} clips ({n_real} real) × {N} frames over a {grid[0]}x{grid[1]} mesh")
        fitter = GridShardedFitter(spec, data, (H, W),
                                   mesh=make_mesh(grid, ("clips", "frames"), dev), **kwargs)
    elif args.shard:
        print(f"sharding {S} clips ({n_real} real) over {process_count()} rank(s)")
        fitter = ShardedBatchedFitter(spec, data, (H, W), **kwargs)
    else:
        fitter = BatchedFitter(spec, data, (H, W), **kwargs)

    # one exporter over the flattened corpus: out_dir/<clip>/<frame>/st_ep.*
    # (single-frame clips skip the clip level — the layout of
    # optimize_to_joints: out_dir/<frame>/st_ep.*)
    flat_names = [
        clip_filenames[s][i] if N == 1 else os.path.join(clip_names[s], clip_filenames[s][i])
        for s in range(n_real)
        for i in range(N)
    ]
    exporter = ImageExporter(out_dir, flat_names)
    schedule = test_schedule(max_stages=args.test_stages) if args.test else OPT_WEIGHTS

    def visualize(stage_id, epoch):
        # gathering a sharded fit's parameters is a collective: every rank
        # joins, rank 0 alone renders and writes
        params = gathered_params(fitter)
        if not is_primary():
            return
        verts, joints3d = posed_clips(spec, params, args.limb_scaling)  # (S, N, V, 3), (S, N, J, 3)
        exporter.stage_id = stage_id
        exporter.epoch_name = str(epoch)
        faces = spec.faces.cpu().numpy()
        for s in range(n_real):
            p = sequence_params(params, s)
            for i in range(N):
                collage = frame_collage(spec, fitter.camera, verts[s, i], joints3d[s, i],
                                        p.fov[i], (H, W), rgb[s, i], sil[s, i], joints[s, i],
                                        vis[s, i])
                exporter.export(collage * 255.0, s * N + i, frame_params(p, i),
                                verts[s, i].cpu().numpy(), faces)

    t_start = time.time()

    def cb(stage, it, loss, objs):
        if it % args.vis_frequency == 0:
            print(f"stage {stage} it {it:4d} loss {float(loss):.4f} "
                  + " ".join(f"{k}={float(v):.3f}" for k, v in objs.items() if float(v) != 0))
            visualize(stage, it)

    fitter.fit(schedule, callback=cb, chunk=args.iter_chunk)
    visualize(10, 0)  # final export, reference convention stage_id=10
    elapsed = time.time() - t_start
    total_iters = sum(s.num_iters for s in schedule)
    print(f"done: {S} clips in {elapsed:.1f}s "
          f"({S * N * total_iters / elapsed:.1f} frame-iters/s) → {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
