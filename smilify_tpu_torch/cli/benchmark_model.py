"""Model benchmark CLI (port of ``smilify_tpu/cli/benchmark_model.py``).

Detects single/multi-view from the checkpoint's config, evaluates PCK@1..50px
at input resolution and MPJPE (mm) where the data has 3D ground truth, and
writes benchmark_report.txt, the raw .npy error arrays, the PCK curve and
the error histogram (``utils/plotting.py``). ``--split`` evaluates one side of
the trainer's seeded split (the same split functions, seed and ratios give
the same held-out indices). A single-view model on a multi-view store reads
every view as an item.

    python -m smilify_tpu_torch.cli.benchmark_model --checkpoint RUN \\
        --dataset-path DATA [--split test] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device, set_float32_matmul


def main(argv=None, source=None):
    """The CLI; a caller holding its samples in memory passes them as
    ``source`` (a ``data.hdf5_dataset.MultiViewStore``) instead of
    ``--dataset-path``."""
    ap = argparse.ArgumentParser(description="Benchmark a trained SMIL regressor")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset-path", required=source is None)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--split", choices=["all", "train", "val", "test"], default="all",
                    help="evaluate only one side of the trainer's seeded split")
    ap.add_argument("--split-ratios", default="0.8,0.1,0.1",
                    help="train,val,test ratios used at training time")
    ap.add_argument("--split-seed", type=int, default=1234,
                    help="training.seed used at training time")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from smilify_tpu_torch.data.combined import open_dataset
    from smilify_tpu_torch.models.predict import input_names
    from smilify_tpu_torch.models.multiview import project_through_view_cameras
    from smilify_tpu_torch.models.regressor import float32_region, forward_model, project_to_camera
    from smilify_tpu_torch.serve import load_model_from_checkpoint, predictor
    from smilify_tpu_torch.train.benchmark import BenchmarkAccumulator
    from smilify_tpu_torch.train.trainer import (
        StagingCollator,
        SubsetDataset,
        split_dataset,
        split_dataset_grouped,
    )

    dev = resolve_device(args.device)
    set_float32_matmul(dev)
    model, cfg, rcfg, spec, meta = load_model_from_checkpoint(args.checkpoint, dev)
    out_dir = args.output_dir or os.path.join(os.path.dirname(args.checkpoint) or ".", "benchmark")
    res = cfg.model.input_resolution or 224
    is_mv = cfg.mode == "multi_view"

    path = args.dataset_path if source is None else source
    dataset = open_dataset(path, joint_names=spec.joint_names,
                           image_size=res if source is None and not path.endswith(".h5") else None)
    if not is_mv and "images" in dataset[0]:
        from smilify_tpu_torch.data.hdf5_dataset import MultiViewHDF5Dataset

        dataset = MultiViewHDF5Dataset(path, return_single_view=True, expand_all_views=True)
    if args.split != "all":
        ratios = tuple(float(x) for x in args.split_ratios.split(","))
        if getattr(dataset, "item_sample_indices", None) is not None:
            tr, va, te = split_dataset_grouped(dataset.item_sample_indices, ratios, args.split_seed)
        else:
            tr, va, te = split_dataset(len(dataset), ratios, args.split_seed)
        dataset = SubsetDataset(dataset, {"train": tr, "val": va, "test": te}[args.split])
        print(f"split={args.split}: {len(dataset)} samples (ratios {ratios}, seed {args.split_seed})")
    n = len(dataset) if args.max_samples is None else min(len(dataset), args.max_samples)
    print(f"benchmarking {n} samples ({'multi' if is_mv else 'single'}-view) on {dev}")

    predict = predictor(model, rcfg, spec, is_mv)

    @torch.no_grad()
    def keypoints(batch):
        preds = predict(batch)
        with float32_region(dev):
            # the training-time world convention (replicAnt ×10 about the root)
            _, joints3d = forward_model(spec, preds, use_ue_scaling=rcfg.use_ue_scaling)
            if is_mv:
                kp2d = project_through_view_cameras(preds, joints3d, (res, res))
            else:
                kp2d = project_to_camera(preds, joints3d, (res, res))
        return kp2d.cpu().numpy(), joints3d.cpu().numpy()

    acc = BenchmarkAccumulator()
    staging = StagingCollator()
    dev_keys = input_names(is_mv)
    for i in range(0, n, args.batch_size):
        samples = [dataset[j] for j in range(i, min(n, i + args.batch_size))]
        batch = staging.to_device(staging([{k: s[k] for k in dev_keys} for s in samples]), dev)
        kp_pred, j3d_pred = keypoints(batch)
        if is_mv:
            # stored pixel (x, y) → normalized (y, x)
            gt2d = np.stack([s["keypoints_2d"] for s in samples])[..., ::-1] / res
            vis = np.stack([s["keypoint_visibility"] for s in samples])
            vis = vis * np.stack([s["view_mask"] for s in samples])[..., None]
            acc.add_2d(kp_pred, gt2d, vis, res)
            has3d = np.array([s.get("has_3d_data", False) for s in samples])
            if has3d.any():
                gt3d = np.stack([s["keypoints_3d"] for s in samples])
                acc.add_3d(j3d_pred[has3d], gt3d[has3d])
        else:
            gt2d = np.stack([s["keypoints_2d"] for s in samples])
            vis = np.stack([s["keypoint_visibility"] for s in samples])
            acc.add_2d(kp_pred, gt2d, vis, res)
            if all("keypoints_3d" in s for s in samples):
                acc.add_3d(j3d_pred, np.stack([s["keypoints_3d"] for s in samples]))

    report = acc.write_report(out_dir, title=f"benchmark: {args.checkpoint}")
    print(report)
    print(f"→ {out_dir}")
    return acc


if __name__ == "__main__":
    main()
