"""Learning proofs of the regressors: they must LEARN, not merely run.

    python -m smilify_tpu_torch.tools.prove_learning --mode {sv,mv} --run {memorize,heldout} \\
        [--epochs N] [--samples N] [--backbone NAME] [--res R] [--workdir DIR] [--device cuda]

The counterpart of the JAX package's ``tools/prove_learning.py`` (``memorize``)
and ``tools/train_generalization.py`` (``heldout``), with their settings and
gates. The data: ``data/synthetic.py::synthesize_multiview`` samples of
``toy_model_spec(55, 55, 5)`` (SMILy_STICK's width; the model pickle is not in
the repository), written as a model pickle that the trainer loads. The
samples are held in memory in the multi-view HDF5 schema, JPEG images
included (``data/hdf5_dataset.py::multiview_store``: no h5py needed), trained
from ``train/trainer.py::DeviceDataCache`` by the trainer CLIs
(``cli/train_regressor.py``, ``cli/train_multiview.py``) and scored by
``cli/benchmark_model.py`` (``train/benchmark.py``'s PCK at input
resolution, MPJPE for mv).

* ``memorize``: 12 samples of 2 views at 64², ``unet_small``, IEF depth 2,
  2 heads, 3 iterations, dropout 0, the proof's loss weights and lr schedule,
  600 epochs, B=8 (sv) or B=4 and 2 views (mv), split 0.99/0/0.01. Gates on
  the training rows: the loss falls ≥ 20× (first epoch over the least of the
  last three), PCK@5 ≥ 0.7, PCK@10 ≥ 0.9.
* ``heldout``: ``unet_mid`` at 96², 1,600 single-view samples (sv) or 700
  samples of 4 views (mv), the generalization run's curriculum and schedule,
  300 epochs, B=32 (sv) or 8 (mv), split 0.85/0.05/0.10 with seed 1234.
  Gate: PCK@10 ≥ 0.9 on the held-out test rows only (MPJPE reported for mv).

``--backbone``, ``--res``, ``--samples`` and ``--epochs`` shrink a run (the
CPU tests run it with ``unet_micro`` at 32²). Writes ``learning_{mode}_{run}.json``
into ``--workdir`` and prints it; exits non-zero when a gate is missed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

STICK_WIDTH = (55, 55, 5)
SPLIT_SEED = 1234                      # training.seed's default: the trainer splits with it
# the JAX proofs' loss weights: strong direct parameter supervision
WEIGHTS = ('loss_curriculum.base_weights={"global_rot":1.0,"joint_rot":2.0,'
           '"betas":0.3,"trans":0.3,"fov":0.1,"cam_rot":2.0,"cam_trans":2.0,'
           '"log_beta_scales":0.1,"betas_trans":0.1,"keypoint_2d":0.05,'
           '"keypoint_3d":0.0,"silhouette":0.0,"joint_angle_regularization":0.0,'
           '"limb_scale_regularization":0.0,"limb_trans_regularization":0.0}')
# per run: samples, views (sv, mv), resolution, data seed (sv, mv), epochs,
# backbone, split ratios and the gates (loss ratio, PCK@5, PCK@10)
RUNS = {
    "memorize": dict(samples={"sv": 12, "mv": 12}, views={"sv": 2, "mv": 2}, res=64,
                     seed={"sv": 7, "mv": 7}, epochs=600, backbone="unet_small",
                     ratios=(0.99, 0.0, 0.01), split="train",
                     gates={"loss_ratio": 20.0, "pck@5px": 0.7, "pck@10px": 0.9}),
    "heldout": dict(samples={"sv": 1600, "mv": 700}, views={"sv": 1, "mv": 4}, res=96,
                    seed={"sv": 11, "mv": 13}, epochs=300, backbone="unet_mid",
                    ratios=(0.85, 0.05, 0.10), split="test", gates={"pck@10px": 0.9}),
}


def overrides(mode: str, run: str, epochs: int, backbone: str, res: int, lr: float = 1e-3):
    """The trainer's ``--set`` list: the JAX proof's (memorize) or the
    generalization run's (heldout) settings, the samples in DeviceDataCache."""
    ratios = RUNS[run]["ratios"]
    common = [WEIGHTS, f"model.backbone_name={backbone}", f"model.input_resolution={res}",
              "model.freeze_backbone=false", "model.transformer_ief_iters=3",
              "model.transformer_dropout=0.0", f"optimizer.learning_rate={lr}",
              "training.num_workers=0", "training.device_data_cache=true",
              "dataset.dataset_fraction=1.0", f"dataset.train_ratio={ratios[0]}",
              f"dataset.val_ratio={ratios[1]}", f"dataset.test_ratio={ratios[2]}",
              "augmentation.enabled=false", f"output.save_checkpoint_every={epochs}",
              "output.generate_visualizations_every=1000000",
              "output.plot_history_every=1000000"]
    if run == "memorize":
        ov = common + ["model.transformer_depth=2", "model.transformer_heads=2",
                       'optimizer.lr_schedule={"150":0.0003,"300":0.0001,"450":0.00004}',
                       "training.batch_size=8"]
        if mode == "mv":
            ov += ["training.batch_size=4", "multiview.num_views_to_use=2",
                   "multiview.cross_attention_heads=2", "multiview.cross_attention_layers=1",
                   "training.use_gt_camera_init=false"]
        return ov
    ov = common + [
        f'loss_curriculum.curriculum_stages={{"{int(epochs * 0.25)}":{{"keypoint_2d":0.3}},'
        f'"{int(epochs * 0.6)}":{{"keypoint_2d":1.0}}}}',
        "model.transformer_depth=3", "model.transformer_heads=4",
        f'optimizer.lr_schedule={{"{int(epochs * 0.5)}":0.0003,'
        f'"{int(epochs * 0.77)}":0.0001,"{int(epochs * 0.93)}":0.00004}}',
        "training.batch_size=32"]
    if mode == "mv":
        ov += ["training.batch_size=8", "multiview.num_views_to_use=4",
               "multiview.cross_attention_heads=4", "multiview.cross_attention_layers=2",
               "training.use_gt_camera_init=false"]
    return ov


def make_store(spec, n_samples: int, n_views: int, res: int, seed: int, device):
    """``n_samples`` synthesize_multiview samples in the multi-view schema, in memory."""
    from smilify_tpu_torch.data.hdf5_dataset import multiview_store
    from smilify_tpu_torch.data.synthetic import synthesize_multiview

    samples = synthesize_multiview(spec, n_samples, n_views, res, seed=seed, device=device)
    return multiview_store(samples, max_views=n_views, target_resolution=res,
                           canonical_camera_order=[f"cam_{i}" for i in range(n_views)],
                           n_pose=spec.n_joints - 1, n_betas=spec.n_betas,
                           dataset_type="synthetic_multiview")


def run(mode: str, run: str, workdir: str, epochs=None, samples=None, backbone=None, res=None,
        device="cuda", store=None):
    """Train and score one proof; returns its result dict (``ok``: every gate
    met). ``store`` replaces the generated samples (the tests plant errors in
    one)."""
    from smilify_tpu_torch._device import resolve_device
    from smilify_tpu_torch.cli import benchmark_model, train_multiview, train_regressor
    from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.train.trainer import split_dataset

    cfg = RUNS[run]
    dev = resolve_device(device)
    epochs = epochs or cfg["epochs"]
    n = samples or cfg["samples"][mode]
    res = res or cfg["res"]
    backbone = backbone or cfg["backbone"]
    os.makedirs(workdir, exist_ok=True)
    pkl = write_model_pkl(os.path.join(workdir, "stick_width.pkl"),
                          toy_model_spec(*STICK_WIDTH, device="cpu"))
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)
    t0 = time.perf_counter()
    if store is None:
        store = make_store(spec, n, cfg["views"][mode], res, cfg["seed"][mode], dev)
    data_s = time.perf_counter() - t0

    out_dir = os.path.join(workdir, f"{run}_{mode}")
    train = train_regressor.main if mode == "sv" else train_multiview.main
    t0 = time.perf_counter()
    state = train(["--model", pkl, "--epochs", str(epochs), "--output-dir", out_dir,
                   "--device", str(dev), "--set", *overrides(mode, run, epochs, backbone, res)],
                  source=store)
    train_s = time.perf_counter() - t0

    ratios = cfg["ratios"]
    acc = benchmark_model.main([
        "--checkpoint", os.path.join(out_dir, "final_model"), "--device", str(dev),
        "--output-dir", os.path.join(out_dir, "benchmark"), "--split", cfg["split"],
        "--split-ratios", ",".join(str(r) for r in ratios), "--split-seed", str(SPLIT_SEED)],
        source=store)
    curve = acc.pck_curve("input")
    losses = [h["loss"] for h in state.history]
    first, last = losses[0], min(losses[-3:])
    rows = split_dataset(n, ratios, SPLIT_SEED)[("train", "val", "test").index(cfg["split"])]
    result = {
        "mode": mode, "run": run, "epochs": epochs, "n_samples": n,
        "views": cfg["views"][mode], "resolution": res, "backbone": backbone,
        "split_ratios": list(ratios), "split_seed": SPLIT_SEED, "scored_split": cfg["split"],
        "scored_samples": sorted(int(i) for i in rows),
        "scored_keypoints": int(sum(np.asarray(e).size for e in acc.pixel_errors_input)),
        "loss_first": first, "loss_last": last, "loss_ratio": first / max(last, 1e-12),
        "pck@5px": curve.get(5, 0.0), "pck@10px": curve.get(10, 0.0),
        "data_seconds": data_s, "train_seconds": train_s, "steps": state.step,
        "device": str(dev),
    }
    if mode == "mv":
        result["mpjpe"] = acc.mpjpe_stats()
    result["gates"] = cfg["gates"]
    result["ok"] = all(result[k] >= v for k, v in cfg["gates"].items())
    with open(os.path.join(workdir, f"learning_{mode}_{run}.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="Learning proofs of the regressors")
    ap.add_argument("--mode", choices=["sv", "mv"], default="sv")
    ap.add_argument("--run", choices=sorted(RUNS), default="memorize")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--workdir", default="runs/prove_learning")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = run(args.mode, args.run, args.workdir, args.epochs, args.samples, args.backbone,
            args.res, args.device)
    if not r["ok"]:
        raise SystemExit(f"LEARNING PROOF FAILED: {r}")
    print("LEARNING-OK")


if __name__ == "__main__":
    main()
