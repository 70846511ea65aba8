"""Learning proofs of the regressors: they must LEARN, not merely run.

    python -m smilify_tpu_torch.tools.prove_learning --mode {sv,mv} --run {memorize,heldout} \\
        [--until EPOCH] [--epochs N] [--samples N] [--backbone NAME] [--res R] \\
        [--workdir DIR] [--device cuda]

The counterpart of the JAX package's ``tools/prove_learning.py`` (``memorize``)
and ``tools/train_generalization.py`` (``heldout``), with their settings and
gates. The data: ``data/synthetic.py::synthesize_multiview`` samples of
``toy_model_spec(55, 55, 5)`` (SMILy_STICK's width; the model pickle is not in
the repository), written as a model pickle that the trainer loads. The
samples are held in memory in the multi-view HDF5 schema, JPEG images
included (``data/hdf5_dataset.py::multiview_store``), trained
from ``train/trainer.py::DeviceDataCache`` by the trainer CLIs
(``cli/train_regressor.py``, ``cli/train_multiview.py``) and scored by
``cli/benchmark_model.py`` (``train/benchmark.py``'s PCK at input
resolution, MPJPE for mv).

* ``memorize``: 12 samples of 2 views at 64², ``unet_small``, IEF depth 2,
  2 heads, 3 iterations, dropout 0, the proof's loss weights and lr schedule,
  600 epochs, B=8 (sv) or B=4 and 2 views (mv), split 0.99/0/0.01. Gates on
  the training rows: the loss falls ≥ 20× (first epoch over the least of the
  last three), PCK@5 ≥ 0.7, PCK@10 ≥ 0.9.
* ``heldout``: ``unet_mid`` at 96², the sizes of the JAX package's committed
  generalization reports (``benchmarks/gen_r5/``): 25,600 single-view
  samples (sv) or 1,600 samples of 4 views (mv), the generalization run's
  curriculum and schedule, 100 epochs, B=32 (sv) or 8 (mv), split
  0.85/0.05/0.10 with seed 1234. Gate: PCK@10 ≥ 0.9 on the held-out test
  rows only (MPJPE reported for mv).

A run may take several calls: ``--until EPOCH`` trains from where the run
directory's last call stopped (the trainer's ``--resume`` of its
``epoch_N`` checkpoint) up to ``EPOCH``, saves and exits without scoring.
``EPOCH`` must be one of the schedule's change epochs (or the total): the
trainers build a fresh optimizer at each of them, so a run cut only there
takes the optimizer trajectory of an unbroken one (only the shuffle order
differs: the trainer's host generator restarts from ``training.seed``).
The schedule and the checkpoint cadence always come from the total
``--epochs``. Each call regenerates the samples from their seed; the first
records a SHA-256 of the store (``chunks.json`` in the run directory, with
each call's epochs, seconds and card and the full per-epoch history, which
the checkpoints keep only the last 50 entries of) and later calls refuse a
store with another digest. The call that reaches the total scores.

``--backbone``, ``--res``, ``--samples`` and ``--epochs`` shrink a run (the
CPU tests run it with ``unet_micro`` at 32²). Writes ``learning_{mode}_{run}.json``
into ``--workdir`` and prints it; exits non-zero when a gate is missed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np

STICK_WIDTH = (55, 55, 5)
SPLIT_SEED = 1234                      # training.seed's default: the trainer splits with it
RECORD = "chunks.json"                 # the run directory's record of its calls
PCK_CURVE = (1, 2, 5, 10, 20, 50)      # the thresholds (px) the JAX reports print
# the JAX proofs' loss weights: strong direct parameter supervision
WEIGHTS = ('loss_curriculum.base_weights={"global_rot":1.0,"joint_rot":2.0,'
           '"betas":0.3,"trans":0.3,"fov":0.1,"cam_rot":2.0,"cam_trans":2.0,'
           '"log_beta_scales":0.1,"betas_trans":0.1,"keypoint_2d":0.05,'
           '"keypoint_3d":0.0,"silhouette":0.0,"joint_angle_regularization":0.0,'
           '"limb_scale_regularization":0.0,"limb_trans_regularization":0.0}')
# per run: samples, views, batch (sv, mv), resolution, data seed (sv, mv),
# epochs, backbone, split ratios and the gates (loss ratio, PCK@5, PCK@10)
RUNS = {
    "memorize": dict(samples={"sv": 12, "mv": 12}, views={"sv": 2, "mv": 2},
                     batch={"sv": 8, "mv": 4}, res=64, seed={"sv": 7, "mv": 7}, epochs=600,
                     backbone="unet_small", ratios=(0.99, 0.0, 0.01), split="train",
                     gates={"loss_ratio": 20.0, "pck@5px": 0.7, "pck@10px": 0.9}),
    "heldout": dict(samples={"sv": 25600, "mv": 1600}, views={"sv": 1, "mv": 4},
                    batch={"sv": 32, "mv": 8}, res=96, seed={"sv": 11, "mv": 13}, epochs=100,
                    backbone="unet_mid", ratios=(0.85, 0.05, 0.10), split="test",
                    gates={"pck@10px": 0.9}),
}


def schedule(run: str, epochs: int):
    """``(lr_schedule, curriculum_stages)`` of a run of ``epochs`` epochs:
    {epoch: lr} and {epoch: loss-weight overrides}, the JAX proof's fixed
    epochs (memorize) or the generalization run's fractions (heldout)."""
    if run == "memorize":
        return {150: 0.0003, 300: 0.0001, 450: 0.00004}, {}
    lr = {}
    for frac, rate in ((0.5, 0.0003), (0.77, 0.0001), (0.93, 0.00004)):
        lr[int(epochs * frac)] = rate           # a later change at the same epoch wins
    return lr, {int(epochs * 0.25): {"keypoint_2d": 0.3}, int(epochs * 0.6): {"keypoint_2d": 1.0}}


def chunk_ends(run: str, epochs: int):
    """The epochs a call may train up to: the schedule's change epochs
    within the run, and its total."""
    lr, stages = schedule(run, epochs)
    return sorted({e for e in (*lr, *stages) if 0 < e < epochs} | {epochs})


def _json(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


def overrides(mode: str, run: str, epochs: int, backbone: str, res: int, lr: float = 1e-3):
    """The trainer's ``--set`` list for a run of ``epochs`` epochs in total:
    the JAX proof's (memorize) or the generalization run's (heldout)
    settings, the samples in DeviceDataCache."""
    ratios = RUNS[run]["ratios"]
    lr_schedule, stages = schedule(run, epochs)
    ov = [WEIGHTS, f"model.backbone_name={backbone}", f"model.input_resolution={res}",
          "model.freeze_backbone=false", "model.transformer_ief_iters=3",
          "model.transformer_dropout=0.0", f"optimizer.learning_rate={lr}",
          f"optimizer.lr_schedule={_json(lr_schedule)}",
          "training.num_workers=0", "training.device_data_cache=true",
          f"training.batch_size={RUNS[run]['batch'][mode]}",
          "dataset.dataset_fraction=1.0", f"dataset.train_ratio={ratios[0]}",
          f"dataset.val_ratio={ratios[1]}", f"dataset.test_ratio={ratios[2]}",
          "augmentation.enabled=false", f"output.save_checkpoint_every={epochs}",
          "output.generate_visualizations_every=1000000",
          "output.plot_history_every=1000000"]
    if stages:
        ov.append(f"loss_curriculum.curriculum_stages={_json(stages)}")
    depth, heads, cross = (2, 2, 1) if run == "memorize" else (3, 4, 2)
    ov += [f"model.transformer_depth={depth}", f"model.transformer_heads={heads}"]
    if mode == "mv":
        ov += [f"multiview.num_views_to_use={RUNS[run]['views'][mode]}",
               f"multiview.cross_attention_heads={heads}",
               f"multiview.cross_attention_layers={cross}",
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


def store_digest(store) -> str:
    """SHA-256 over a ``MultiViewStore``: each array by name, dtype, shape
    and bytes (the JPEG columns buffer by buffer), then the metadata."""
    h = hashlib.sha256()
    for key in sorted(store.arrays):
        a = store.arrays[key]
        h.update(f"{key}|{a.dtype}|{a.shape}|".encode())
        if a.dtype == object:
            for buf in a:
                b = np.ascontiguousarray(buf).tobytes()
                h.update(len(b).to_bytes(8, "little") + b)
        else:
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps(store.attrs, sort_keys=True, default=str).encode())
    return h.hexdigest()


def carry_run(out_dir: str, until: int, dest: str) -> None:
    """Copy what the call after epoch ``until`` needs into ``dest``, a run
    directory to resume on another machine: the record and the checkpoint
    ``epoch_{until - 1}``, its model and statistics without the optimizer's
    moments, which no resume reads (each call starts a fresh optimizer)."""
    import shutil

    import torch

    from smilify_tpu_torch.train.trainer import load_checkpoint

    os.makedirs(dest, exist_ok=True)
    name = f"epoch_{until - 1}"
    payload, _ = load_checkpoint(os.path.join(out_dir, name))
    torch.save({"model": payload["model"], "opt_state": None}, os.path.join(dest, name + ".pt"))
    for f in (name + ".meta.json", RECORD):
        shutil.copy(os.path.join(out_dir, f), os.path.join(dest, f))


def _card(dev) -> str | None:
    from smilify_tpu_torch._device import card_line

    return card_line() if dev.type == "cuda" else None


def run(mode: str, run: str, workdir: str, epochs=None, samples=None, backbone=None, res=None,
        device="cuda", store=None, until=None, carry=None):
    """Train one proof up to ``until`` (default: its total epochs) from
    where the run directory's last call stopped; returns its result dict.
    Below the total: the partial record (``partial``: true), unscored, and
    with ``carry`` a copy of what the next call needs under
    ``carry/{run}_{mode}`` (:func:`carry_run`). At the total: scored,
    ``ok`` when every gate is met. ``store`` replaces the generated samples
    (the tests plant errors in one)."""
    from smilify_tpu_torch._device import resolve_device
    from smilify_tpu_torch.cli import benchmark_model, train_multiview, train_regressor
    from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
    from smilify_tpu_torch.render.rasterizer import exact_fwd
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.train.trainer import split_dataset

    cfg = RUNS[run]
    epochs = epochs or cfg["epochs"]
    until = until or epochs
    ends = chunk_ends(run, epochs)
    if until not in ends:
        raise ValueError(f"--until {until} is not one of {ends}: a run of {epochs} epochs may "
                         f"stop only where its lr or loss weights change (or at its end), the "
                         f"only boundaries that keep the optimizer trajectory of an unbroken run")
    dev = resolve_device(device)
    n = samples or cfg["samples"][mode]
    res = res or cfg["res"]
    backbone = backbone or cfg["backbone"]
    bs, ratios = cfg["batch"][mode], cfg["ratios"]
    settings = {"mode": mode, "run": run, "epochs": epochs, "n_samples": n,
                "views": cfg["views"][mode], "resolution": res, "backbone": backbone,
                "batch_size": bs, "data_seed": cfg["seed"][mode], "split_ratios": list(ratios),
                "split_seed": SPLIT_SEED}
    out_dir = os.path.join(workdir, f"{run}_{mode}")
    record_path = os.path.join(out_dir, RECORD)
    record = None
    if os.path.exists(record_path):
        with open(record_path) as f:
            record = json.load(f)
        if record["settings"] != settings:
            raise ValueError(f"refusing to resume {out_dir}: it was started with "
                             f"{record['settings']}, this call asks for {settings}")
    done = record["chunks"][-1]["until"] if record and record["chunks"] else 0
    if done > until or (done == until < epochs):
        raise ValueError(f"{out_dir} is already trained to epoch {done}; --until {until} "
                         f"asks for no further epochs (the ends: {ends})")

    os.makedirs(out_dir, exist_ok=True)
    pkl = write_model_pkl(os.path.join(workdir, "stick_width.pkl"),
                          toy_model_spec(*STICK_WIDTH, device="cpu"))
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)
    t0 = time.perf_counter()
    k1 = exact_fwd.launches
    if store is None:
        store = make_store(spec, n, cfg["views"][mode], res, cfg["seed"][mode], dev)
    k1 = exact_fwd.launches - k1
    digest = store_digest(store)
    data_s = time.perf_counter() - t0
    if record is None:
        record = {"settings": settings, "store_sha256": digest, "chunks": [], "history": []}
    elif record["store_sha256"] != digest:
        raise ValueError(f"refusing to resume {out_dir}: the regenerated store's SHA-256 "
                         f"{digest} differs from its first call's {record['store_sha256']}")
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)

    card = _card(dev)
    if done < until:
        train = train_regressor.main if mode == "sv" else train_multiview.main
        argv = ["--model", pkl, "--epochs", str(until), "--output-dir", out_dir,
                "--device", str(dev), "--set", *overrides(mode, run, epochs, backbone, res)]
        if done:
            argv += ["--resume", f"epoch_{done - 1}"]
        t0 = time.perf_counter()
        state = train(argv, source=store)
        train_s = time.perf_counter() - t0
        # the resumed history holds only a checkpoint's last 50 epochs: keep them all here
        record["history"] += [h for h in state.history if h["epoch"] >= done]
        epochs_seen = [h["epoch"] for h in record["history"]]
        if epochs_seen != list(range(until)):
            raise RuntimeError(f"{out_dir}: the history's epochs {epochs_seen} are not 0..{until - 1}")
        record["chunks"].append({"from": done, "until": until, "steps": state.step,
                                 "data_seconds": data_s, "train_seconds": train_s,
                                 "k1_launches": k1, "card": card})
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)
    if until < epochs:
        if carry:
            carry_run(out_dir, until, os.path.join(carry, f"{run}_{mode}"))
        partial = {**settings, "partial": True, "until": until, "ends": ends,
                   "store_sha256": digest, "chunks": record["chunks"],
                   "loss_last": record["history"][-1]["loss"],
                   "val_loss_last": record["history"][-1].get("val_loss"), "device": str(dev)}
        print(json.dumps(partial), flush=True)
        return partial

    t0 = time.perf_counter()
    acc = benchmark_model.main([
        "--checkpoint", os.path.join(out_dir, "final_model"), "--device", str(dev),
        "--output-dir", os.path.join(out_dir, "benchmark"), "--split", cfg["split"],
        "--split-ratios", ",".join(str(r) for r in ratios), "--split-seed", str(SPLIT_SEED)],
        source=store)
    score_s = time.perf_counter() - t0
    curve = acc.pck_curve("input")
    history = record["history"]
    losses = [h["loss"] for h in history]
    split_rows = split_dataset(n, ratios, SPLIT_SEED)
    rows = split_rows[("train", "val", "test").index(cfg["split"])]
    errs = np.concatenate([np.ravel(e) for e in acc.pixel_errors_input])
    steps_per_epoch = len(split_rows[0]) // bs
    result = {
        **settings, "scored_split": cfg["split"],
        "scored_samples": sorted(int(i) for i in rows), "scored_keypoints": int(errs.size),
        "loss_first": losses[0], "loss_last": losses[-1],
        "val_loss_last": history[-1].get("val_loss"),
        # the memorize gate: the first epoch over the least of the last three
        "loss_ratio": losses[0] / max(min(losses[-3:]), 1e-12),
        "pck@5px": curve.get(5, 0.0), "pck@10px": curve.get(10, 0.0),
        "pck_curve": {f"{t}px": curve[t] for t in PCK_CURVE if t in curve},
        "mean_pixel_error": float(errs.mean()) if errs.size else None,
        # every epoch of every call: the trainer's own count restarts at each resume
        "steps": len(history) * steps_per_epoch, "steps_per_epoch": steps_per_epoch,
        "store_sha256": digest, "chunks": record["chunks"],
        "train_seconds": sum(c["train_seconds"] for c in record["chunks"]),
        "wall_seconds": sum(c["data_seconds"] + c["train_seconds"] for c in record["chunks"])
        + score_s, "score_seconds": score_s, "device": str(dev), "card": card,
        "history": history,
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
    ap.add_argument("--until", type=int, default=None,
                    help="train up to this epoch (a change epoch of the schedule) and exit "
                         "unscored; the next call resumes there")
    ap.add_argument("--carry", default=None,
                    help="after a call that stops before the end, copy the record and the "
                         "resume checkpoint (no optimizer moments) into this workdir")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--workdir", default="runs/prove_learning")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        r = run(args.mode, args.run, args.workdir, args.epochs, args.samples, args.backbone,
                args.res, args.device, until=args.until, carry=args.carry)
    except ValueError as e:
        raise SystemExit(f"prove_learning: {e}")
    if r.get("partial"):
        print(f"LEARNING-CHUNK-OK: epoch {r['until']} of {r['epochs']}")
        return
    if not r["ok"]:
        raise SystemExit(f"LEARNING PROOF FAILED: {r}")
    print("LEARNING-OK")


if __name__ == "__main__":
    main()
