"""Single-view regressor training CLI (port of
``smilify_tpu/cli/train_regressor.py``).

    python -m smilify_tpu_torch.cli.train_regressor --config cfg.json \
        [--model path.pkl] [--data-path dir_or_h5] [--epochs N] [--set a.b=c ...] \
        [--output-dir runs/singleview] [--resume NAME] [--device cuda]

Trains on one device (``--device``, default ``cuda``; it raises without a
card unless given ``cpu``), or data-parallel over the ranks of a process
group: launched under torchrun (or with ``--multihost``), each rank a card,
the model in ``DistributedDataParallel`` with its BatchNorms on the global
batch, ``training.batch_size`` the global batch (rounded to a multiple of
ranks × accumulation steps), checkpoints and plots written by rank 0
(``train/trainer.py::train_epochs``). The data: a replicAnt folder, a single- or
multi-view HDF5 store (read by ``utils/hdf5_io.py``) or the weighted multi-dataset mix,
split with the config's seed, optionally cached decoded, augmented, and
held on the device (``training.device_data_cache``). Checkpoints are
``<output-dir>/<name>.pt`` beside ``<name>.meta.json`` (``best_model``,
``epoch_N``, ``final_model``), which ``cli/run_inference.py`` serves.

:func:`parse_set_overrides` and :func:`build_dataset` are shared with the
serving CLIs.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from smilify_tpu_torch._device import set_float32_matmul
from smilify_tpu_torch.train.config import joint_importance_on
from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn, make_target_fn


def parse_set_overrides(pairs):
    """``["a.b=1", "c.d=x"]`` → ``{"a.b": 1, "c.d": "x"}`` (values parsed as
    JSON where they parse)."""
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        out[key] = val
    return out


def build_dataset(cfg, spec, source=None):
    """(dataset, kind) for ``cfg.dataset.data_path``: a replicAnt folder, a
    single- or multi-view HDF5 store (a multi-view store read one view an
    item for a single-view config), or the weighted multi-dataset mix;
    ``source`` (a ``data.hdf5_dataset.MultiViewStore``) stands in for the
    path."""
    from smilify_tpu_torch.data.hdf5_dataset import (
        MultiViewHDF5Dataset,
        SingleViewHDF5Dataset,
        detect_dataset_type,
    )
    from smilify_tpu_torch.data.replicant import ReplicantDataset

    res = cfg.model.input_resolution or 224
    if cfg.multi_dataset.enabled:
        from smilify_tpu_torch.data.combined import build_combined_from_config

        return build_combined_from_config(cfg, joint_names=spec.joint_names), "combined"
    path = cfg.dataset.data_path if source is None else source
    kind = detect_dataset_type(path)
    if kind == "replicant_raw":
        return ReplicantDataset(path, spec.joint_names, image_size=res), kind
    if kind.endswith("multiview") or kind == "sleap_multiview":
        if cfg.mode == "multi_view":
            return MultiViewHDF5Dataset(
                path, num_views_to_use=cfg.multiview.num_views_to_use, seed=cfg.training.seed,
            ), kind
        return MultiViewHDF5Dataset(
            path,
            return_single_view=True,
            camera_centric=cfg.dataset.frame_convention == "camera_centric",
            expand_all_views=cfg.dataset.expand_all_views,
            seed=cfg.training.seed,
        ), kind
    return SingleViewHDF5Dataset(path), kind


def prepare_splits(cfg, dataset, kind, multiview: bool):
    """(train, val) datasets of the config's seeded split (by sample where
    the dataset lists one per item, within each source for a per-dataset
    combined split), the decoded cache and the augmentation wrapped around
    them as the JAX trainers wrap them."""
    from smilify_tpu_torch.train.trainer import (
        SubsetDataset,
        split_dataset,
        split_dataset_grouped,
        split_dataset_per_group,
    )

    ratios = (cfg.dataset.train_ratio, cfg.dataset.val_ratio, cfg.dataset.test_ratio)
    if getattr(dataset, "item_sample_indices", None) is not None:
        tr_idx, val_idx, te_idx = split_dataset_grouped(dataset.item_sample_indices, ratios,
                                                        cfg.training.seed)
    elif kind == "combined" and cfg.multi_dataset.validation_split_strategy == "per_dataset":
        tr_idx, val_idx, te_idx = split_dataset_per_group(dataset.group_ids, ratios,
                                                          cfg.training.seed)
    else:
        tr_idx, val_idx, te_idx = split_dataset(len(dataset), ratios, cfg.training.seed)
    train_ds, val_ds = SubsetDataset(dataset, tr_idx), SubsetDataset(dataset, val_idx)
    if cfg.training.cache_decoded_samples:
        # the clean decode is cached under the augmentation, which resamples each epoch
        from smilify_tpu_torch.data.cache import DecodedSampleCache

        train_ds = DecodedSampleCache(train_ds, max_bytes=cfg.training.cache_max_bytes)
        val_ds = DecodedSampleCache(val_ds, max_bytes=cfg.training.cache_max_bytes)
    if cfg.augmentation.enabled:
        from smilify_tpu_torch.data.augmentation import AugmentedDataset, params_from_config

        train_ds = AugmentedDataset(train_ds, params_from_config(cfg.augmentation),
                                    seed=cfg.training.seed, multiview=multiview)
        print("augmentation active (photometric"
              + ("+geometric" if cfg.augmentation.geometric_enabled else "") + ")")
    print(f"split: {len(train_ds)} train / {len(val_ds)} val / {len(te_idx)} test")
    return train_ds, val_ds


def base_parser(description: str, output_dir: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", default=None)
    ap.add_argument("--model", default=None, help="SMIL model .pkl")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--output-dir", default=output_dir)
    ap.add_argument("--resume", default=None, help="checkpoint name/path to resume")
    ap.add_argument("--allow-random-backbone", action="store_true",
                    help="permit freeze_backbone=true without model.pretrained_npz")
    ap.add_argument("--set", nargs="*", default=None, help="dotted config overrides a.b=c")
    ap.add_argument("--multihost", action="store_true",
                    help="start the process group (torchrun's or SLURM's environment starts "
                         "it anyway) and train data-parallel over its ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def setup_data_parallel(args, cfg):
    """(device, ``('data',)`` mesh or None, global batch size): the process
    group when asked for, this rank's device, and the config's batch
    rounded to a multiple of ranks × accumulation steps."""
    from smilify_tpu_torch.cli.optimize_to_joints import setup_device
    from smilify_tpu_torch.train.trainer import data_mesh

    dev = setup_device(args)
    mesh = data_mesh(dev)
    bs = cfg.training.batch_size
    if mesh is not None:
        step = mesh.size() * cfg.training.gradient_accumulation_steps
        if bs % step:
            bs = max(step, (bs // step) * step)
            print(f"batch_size rounded to {bs} for {mesh.size()} ranks")
    return dev, mesh, bs


def load_run_config(args, mode: str):
    from smilify_tpu_torch.train.config import load_config

    overrides = parse_set_overrides(args.set)
    if args.data_path:
        overrides["dataset.data_path"] = args.data_path
    if args.epochs is not None:
        overrides["training.num_epochs"] = args.epochs
    if args.model:
        overrides["smal_model.smal_file"] = args.model
    return load_config(args.config, overrides=overrides, mode=mode)


def init_model(cfg, rcfg, res: int, dev: torch.device, allow_random_backbone: bool):
    """The port's regressor for ``rcfg`` from the config's seed, the
    pretrained policy applied, on ``dev`` (channels_last on a card)."""
    from smilify_tpu_torch.models.weight_port import apply_pretrained_policy, build_model

    torch.manual_seed(cfg.training.seed)
    t0 = time.time()
    model = build_model(rcfg, img_size=res)
    apply_pretrained_policy(cfg, model, allow_random_backbone=allow_random_backbone)
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    print(f"model initialized ({time.time() - t0:.0f}s)")
    return model


def main(argv=None, source=None):
    """The CLI; a caller holding its samples in memory passes them as
    ``source`` (a ``data.hdf5_dataset.MultiViewStore``) instead of
    ``--data-path``."""
    args = base_parser("Train the single-view SMIL regressor", "runs/singleview").parse_args(argv)
    cfg = load_run_config(args, "single_view")
    dev, mesh, batch_size = setup_data_parallel(args, cfg)
    set_float32_matmul(dev)

    from smilify_tpu_torch.models.regressor import compute_batch_loss
    from smilify_tpu_torch.train.config import resolve_ignored_joint_indices, resolve_model_spec
    from smilify_tpu_torch.train.trainer import TrainState, train_epochs, try_resume

    spec = resolve_model_spec(cfg, device=dev)
    rcfg = cfg.regressor_config(spec)
    dataset, kind = build_dataset(cfg, spec, source)
    print(f"dataset: {kind}, {len(dataset)} samples; model J={spec.n_joints} B={spec.n_betas}")
    train_ds, val_ds = prepare_splits(cfg, dataset, kind, multiview=False)

    res = cfg.model.input_resolution or 224
    model = init_model(cfg, rcfg, res, dev, args.allow_random_backbone)
    os.makedirs(args.output_dir, exist_ok=True)
    joint_importance = joint_importance_on(cfg, spec, dev)
    target_dict = make_target_fn(spec, resolve_ignored_joint_indices(cfg, spec.joint_names))
    apply_fn = make_singleview_apply_fn(rcfg, spec)

    def make_loss(weights):
        def loss_fn(preds, batch):
            return compute_batch_loss(spec, rcfg, preds, target_dict(batch), weights,
                                      image_size=(res, res), joint_importance=joint_importance)

        return loss_fn

    def visualize(epoch):
        from smilify_tpu_torch.data.hdf5_dataset import collate_multiview
        from smilify_tpu_torch.train.train_viz import epoch_visualization

        viz_ds = val_ds if len(val_ds) else train_ds
        vb = collate_multiview([viz_ds[i] for i in
                                range(min(cfg.output.num_visualization_samples, len(viz_ds)))])
        if "image" not in vb:
            return {}
        return epoch_visualization(spec, apply_fn, model, vb, (res, res), args.output_dir, epoch,
                                   multiview=False, viz_dir=cfg.output.train_visualizations_dir)

    state, start_epoch = try_resume(
        args.output_dir, args.resume or cfg.training.resume_checkpoint,
        TrainState(model.state_dict()), model,
        reset_ief_token_embedding=cfg.training.reset_ief_token_embedding)
    return train_epochs(model, cfg, apply_fn, make_loss, train_ds, val_ds,
                        batch_size, dev, args.output_dir, state, start_epoch, visualize, mesh)


if __name__ == "__main__":
    main()
