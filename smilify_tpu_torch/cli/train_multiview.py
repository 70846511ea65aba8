"""Multi-view regressor training CLI (port of ``smilify_tpu/cli/train_multiview.py``).

    python -m smilify_tpu_torch.cli.train_multiview --config cfg.json \
        --model <pkl> --data-path <multiview.h5> [--epochs N] [--set a.b=c ...] \
        [--output-dir runs/multiview] [--resume NAME] [--device cuda]

Trains on one device (``--device``, default ``cuda``; it raises without a
card unless given ``cpu``), or data-parallel under torchrun or
``--multihost`` as ``cli/train_regressor.py`` does, from a multi-view HDF5
store (read by ``utils/hdf5_io.py``) or, in memory, the samples of
``data/synthetic.py::synthesize_multiview`` held in a ``DeviceDataCache``.
The epoch loop, checkpoints and visualizations are the single-view
trainer's (``train/trainer.py::train_epochs``).
"""

from __future__ import annotations

import os

from smilify_tpu_torch._device import set_float32_matmul
from smilify_tpu_torch.cli.train_regressor import (
    base_parser,
    init_model,
    load_run_config,
    prepare_splits,
    setup_data_parallel,
)
from smilify_tpu_torch.train.config import joint_importance_on


def main(argv=None, source=None):
    """The CLI; a caller holding its samples in memory passes them as
    ``source`` (a ``data.hdf5_dataset.MultiViewStore``) instead of
    ``--data-path``."""
    args = base_parser("Train the multi-view SMIL regressor", "runs/multiview").parse_args(argv)
    cfg = load_run_config(args, "multi_view")
    dev, mesh, batch_size = setup_data_parallel(args, cfg)
    set_float32_matmul(dev)

    from smilify_tpu_torch.data.hdf5_dataset import MultiViewHDF5Dataset, collate_multiview
    from smilify_tpu_torch.train.config import resolve_ignored_joint_indices, resolve_model_spec
    from smilify_tpu_torch.train.multiview_setup import (
        make_multiview_apply_fn,
        make_multiview_loss_fn,
    )
    from smilify_tpu_torch.train.trainer import TrainState, train_epochs, try_resume

    spec = resolve_model_spec(cfg, device=dev)
    rcfg = cfg.regressor_config(spec)
    dataset = MultiViewHDF5Dataset(
        cfg.dataset.data_path if source is None else source,
        num_views_to_use=cfg.multiview.num_views_to_use,
        view_sampling=cfg.multiview.view_sampling, seed=cfg.training.seed,
        min_views=cfg.multiview.min_views_per_sample)
    res = dataset.target_resolution
    V = cfg.multiview.num_views_to_use
    print(f"multiview dataset: {len(dataset)} samples, max_views={V}, res={res}, "
          f"world_scale={dataset.world_scale}")
    train_ds, val_ds = prepare_splits(cfg, dataset, "multiview", multiview=True)

    model = init_model(cfg, rcfg, res, dev, args.allow_random_backbone)
    os.makedirs(args.output_dir, exist_ok=True)
    apply_fn = make_multiview_apply_fn(rcfg, spec, (res, res))
    joint_importance = joint_importance_on(cfg, spec, dev)
    ignored_idx = resolve_ignored_joint_indices(cfg, spec.joint_names)

    def make_loss(weights):
        return make_multiview_loss_fn(spec, rcfg, weights, (res, res),
                                      joint_importance=joint_importance,
                                      ignored_joint_indices=ignored_idx)

    def visualize(epoch):
        from smilify_tpu_torch.train.train_viz import epoch_visualization

        viz_ds = val_ds if len(val_ds) else train_ds
        vb = collate_multiview([viz_ds[i] for i in
                                range(min(cfg.output.num_visualization_samples, len(viz_ds)))])
        metrics = epoch_visualization(spec, apply_fn, model, vb, (res, res), args.output_dir,
                                      epoch, multiview=True,
                                      viz_dir=cfg.output.train_visualizations_dir)
        if metrics:
            tail = {k: round(v, 5) for k, v in list(metrics.items())[:3]}
            print(f"epoch {epoch}: ief deltas {tail} "
                  f"(collages -> {cfg.output.train_visualizations_dir}/)")
        return metrics

    state, start_epoch = try_resume(
        args.output_dir, args.resume or cfg.training.resume_checkpoint,
        TrainState(model.state_dict()), model,
        reset_ief_token_embedding=cfg.training.reset_ief_token_embedding)
    return train_epochs(model, cfg, apply_fn, make_loss, train_ds, val_ds,
                        batch_size, dev, args.output_dir, state, start_epoch, visualize, mesh)


if __name__ == "__main__":
    main()
