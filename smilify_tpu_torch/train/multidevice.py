"""Multi-rank correctness harness for the neural trainer and the sharded
fitters (port of ``smilify_tpu/train/multidevice.py`` and of
``__graft_entry__.dryrun_multichip``).

:func:`run_trainer_check` runs one data-parallel train step and one eval
step of the multi-view regressor over a ``('data',)`` mesh of every rank
and holds them to the same steps in one process on the whole batch: the
loss, the eval loss, the update's norm and the BatchNorm running
statistics (global-batch statistics: ``models/backbones.py::sync_batchnorm``).
:func:`dryrun_multichip` runs the frame-sharded fitter, that check and the
clip-sharded corpus fitter.

Every rank runs the same call; launch with torchrun::

    torchrun --nproc_per_node 2 -m smilify_tpu_torch.train.multidevice [--device cpu]
        [--backend gloo]

(on one card two ranks need ``--backend gloo``: NCCL refuses two ranks on
one card).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.core.spec import toy_model_spec  # noqa: F401  (the toy spec of the JAX harness)

# multiview_setup's loss weights, as the JAX harness sets them
LOSS_WEIGHTS = {"keypoint_2d": 1.0, "keypoint_3d": 1.0, "joint_rot": 0.1, "betas": 0.1,
                "cam_rot": 0.1, "fov": 0.01, "triangulation_consistency": 0.1}
# the JAX harness's gates (single against sharded), and the running statistics'
LOSS_RTOL, UPDATE_RTOL, STATS_RTOL = 2e-5, 2e-4, 1e-6


def tiny_multiview_config(spec, n_views: int = 2):
    """A CPU-sized MultiViewConfig: unet_micro backbone, a small decoder,
    float32 throughout, as the JAX harness's."""
    from smilify_tpu_torch.models.multiview import MultiViewConfig

    return MultiViewConfig(
        backbone="unet_micro", head_type="transformer", rotation_representation="6d",
        n_pose=spec.n_joints - 1, n_betas=spec.n_betas, n_joints=spec.n_joints,
        scale_trans_mode="ignore", ief_iters=1, decoder_dim=32, decoder_depth=1,
        decoder_heads=2, mlp_hidden=64, dropout=0.0, compute_dtype=torch.float32,
        max_views=n_views, num_canonical_cameras=max(4, n_views), fusion_heads=2,
        fusion_layers=1, camera_delta_mode=True)


def synthetic_multiview_batch(spec, batch_size: int, n_views: int, res: int,
                              seed: int = 0) -> Dict[str, np.ndarray]:
    """An in-memory batch with the keys ``collate_multiview`` gives (the JAX
    harness's numbers for the same seed)."""
    from smilify_tpu_torch.data.synthetic import ring_cameras_opencv

    rng = np.random.RandomState(seed)
    K = spec.n_joints
    cams = ring_cameras_opencv(n_views, resolution=res)
    Rs = np.stack([c[0] for c in cams]).astype(np.float32)
    ts = np.stack([c[1] for c in cams]).astype(np.float32)
    Ks = np.stack([c[2] for c in cams]).astype(np.float32)
    return {
        "images": rng.rand(batch_size, n_views, res, res, 3).astype(np.float32),
        "view_mask": np.ones((batch_size, n_views), bool),
        "camera_indices": np.tile(np.arange(n_views, dtype=np.int32), (batch_size, 1)),
        "keypoints_2d": (rng.rand(batch_size, n_views, K, 2) * res).astype(np.float32),
        "keypoint_visibility": np.ones((batch_size, n_views, K), np.float32),
        "keypoints_3d": (rng.randn(batch_size, K, 3) * 0.1).astype(np.float32),
        "camera_intrinsics": np.tile(Ks, (batch_size, 1, 1, 1)),
        "camera_extrinsics_R": np.tile(Rs, (batch_size, 1, 1, 1)),
        "camera_extrinsics_t": np.tile(ts, (batch_size, 1, 1)),
        "global_rot": (rng.randn(batch_size, 3) * 0.2).astype(np.float32),
        "joint_rot": (rng.randn(batch_size, K - 1, 3) * 0.1).astype(np.float32),
        "betas": (rng.randn(batch_size, spec.n_betas) * 0.2).astype(np.float32),
        "trans": np.zeros((batch_size, 3), np.float32),
    }


def _optimizer_config():
    """The JAX harness's ``chain(clip_by_global_norm(1), adamw(1e-4))`` as
    the trainers' config gives it (one lr for head and backbone)."""
    from smilify_tpu_torch.train.config import load_config

    return load_config(None, overrides={
        "optimizer.optimizer_type": "adamw", "optimizer.weight_decay": 1e-4,
        "optimizer.gradient_clip_norm": 1.0, "model.backbone_lr_multiplier": 1.0,
        "model.freeze_backbone": False}, mode="multi_view")


def _stats(model) -> torch.Tensor:
    return torch.cat([b.detach().reshape(-1).double() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))])


def _step_once(model, spec, rcfg, batch, res, accum_steps, mesh):
    """One train step and one eval step of ``model`` on ``batch`` (this
    rank's rows of it when ``mesh`` is given). Returns (loss, eval loss,
    update norm, running statistics after the step)."""
    from smilify_tpu_torch.train.multiview_setup import (
        make_multiview_apply_fn,
        make_multiview_loss_fn,
    )
    from smilify_tpu_torch.train.trainer import (
        build_optimizer,
        make_eval_step,
        make_train_step,
        shard_batch,
    )

    apply_fn = make_multiview_apply_fn(rcfg, spec, (res, res))
    loss_fn = make_multiview_loss_fn(spec, rcfg, LOSS_WEIGHTS, (res, res))
    opt = build_optimizer(_optimizer_config(), 1e-4, False, model)
    train_step = make_train_step(model, apply_fn, loss_fn, opt, accum_steps, mesh)
    eval_step = make_eval_step(model, apply_fn, loss_fn, mesh)
    start = [p.detach().clone() for p in model.parameters()]
    eval_loss, _ = eval_step(shard_batch(mesh, batch))
    loss, _ = train_step(shard_batch(mesh, batch, accum_steps))
    upd = torch.sqrt(sum(torch.sum((p.detach() - s) ** 2) for p, s in zip(model.parameters(), start)))
    return float(loss), float(eval_loss), float(upd), _stats(model)


def _world(n_ranks: Optional[int]) -> int:
    """The process group's size, which ``n_ranks`` (when given) must be."""
    from smilify_tpu_torch.train.multihost import process_count

    n = process_count()
    if n_ranks is not None and n_ranks != n:
        raise ValueError(f"asked for {n_ranks} ranks, the process group has {n}: launch "
                         f"under torchrun --nproc_per_node {n_ranks}")
    return n


def run_trainer_check(n_ranks: Optional[int] = None, batch_size: Optional[int] = None,
                      accum_steps: int = 2,
                      compare_single: bool = True, res: int = 32, n_views: int = 2,
                      verbose: bool = True, spec=None, device="cuda",
                      state_dict: Optional[Dict[str, torch.Tensor]] = None,
                      global_batchnorm: bool = True, check: bool = True) -> Dict:
    """One data-parallel train step + eval step over the ``n_ranks`` ranks
    of the process group (default: all; every rank calls it together).

    The initial weights: ``state_dict`` (e.g. the JAX harness's variables
    carried by ``weight_port.state_dict_from_flax``) or the port's seeded
    init. With ``compare_single`` the same steps rerun in this process on
    the whole batch and the losses (rtol 2e-5), the update's norm (2e-4)
    and the BatchNorm running statistics (1e-6 relative) must agree.
    ``global_batchnorm=False`` keeps each rank's BatchNorms on its own rows
    (what DDP does by default), which the comparison rejects. Returns the
    scalars and, with ``compare_single``, the relative gaps (``check=False``
    returns them without the gates)."""
    from smilify_tpu_torch.models.backbones import sync_batchnorm
    from smilify_tpu_torch.models.weight_port import build_model
    from smilify_tpu_torch.train.trainer import data_mesh

    dev = resolve_device(device)
    n = _world(n_ranks)
    spec = spec if spec is not None else toy_model_spec(device=dev)
    if batch_size is None:
        batch_size = n * max(1, accum_steps)
    rcfg = tiny_multiview_config(spec, n_views)
    batch_np = synthetic_multiview_batch(spec, batch_size, n_views, res)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    def fresh_model():
        torch.manual_seed(0)
        model = build_model(rcfg, img_size=res)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return model.to(dev)

    mesh = data_mesh(dev)
    model = fresh_model()
    if mesh is not None and not global_batchnorm:
        from smilify_tpu_torch.train.trainer import data_parallel

        data_parallel(model, mesh)
        sync_batchnorm(model, None)
    loss_n, eval_n, upd_n, stats_n = _step_once(model, spec, rcfg, batch, res, accum_steps, mesh)
    if not (np.isfinite(loss_n) and np.isfinite(eval_n)):
        raise AssertionError("non-finite data-parallel loss")
    result = {"n_ranks": n, "loss": loss_n, "eval_loss": eval_n, "update_norm": upd_n}
    if compare_single:
        loss_1, eval_1, upd_1, stats_1 = _step_once(fresh_model(), spec, rcfg, batch, res,
                                                    accum_steps, None)
        stats_gap = float(torch.max(torch.abs(stats_n - stats_1)) / torch.max(torch.abs(stats_1)))
        gaps = {"loss": abs(loss_n - loss_1) / abs(loss_1),
                "eval_loss": abs(eval_n - eval_1) / abs(eval_1),
                "update_norm": abs(upd_n - upd_1) / abs(upd_1), "stats": stats_gap}
        gates = {"loss": LOSS_RTOL, "eval_loss": LOSS_RTOL, "update_norm": UPDATE_RTOL,
                 "stats": STATS_RTOL}
        result.update(loss_single=loss_1, eval_single=eval_1, update_single=upd_1,
                      rel_gaps=gaps)
        over = {k: v for k, v in gaps.items() if not v <= gates[k]}
        if check and over:
            raise AssertionError(f"data-parallel step != single-process step: relative gaps "
                                 f"{over} over their gates {gates}")
    if verbose:
        print(f"multidevice trainer check ({n} ranks): loss={loss_n:.6f} eval={eval_n:.6f} "
              f"upd={upd_n:.4e} OK")
    return result


def dryrun_multichip(n_ranks: Optional[int] = None, device="cuda") -> None:
    """The full sharded step of every scale-out path on tiny shapes, over
    the ``n_ranks`` ranks of the process group (default: all; the
    counterpart of ``__graft_entry__.dryrun_multichip``):

      1. the frame-sharded sequence fitter (SMIL forward, projection,
         silhouette and priors on a ``('frames',)`` mesh: per-frame
         parameters local, shared gradients all-reduced, the temporal halo);
      2. the data-parallel multi-view train step (:func:`run_trainer_check`,
         with gradient accumulation, against one process);
      3. the clip-sharded corpus fitter (a ``('clips',)`` mesh)."""
    from smilify_tpu_torch.fitter.fitter import FitData
    from smilify_tpu_torch.fitter.fitter_batch import ShardedBatchedFitter
    from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter
    from smilify_tpu_torch.fitter.stages import StageWeights

    dev = resolve_device(device)
    n = _world(n_ranks)
    spec = toy_model_spec(device=dev)
    rng = np.random.RandomState(0)
    N, H, W = n, 32, 32
    seq = FitData(rgb=None,
                  sil=torch.from_numpy(rng.rand(N, H, W).astype(np.float32)),
                  joints=torch.from_numpy(rng.rand(N, spec.n_joints, 2).astype(np.float32) * H),
                  visibility=torch.ones((N, spec.n_joints)))
    stage = StageWeights(num_iters=1, lr=1e-3, w_j2d=1.0, w_reproj=0.5, w_betas=0.1,
                         w_pose=0.01, w_limit=0.01, w_splay=0.01, w_temp=0.5)
    loss = ShardedSequenceFitter(spec, seq, (H, W), device=dev).run_stage(1, stage)
    if not np.isfinite(float(loss)):
        raise AssertionError("frame-sharded fit: non-finite loss")
    print(f"dryrun_multichip({n}) fitter: loss={float(loss):.4f} OK")

    run_trainer_check(n, accum_steps=2, spec=spec, device=dev)

    rng = np.random.RandomState(1)
    S, N = n, 1
    corpus = FitData(rgb=None,
                     sil=torch.from_numpy(rng.rand(S, N, H, W).astype(np.float32)),
                     joints=torch.from_numpy(rng.rand(S, N, spec.n_joints, 2).astype(np.float32) * H),
                     visibility=torch.ones((S, N, spec.n_joints)))
    stage = stage._replace(w_temp=0.0)
    corpus_loss = ShardedBatchedFitter(spec, corpus, (H, W), device=dev).run_stage(1, stage)
    if not np.isfinite(float(corpus_loss)):
        raise AssertionError("clip-sharded corpus fit: non-finite loss")
    print(f"dryrun_multichip({n}) corpus fitter: loss={float(corpus_loss):.4f} OK")
    print(f"dryrun_multichip({n}): fitter + neural trainer + corpus fitter OK")


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-rank dry run of the scale-out paths "
                                             "(launch under torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on cuda) or gloo (default on cpu; two ranks on one card)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from smilify_tpu_torch.cli.train_regressor import set_float32_matmul
    from smilify_tpu_torch.train.multihost import maybe_initialize_multihost, rank_device

    maybe_initialize_multihost(True, device=args.device, backend=args.backend)
    dev = rank_device(args.device)
    set_float32_matmul(dev)
    try:
        dryrun_multichip(device=dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
