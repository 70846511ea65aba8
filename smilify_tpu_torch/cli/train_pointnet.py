"""Self-supervised point-cloud → SMIL training CLI (port of
``smilify_tpu/cli/train_pointnet.py``).

    python -m smilify_tpu_torch.cli.train_pointnet --model <pkl> [--arch pointnet2] \
        [--epochs 10] [--steps-per-epoch 50] [--batch 8] [--points 1024] [--device cuda]

Each step samples random SMIL configurations (no dataset files), samples
surface point clouds of their bodies and trains PointNet/PointNet++ to
regress the parameters back, with a curriculum that grows the pose and
shape sampling scales over the epochs. The draws come from one
``torch.Generator`` on the device, seeded with ``--seed`` (the JAX CLI
splits a PRNG key; the two draw different samples). Writes
``<output-dir>/final_model.pt`` beside its ``.meta.json``. Runs on one
device (``--device``, default ``cuda``; it raises without a card unless
given ``cpu``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="Self-supervised PointNet SMIL regression")
    ap.add_argument("--model", required=True)
    ap.add_argument("--arch", default="pointnet", choices=["pointnet", "pointnet2"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--output-dir", default="runs/pointnet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.models.pointnet import (
        PointNetConfig,
        SMILPointNet,
        clouds_from_params,
        pointnet_loss,
        sample_smil_configs,
    )
    from smilify_tpu_torch.train.config import TrainingConfig
    from smilify_tpu_torch.train.trainer import PlainAdam, TrainState, save_checkpoint

    spec = load_model_spec(args.model, align_symmetry=False, device=dev)
    cfg = PointNetConfig(arch=args.arch, n_pose=spec.n_joints - 1, n_betas=spec.n_betas,
                         n_joints=spec.n_joints)
    torch.manual_seed(args.seed)
    model = SMILPointNet(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    opt = PlainAdam(model, args.lr)

    def scales_for_epoch(e):
        """The curriculum over the sampling scales."""
        frac = min(1.0, (e + 1) / max(args.epochs // 2, 1))
        return 0.05 + 0.15 * frac, 0.2 + 0.6 * frac

    def step(pose_scale, beta_scale):
        with torch.no_grad():
            gt = sample_smil_configs(spec, args.batch, gen, pose_scale, beta_scale)
            clouds, gt_joints = clouds_from_params(spec, gt, args.points, gen)
        for p in opt.params:
            p.grad = None
        loss, _ = pointnet_loss(spec, cfg, model(clouds), gt, gt_joints, clouds, generator=gen)
        loss.backward()
        opt.step()
        return loss.detach()

    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.time()
    state = TrainState(model.state_dict())
    model.train()
    for epoch in range(args.epochs):
        ps, bs = scales_for_epoch(epoch)
        losses = [step(ps, bs) for _ in range(args.steps_per_epoch)]
        mean_loss = float(np.mean([float(v) for v in losses]))
        state.epoch = epoch
        state.step += args.steps_per_epoch
        state.history.append({"epoch": epoch, "loss": mean_loss})
        print(f"epoch {epoch}: loss {mean_loss:.5f} (pose_scale={ps:.3f} beta_scale={bs:.3f}, "
              f"{time.time() - t0:.0f}s)")
    state.opt_state = opt.inner.state_dict()
    save_checkpoint(args.output_dir, state, TrainingConfig(), name="final_model")
    print(f"checkpoint → {args.output_dir}/final_model")
    return state


if __name__ == "__main__":
    main()
