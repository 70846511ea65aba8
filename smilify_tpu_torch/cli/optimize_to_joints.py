"""Optimization-fitting CLI (port of ``smilify_tpu/cli/optimize_to_joints.py``;
the reference ``python -m smal_fitter.optimize_to_joints``).

Fits the SMIL model to a sequence (replicAnt COCO / BADJA / StanfordExtra)
through the multi-stage OPT_WEIGHTS schedule, exporting per frame a collage
PNG, a parameter pkl and the posed PLY every ``--vis-frequency`` iterations
and once at the end (``st10_ep0``).

Usage:
  python -m smilify_tpu_torch.cli.optimize_to_joints \\
      --model 3D_model_prep/SMILy_STICK.pkl \\
      --sequence replicAnt:SMIL_09_synth.jpg \\
      --data-root data/replicAnt_trials/SMIL_COCO \\
      [--crop-size 512] [--test] [--device cuda]

It runs on ``--device`` (default ``cuda``; it raises when there is no card)
with the raster kernels of ``smilify_tpu_torch/csrc`` there, or on ``cpu``
with their plain versions. Frames are read as PNG without imageio; other
image formats need imageio, which the card's machine lacks.

``--shard-frames`` cuts the sequence's frames over the ranks of the process
group (launch under torchrun, one rank a card:
:class:`~smilify_tpu_torch.fitter.fitter_frames.ShardedSequenceFitter`); the
frame count must divide by the rank count. ``--multihost`` starts the
process group from the flag (torchrun's or SLURM's environment starts it
anyway); the exports are written by rank 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device, set_float32_matmul


def resolve_approx_max_faces(args, image_size, auto_fn):
    """CLI cap semantics shared by the fitter CLIs: --exact wins; 'auto' →
    ``auto_fn(image_size)``, the IoU-gated resolution-scaled default (None
    off the card); an integer pins the cap."""
    if args.exact:
        return None
    v = args.approx_max_faces
    if isinstance(v, str):
        if v.lower() in ("auto", ""):
            cap = auto_fn(image_size)
            if cap is not None:
                print(f"work-list raster cap (auto): {cap} faces/tile "
                      f"(--exact opts out)")
            return cap
        if v.lower() in ("exact", "none"):
            return None
        v = int(v)
    return v


def load_sequence(dataset: str, name: str, args, spec, image_range=None):
    """``dataset:name`` → ((rgb, sil, joints, vis) numpy arrays, frame file names)."""
    from smilify_tpu_torch.data.loaders import (
        load_badja_sequence,
        load_smil_sequence,
        load_stanford_sequence,
    )

    if dataset == "replicAnt":
        return load_smil_sequence(
            args.data_root, name, args.crop_size,
            joint_names=spec.joint_names,
            ignore_joints=[spec.joint_names[i] for i in spec.ignore_joints],
            use_crop=args.use_crop,
        )
    if dataset == "badja":
        return load_badja_sequence(
            args.data_root, name, args.crop_size,
            annotated_classes=list(range(spec.n_joints)), image_range=image_range,
        )
    if dataset == "stanfordextra":
        return load_stanford_sequence(args.data_root, name, args.crop_size)
    raise SystemExit(f"unknown dataset {dataset}")


def load_priors(args, spec, device):
    """(pose prior, shape prior) from ``--walking-prior`` / ``--unity-prior``
    (None where not given: the fitter's defaults)."""
    from smilify_tpu_torch.fitter.priors import unity_shape_prior, walking_pose_prior

    pose = walking_pose_prior(args.walking_prior, device=device) if args.walking_prior else None
    shape = (unity_shape_prior(args.unity_prior, n_betas=spec.n_betas, device=device)
             if args.unity_prior else None)
    return pose, shape


def setup_device(args) -> torch.device:
    """The process group when ``--multihost`` or the launcher's environment
    asks for it (its backend from ``--device``), then this rank's device
    (``cuda:LOCAL_RANK``); ``--device`` itself in a single process."""
    from smilify_tpu_torch.train.multihost import maybe_initialize_multihost, rank_device

    dev = resolve_device(args.device)
    if maybe_initialize_multihost(getattr(args, "multihost", False), device=dev):
        dev = rank_device(dev)
    return dev


def gathered_params(fitter):
    """The fitter's parameters over every frame or clip: a sharded fitter's
    gathered from every rank (a collective), a single-device fitter's as
    they are."""
    gather = getattr(fitter, "gathered_params", None)
    return gather() if gather is not None else fitter.params


def frame_params(params, i: int) -> dict:
    """Frame ``i``'s parameters under the pkl names of the JAX exporter."""
    def host(x):
        return x.detach().cpu().numpy()

    return {
        "global_rotation": host(params.global_rot[i]),
        "joint_rotations": host(params.joint_rot[i]),
        "betas": host(params.betas),
        "trans": host(params.trans[i]),
        "fov": host(params.fov[i]),
        "log_betascale": host(params.log_beta_scales),
        "betas_trans": host(params.joint_trans),
    }


@torch.no_grad()
def frame_collage(spec, camera, verts, joints3d, fov, image_size, rgb, sil, joints, vis,
                  texture=False):
    """One frame's collage (float, [0, 1]): the JAX CLI's panels through
    :func:`~smilify_tpu_torch.utils.visualization.fit_collage`, the soft
    silhouette or (``texture``) the hard Phong render in the render panel."""
    from smilify_tpu_torch.fitter.fitter import render_frame
    from smilify_tpu_torch.render.phong import render_phong
    from smilify_tpu_torch.utils.visualization import fit_collage

    cam = camera.replace(fov=fov)
    sil_r, kp_yx = render_frame(spec, cam, verts, joints3d, image_size)
    sil_r = sil_r.cpu().numpy()
    if texture:
        # rgb/texture collage: hard-Phong render instead of the soft
        # silhouette panel (reference rgb_only, p3d_renderer.py:54-70)
        pv = cam.world_to_view(verts)
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        render_panel = render_phong(verts, pv, ndc, spec.faces, image_size).cpu().numpy()
    else:
        render_panel = np.repeat(sil_r[..., None], 3, axis=-1)
    return fit_collage(rgb, render_panel, sil, sil_r, joints, kp_yx.cpu().numpy(), vis)


def main(argv=None):
    ap = argparse.ArgumentParser(description="SMIL optimization fitter")
    ap.add_argument("--model", required=True, help="model .pkl file")
    ap.add_argument("--sequence", default="replicAnt:SMIL_09_synth.jpg",
                    help="dataset:name — replicAnt:<img>, badja:<seq>, stanfordextra:<img>")
    ap.add_argument("--data-root", default="data/replicAnt_trials/SMIL_COCO")
    ap.add_argument("--crop-size", type=int, default=512)
    ap.add_argument("--use-crop", action="store_true",
                    help="crop around the silhouette to --crop-size (reference "
                         "crop_to_silhouette; replicAnt frames are otherwise native size)")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--vis-frequency", type=int, default=50)
    ap.add_argument("--image-range", type=int, nargs=2, default=None, metavar=("LO", "HI"))
    ap.add_argument("--test", action="store_true", help="10-iteration test schedule")
    ap.add_argument("--test-stages", type=int, default=None,
                    help="truncate the --test schedule to N stages")
    ap.add_argument("--limb-scaling", action=argparse.BooleanOptionalAction, default=True,
                    help="optimize per-joint limb scales (--no-limb-scaling freezes them)")
    ap.add_argument("--unity-prior", default=None, metavar="NPZ",
                    help="unity shape-prior npz (reference use_unity_prior, fitter.py:86-107)")
    ap.add_argument("--walking-prior", default=None, metavar="PKL",
                    help="walking pose-prior pkl (reference priors/pose_prior_35.py)")
    ap.add_argument("--texture", action="store_true",
                    help="rgb/texture collage: overlay the hard-Phong render "
                         "(reference rgb_only mode, fitter.py:57 + p3d_renderer.py:54-70)")
    ap.add_argument("--progressive", nargs="?", const="1,4,2,1", default=None,
                    metavar="SCALES",
                    help="coarse-to-fine pyramid: comma-separated per-stage "
                         "downsample factors (default 1,4,2,1 — stage 0 has no "
                         "raster; raster stages run 4x/2x/full)")
    ap.add_argument("--approx-max-faces", default="auto",
                    help="work-list raster: per-tile z-nearest face cap. 'auto' "
                         "(default) = the IoU-gated resolution-scaled cap on the card "
                         "(800 at 512²), exact raster on the CPU; an integer pins the "
                         "cap; --exact opts out")
    ap.add_argument("--exact", action="store_true",
                    help="exact all-faces SoftRas (disable the auto work-list cap)")
    ap.add_argument("--iter-chunk", type=int, default=10,
                    help="optimization steps run back to back between loss read-backs "
                         "(visualizations see end-of-chunk params; 1 = every step)")
    ap.add_argument("--shard-frames", action="store_true",
                    help="cut the frames over the ranks of the process group (launch under "
                         "torchrun; per-frame params stay on their rank, the shared ones' "
                         "gradients are all-reduced, the temporal pairs across ranks take a "
                         "halo exchange; the frame count must divide by the rank count — "
                         "use --image-range to trim)")
    ap.add_argument("--load-checkpoint", default=None, metavar="DIR",
                    help="reload per-frame st{N}_ep{M}.pkl params from a previous run "
                         "(reference fitter.load_checkpoint, fitter.py:352-371)")
    ap.add_argument("--checkpoint-stage", type=int, default=10)
    ap.add_argument("--checkpoint-epoch", default="0")
    ap.add_argument("--multihost", action="store_true",
                    help="start the process group (torchrun's or SLURM's environment starts "
                         "it anyway); exports are written by rank 0")
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = setup_device(args)
    set_float32_matmul(dev)

    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.fitter.fitter import (
        FitData,
        SmalFitter,
        params_from_numpy,
        posed_frames,
    )
    from smilify_tpu_torch.fitter.progressive import ProgressiveFitter
    from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS, test_schedule
    from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces
    from smilify_tpu_torch.train.multihost import is_primary, process_count
    from smilify_tpu_torch.utils.export import ImageExporter, load_fitter_checkpoint

    spec = load_model_spec(args.model, align_symmetry=False, device=dev)
    out_dir = args.output_dir or os.path.join("checkpoints", time.strftime("%Y%m%d-%H%M%S"))

    dataset, name = args.sequence.split(":")
    rng = range(*args.image_range) if args.image_range else None
    (rgb, sil, joints, vis), filenames = load_sequence(dataset, name, args, spec, rng)
    H, W = sil.shape[1], sil.shape[2]
    print(f"Dataset size: {len(filenames)}  image {H}x{W}  model J={spec.n_joints}")

    data = FitData(rgb=rgb, sil=torch.from_numpy(sil), joints=torch.from_numpy(joints),
                   visibility=torch.from_numpy(vis))
    pose_prior, shape_prior = load_priors(args, spec, dev)

    approx = resolve_approx_max_faces(args, (H, W),
                                      lambda size: auto_approx_max_faces(size, device=dev))
    kwargs = dict(allow_limb_scaling=args.limb_scaling, pose_prior=pose_prior,
                  shape_prior=shape_prior, approx_max_faces=approx, device=dev)
    if args.shard_frames:
        from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter

        print(f"sharding {len(filenames)} frames over {process_count()} rank(s)")
        fitter = base = ShardedSequenceFitter(spec, data, (H, W), **kwargs)
    elif args.progressive:
        scales = [int(s) for s in args.progressive.split(",")]
        print(f"progressive pyramid scales {scales}")
        fitter = ProgressiveFitter(spec, data, (H, W), scales=scales, **kwargs)
        base = fitter.fitter
    else:
        fitter = base = SmalFitter(spec, data, (H, W), **kwargs)

    if args.load_checkpoint:
        ck = load_fitter_checkpoint(args.load_checkpoint, filenames,
                                    args.checkpoint_stage, args.checkpoint_epoch)
        full = params_from_numpy(ck, device=dev)
        fitter.params = fitter.local_params(full) if args.shard_frames else full
        print(f"resumed params from {args.load_checkpoint} "
              f"(st{args.checkpoint_stage}_ep{args.checkpoint_epoch})")

    exporter = ImageExporter(out_dir, filenames)
    schedule = test_schedule(max_stages=args.test_stages) if args.test else OPT_WEIGHTS

    def visualize(stage_id, epoch):
        # gathering a sharded fit's parameters is a collective: every rank
        # joins, rank 0 alone renders and writes
        params = gathered_params(fitter)
        if not is_primary():
            return
        verts, joints3d = posed_frames(spec, params, args.limb_scaling)
        exporter.stage_id = stage_id
        exporter.epoch_name = str(epoch)
        faces = spec.faces.cpu().numpy()
        for i in range(fitter.n_frames):
            collage = frame_collage(spec, base.camera, verts[i], joints3d[i], params.fov[i],
                                    (H, W), rgb[i], sil[i], joints[i], vis[i], args.texture)
            exporter.export(collage * 255.0, i, frame_params(params, i),
                            verts[i].cpu().numpy(), faces)

    t_start = time.time()

    def cb(stage, it, loss, objs):
        if it % args.vis_frequency == 0:
            print(f"stage {stage} it {it:4d} loss {float(loss):.4f} "
                  + " ".join(f"{k}={float(v):.3f}" for k, v in objs.items() if float(v) != 0))
            visualize(stage, it)

    fitter.fit(schedule, callback=cb, chunk=args.iter_chunk)
    visualize(10, 0)  # final export, reference convention stage_id=10
    print(f"done in {time.time()-t_start:.1f}s → {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
