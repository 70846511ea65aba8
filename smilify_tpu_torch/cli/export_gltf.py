"""Export a SMIL inference animation as a skinned glTF 2.0 binary (port of
``smilify_tpu/cli/export_gltf.py``).

Replaces the reference's two-step interactive Blender workflow — Import
Inference Animation (3D_model_prep/SMIL_processing_addon.py:3442) followed by
Export Animated Model as glTF (:3697) — with one headless command:

  python -m smilify_tpu_torch.cli.export_gltf \\
      --model 3D_model_prep/SMILy_Mouse.pkl \\
      --animation out/clip.npz \\
      --out out/clip.glb [--mode auto|hierarchy|flat] [--static-shape] \\
      [--no-joint-scales] [--fps 30] [--device cuda]

The animation ``.npz`` (+ optional ``.json`` sidecar next to it) is the
AMASS-style file written by ``run_inference --export-animation`` or any
:class:`~smilify_tpu_torch.utils.animation_export.AnimationRecorder` export.
The model loads on ``--device`` (the card by default); the export itself
runs on the host.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="SMIL animation → skinned .glb")
    ap.add_argument("--model", required=True, help="model .pkl")
    ap.add_argument("--animation", default=None,
                    help="animation .npz; omit with --rest-pose for a static export")
    ap.add_argument("--rest-pose", action="store_true",
                    help="export the skinned model in its rest pose (no "
                         "animation file needed — the glTF analog of the "
                         "addon's plain Export SMIL Model)")
    ap.add_argument("--betas", default=None,
                    help="comma-separated shape coefficients for --rest-pose")
    ap.add_argument("--out", required=True, help="output .glb path")
    ap.add_argument("--mode", default="auto", choices=["auto", "hierarchy", "flat"],
                    help="skeleton layout (flat is exact under per-joint scales)")
    ap.add_argument("--static-shape", action="store_true",
                    help="bake clip-averaged betas even if betas_per_frame exists")
    ap.add_argument("--no-joint-scales", action="store_true",
                    help="ignore log_beta_scales (addon apply_joint_scales=False)")
    ap.add_argument("--propagate-scaling", action="store_true",
                    help="FK propagates parent scales instead of cancelling")
    ap.add_argument("--fps", type=float, default=None, help="override clip fps")
    ap.add_argument("--align-symmetry", action="store_true",
                    help="symmetry-align the template on load (CLIs default to "
                         "the reference's ignore_sym behavior, config.py:52)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from smilify_tpu_torch._device import resolve_device
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.utils.animation_export import load_animation
    from smilify_tpu_torch.utils.gltf_export import export_animation_gltf

    dev = resolve_device(args.device)
    spec = load_model_spec(args.model, align_symmetry=args.align_symmetry, device=dev)
    if args.rest_pose:
        import numpy as np

        betas = (np.asarray([float(v) for v in args.betas.split(",")], np.float32)
                 if args.betas else np.zeros(spec.n_betas, np.float32))
        data = {
            "poses": np.zeros((1, 3 * spec.n_joints), np.float32),
            "trans": np.zeros((1, 3), np.float32),
            "betas": betas,
            "mocap_framerate": np.float32(1.0),
        }
        sidecar = {}
    elif args.animation is None:
        ap.error("--animation is required unless --rest-pose is given")
    else:
        data, sidecar = load_animation(args.animation)
    out = export_animation_gltf(
        spec,
        data,
        args.out,
        sidecar=sidecar,
        mode=args.mode,
        apply_joint_scales=not args.no_joint_scales,
        static_shape=args.static_shape,
        propagate_scaling=args.propagate_scaling,
        fps=args.fps,
    )
    print(f"glTF → {out}")
    return out


if __name__ == "__main__":
    main()
