"""3D mesh-registration CLI (port of ``smilify_tpu/cli/optimise_3d.py``; the
reference ``python -m fitter_3d.optimise``, fitter_3d/optimise.py:183-325).

YAML-configured stages fit the SMIL template to a directory of target ``.obj``
scans, optionally split into batches; per-batch results are saved as
``.npz`` with its two loss plots (``utils/plotting.py``) and batch results
merged.

Usage:
  python -m smilify_tpu_torch.cli.optimise_3d --model <pkl> --mesh_dir <dir> \\
      --yaml_src cfg.yaml [--results_dir out] [--batch_size 100] [--device cuda]

The YAML file is read by the port's own reader (``utils/yaml_io.py``: what
``yaml.safe_load`` returns for the stage files, without PyYAML).

``--shard`` cuts each batch's scans over the ranks of the process group
(launch under torchrun; :class:`~smilify_tpu_torch.fitter.fitter3d.ShardedStageManager`):
a batch is padded to a multiple of the rank count by repeating scans, the
padding dropped from the npz, and rank 0 writes. ``--multihost`` starts the
process group from the flag (torchrun's environment starts it anyway).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List

import numpy as np


def load_stages_from_yaml(path: str):
    """Parse the reference YAML schema (stages.*.scheme/nits/lr/loss_weights
    w_<name>/custom_lrs, plus optional top-level args overrides)."""
    from smilify_tpu_torch.fitter.fitter3d import Stage
    from smilify_tpu_torch.utils.yaml_io import safe_load

    with open(path) as f:
        cfg = safe_load(f)

    stages = []
    for name, sc in cfg.get("stages", {}).items():
        lw = {
            k[2:]: float(v) for k, v in (sc.get("loss_weights") or {}).items() if k.startswith("w_")
        }
        stages.append(
            Stage(
                name=name,
                scheme=sc.get("scheme", "default"),
                n_its=int(sc.get("nits", 100)),
                lr=float(sc.get("lr", 1e-3)),
                loss_weights=lw or None,
                custom_lrs=sc.get("custom_lrs") or {},
            )
        )
    return stages, cfg.get("args", {}) or {}


def combine_stage_results(results_dir: str, stage_name: str, n_batches: int):
    """Merge per-batch npz files into one (reference optimise.py:77-110)."""
    parts = [
        np.load(os.path.join(results_dir, f"batch_{b}", f"{stage_name}.npz"), allow_pickle=True)
        for b in range(n_batches)
    ]
    merged = {}
    for key in parts[0].files:
        vals = [p[key] for p in parts]
        if key == "faces":
            merged[key] = vals[0]
        elif vals[0].ndim == 0:
            merged[key] = vals[0]
        else:
            merged[key] = np.concatenate(vals, axis=0)
    out = os.path.join(results_dir, f"{stage_name}.npz")
    np.savez(out, **merged)
    return out


def register(spec, obj_paths: List[str], stages, results_dir: str, batch_size: int = 100,
             num_samples: int = 3000, chunk: int = 10, callback=None, shard: bool = False):
    """The CLI's body: fit ``spec`` (on its device) to the ``.obj`` scans in
    batches of ``batch_size`` (-1 = all at once) through ``stages``; saves
    ``<results_dir>/batch_<b>/<last stage>.npz`` per batch and merges them
    when there are several. ``shard``: each batch's scans over the ranks of
    the process group (every rank calls this; rank 0 writes). Returns [the
    StageManager of each batch]."""
    from smilify_tpu_torch.fitter.fitter3d import (
        ShardedStageManager,
        StageManager,
        pad_target_meshes,
    )
    from smilify_tpu_torch.train.multihost import is_primary, process_count
    from smilify_tpu_torch.utils.export import load_obj

    os.makedirs(results_dir, exist_ok=True)
    bs = batch_size if batch_size > 0 else len(obj_paths)
    batches = [obj_paths[i : i + bs] for i in range(0, len(obj_paths), bs)]

    final_stage = stages[-1].name if stages else "final"
    managers = []
    for b, batch_paths in enumerate(batches):
        meshes, names = [], []
        for p in batch_paths:
            meshes.append(load_obj(p))
            names.append(os.path.splitext(os.path.basename(p))[0])
        n_real = len(meshes)
        if shard:
            while len(meshes) % process_count():   # pad by cycling; dropped before export
                i = len(meshes) % n_real
                meshes.append(meshes[i])
                names.append(f"_pad_{names[i]}")
        targets = pad_target_meshes(meshes, names, device=spec.device)
        mgr = ShardedStageManager(spec, targets) if shard else StageManager(spec, targets)
        for st in stages:
            st.num_samples = num_samples
            st.loss_history = []
            mgr.add_stage(st)

        def cb(stage_name, it, loss, objs, b=b):
            if it % 50 == 0:
                print(f"  [batch {b}] {stage_name} it {it:4d} loss {loss:.5f}")
            if callback:
                callback(b, stage_name, it, loss, objs)

        mgr.run(callback=cb, chunk=chunk)
        out_dir = os.path.join(results_dir, f"batch_{b}")
        if shard:   # a collective: every rank gathers, rank 0 writes
            out = mgr.save_npz(out_dir, final_stage, keep=n_real)
        elif is_primary():
            out = mgr.save_npz(out_dir, final_stage)
        if is_primary():
            mgr.plot_losses(out_dir)
            mgr.plot_loss_components(out_dir)
            print(f"batch {b}: saved {out}")
        managers.append(mgr)

    if len(batches) > 1 and is_primary():
        merged = combine_stage_results(results_dir, final_stage, len(batches))
        print(f"merged → {merged}")
    return managers


def main(argv=None):
    ap = argparse.ArgumentParser(description="SMIL → target-mesh 3D registration")
    ap.add_argument("--model", required=True)
    ap.add_argument("--mesh_dir", required=True)
    ap.add_argument("--yaml_src", required=True)
    ap.add_argument("--results_dir", default="fit3d_results")
    ap.add_argument("--batch_size", type=int, default=100,
                    help="targets per optimization batch (-1 = all at once)")
    ap.add_argument("--num_samples", type=int, default=3000)
    ap.add_argument("--iter-chunk", type=int, default=10,
                    help="optimization steps run back to back between loss read-backs "
                         "(1 = every step)")
    ap.add_argument("--shard", action="store_true",
                    help="cut each batch's scans over the ranks of the process group "
                         "(launch under torchrun; a batch is padded to a multiple of the "
                         "rank count by repeating scans, the repeats dropped from the npz)")
    ap.add_argument("--multihost", action="store_true",
                    help="start the process group (torchrun's or SLURM's environment starts "
                         "it anyway); npz and plot writes are gated to rank 0")
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from smilify_tpu_torch._device import set_float32_matmul
    from smilify_tpu_torch.cli.optimize_to_joints import setup_device

    dev = setup_device(args)
    set_float32_matmul(dev)

    from smilify_tpu_torch.core.spec import load_model_spec

    stages, yaml_args = load_stages_from_yaml(args.yaml_src)
    results_dir = yaml_args.get("results_dir", args.results_dir)
    spec = load_model_spec(args.model, align_symmetry=False, device=dev)

    obj_paths = sorted(glob.glob(os.path.join(args.mesh_dir, "*.obj")))
    if not obj_paths:
        raise SystemExit(f"no .obj files in {args.mesh_dir}")
    print(f"{len(obj_paths)} target meshes, {len(stages)} stages")
    register(spec, obj_paths, stages, results_dir, args.batch_size, args.num_samples,
             args.iter_chunk, shard=args.shard)
    return results_dir


if __name__ == "__main__":
    main()
