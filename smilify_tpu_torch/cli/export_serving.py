"""Export a trained checkpoint as a serving artifact (port of
``smilify_tpu/cli/export_serving.py``).

One file holds one ``torch.export`` program a device with the weights; a
serving host loads it with :func:`smilify_tpu_torch.serve.load_serving_artifact`
(torch and that module only: no model code, no config system). See
``smilify_tpu_torch/serve.py``.

Usage:
  python -m smilify_tpu_torch.cli.export_serving --checkpoint runs/sv/final_model \\
      --output sv_model.pt2z [--batch 8] [--platforms cuda,cpu] [--shard-data] [--verify]

``--batch 0`` (default) exports a symbolic batch (any batch size at serve
time); a fixed ``--batch N`` pins it. ``--verify`` loads the artifact and
holds it to the live model on a random batch: it fails above 1e-4.
"""

from __future__ import annotations

import argparse

VERIFY_ATOL = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser(description="export a serving artifact")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--batch", type=int, default=0, help="batch size (0 = symbolic/any)")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices, one program each")
    ap.add_argument("--shard-data", action="store_true",
                    help="replicate the program over every visible card and split each batch "
                         "over them (fixed --batch divisible by the card count)")
    ap.add_argument("--verify", action="store_true",
                    help="load the artifact and compare it against the live model")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from smilify_tpu_torch.serve import export_serving_artifact

    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    meta = export_serving_artifact(args.checkpoint, args.output, batch_size=args.batch,
                                   platforms=platforms, shard_data=args.shard_data)
    sharded = f", sharded over {meta['n_devices']} card(s)" if meta["data_sharded"] else ""
    print(f"exported {meta['mode']} model ({meta['backbone']}, res {meta['input_resolution']}, "
          f"batch {meta['batch_size']}, platforms {','.join(meta['platforms'])}{sharded}) "
          f"→ {args.output} ({meta['artifact_bytes'] / 1e6:.1f} MB)")
    if not args.verify:
        return meta

    from smilify_tpu_torch.cli.run_inference import load_model_from_checkpoint
    from smilify_tpu_torch.serve import build_predict_fn, load_serving_artifact

    # the card's program where it was exported, else the first one named
    served_model = load_serving_artifact(args.output,
                                         "cuda" if "cuda" in platforms else platforms[0])
    dev = served_model.devices[0]
    model, cfg, rcfg, spec, _ = load_model_from_checkpoint(args.checkpoint, device=dev)
    is_mv = cfg.mode == "multi_view"
    res = cfg.model.input_resolution or 224
    B = args.batch or 2
    rng = np.random.RandomState(0)
    if is_mv:
        V = rcfg.max_views
        inputs = (torch.from_numpy(rng.rand(B, V, res, res, 3).astype(np.float32)),
                  torch.ones((B, V), dtype=torch.bool), torch.zeros((B, V), dtype=torch.int32))
    else:
        inputs = (torch.from_numpy(rng.rand(B, res, res, 3).astype(np.float32)),)
    with torch.no_grad():
        live = build_predict_fn(model, rcfg, spec, is_mv)(*(a.to(dev) for a in inputs))
    served = served_model(*inputs)
    worst = max(float(torch.max(torch.abs(served[k].float() - live[k].float()))) for k in live)
    print(f"verify: {len(live)} outputs, max |artifact - live| = {worst:.3e}")
    if worst > VERIFY_ATOL:
        raise SystemExit(f"verification FAILED (deviation > {VERIFY_ATOL})")
    meta["verify_max_abs"] = worst
    return meta


if __name__ == "__main__":
    main()
