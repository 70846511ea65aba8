"""The single-view regressor's inference as ``cli/run_inference.py`` runs
it: ``predictor`` (the model in eval mode, ``decode_predictions``), then
``forward_model`` (the SMIL forward), every output read back to the host,
one batch after another from a ``DeviceDataCache`` in seeded shuffles.

Parameters: ``batch``, ``warmup_batches``, ``trace_batches``,
``check_batches`` (the batches of the window the check compares, drawn
from the seed by reservoir sampling over the window).

The rate is the images whose outputs reached the host in the window over
the window's seconds; the window closes at the first batch that ends past
``--seconds``. After it the reference computes the kept batches from the
same images and weights, and the widest gaps of the rotations, the
parameters and the posed mesh, each output against its largest magnitude,
are compared."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import faults, harness, inputs, program, trace, work
from portbench.drivers.regressor_train import fp8_conv, image_flops
from portbench.reference import regressor as ref_reg

OUTPUTS = ("global_rot", "joint_rot", "betas", "trans", "fov", "cam_rot", "cam_trans",
           "verts", "joints")


def build_program(r: harness.Run, inp: dict):
    """``serve(idx) -> {output: numpy array}``: the CLI's path on the
    cache's rows ``idx``."""
    from smilify_tpu_torch.cli.run_inference import predictor
    from smilify_tpu_torch.models.regressor import float32_region, forward_model
    from smilify_tpu_torch.train.trainer import DeviceDataCache

    dev = torch.device(r.device)
    spec = program.spec(inp["mesh_np"], dev)
    rcfg, model = program.regressor(r.config, inp["weights"], dev)
    predict = predictor(model.eval(), rcfg, spec, multiview=False)
    cache = DeviceDataCache(inp["samples"], dev)

    def serve(idx):
        preds = predict(cache.batch(idx))
        with torch.no_grad(), float32_region(dev):
            preds["verts"], preds["joints"] = forward_model(spec, preds,
                                                            use_ue_scaling=rcfg.use_ue_scaling)
        return {k: v.cpu().numpy() for k, v in preds.items()}

    return serve


def reference_outputs(r: harness.Run, inp: dict, idx, lower: bool = False) -> dict:
    """The reference's outputs of rows ``idx``; ``lower`` computes them a
    precision lower (fp8 convolutions, TF32 matmuls)."""
    cfg = r.config
    J, B = cfg["model"]["J"], cfg["model"]["B"]
    images = inp["samples"].batch(idx, r.device)["image"]
    harness.tf32(lower)
    try:
        with torch.no_grad():
            preds = ref_reg.forward(inp["weights"], images, cfg["head"], J, B, train=False,
                                    conv=fp8_conv if lower else torch.nn.functional.conv2d)
            preds["verts"], preds["joints"] = ref_reg.pose(inp["m"], preds)
    finally:
        harness.tf32(False)
    return {k: preds[k].cpu().numpy() for k in OUTPUTS}


GROUPS = {"rot_gap": ("global_rot", "joint_rot", "cam_rot"),
          "param_gap": ("betas", "trans", "fov", "cam_trans"),
          "mesh_gap": ("verts", "joints")}


def answer_gap(prog: list, ref: list) -> dict:
    """Each output's widest gap over the kept rows against the largest
    magnitude of that output in the reference (``gap.<output>``), and the
    widest of each group: rotations (axis-angles compared as rotation
    matrices: near a half turn the axis-angle of one rotation may come out
    with either sign), parameters, the posed mesh and keypoints."""
    def rows(outs, k):
        a = np.concatenate([o[k] for o in outs])
        if k in ("global_rot", "joint_rot"):
            a = ref_reg.axis_angle_to_matrix(torch.as_tensor(a, dtype=torch.float64)).numpy()
        return a.reshape(len(a), -1)

    gaps = {}
    for k in OUTPUTS:
        p, q = rows(prog, k), rows(ref, k)
        gaps[f"gap.{k}"] = float(np.abs(p - q).max() / max(np.abs(q).max(), 1e-6))
    return {**{g: max(gaps[f"gap.{k}"] for k in ks) for g, ks in GROUPS.items()}, **gaps}


def run(r: harness.Run) -> harness.Outcome:
    with harness.planted(r):
        return _run(r)


def _run(r: harness.Run) -> harness.Outcome:
    p, cfg = r.params, r.config
    dev = torch.device(r.device)
    harness.tf32(False)
    inp = inputs.regressor_inputs(cfg, r.seed, dev)
    serve = build_program(r, inp)
    order = inputs.order_iter(cfg["cache_samples"], r.seed, p["batch"])
    for _ in range(p["warmup_batches"]):
        serve(next(order))
    harness.sync(dev)
    setup_s = time.perf_counter() - r.t0
    kept, batches, seconds = [], 0, 0.0
    if r.readings_only:
        kept = [(idx, serve(idx)) for idx in (next(order) for _ in range(p["check_batches"]))]
    else:
        pick = inputs.rng(r.seed, inputs.CHECK)
        t0 = time.perf_counter()
        deadline = t0 + r.seconds
        while True:
            idx = next(order)
            out = serve(idx)
            batches += 1
            # reservoir sampling: every batch of the window equally likely kept
            if len(kept) < p["check_batches"]:
                kept.append((idx, out))
            else:
                j = int(pick.integers(batches))
                if j < p["check_batches"]:
                    kept[j] = (idx, out)
            if time.perf_counter() >= deadline:
                break
        seconds = time.perf_counter() - t0
    obs = {"chips": 1, "window": {"seconds": seconds, "steps": batches,
                                  "items": batches * p["batch"]},
           "work": {"flops_per_item": image_flops(cfg), "peak_flops": work.PEAK_BF16}}
    if r.trace:
        def served(n):
            rows = [next(order) for _ in range(n)]
            return lambda: [serve(idx) for idx in rows]
        obs["trace"] = dict(trace.record(served(p["trace_batches"]), dev, served(2)),
                            steps=p["trace_batches"])
        obs["breakdown"] = trace.breakdown(obs["trace"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = answer_gap([o for _, o in kept], [reference_outputs(r, inp, i) for i, _ in kept])
    rate = {"infer_images_per_s": batches * p["batch"] / seconds} if seconds else {}
    return harness.Outcome(numbers=numbers, rate=rate, setup_s=setup_s, attempted=batches,
                           failed=0, memory_peak_bytes=peak, count=1, obs=obs)


def _altered():
    from smilify_tpu_torch.models import regressor as R

    orig = R.decode_predictions

    def altered(*args, **kw):
        out = orig(*args, **kw)
        out["trans"] = out["trans"].clone()
        out["trans"][0] += 0.1
        return out
    return faults.patched(R, "decode_predictions", altered)


# faults.py: 0.1 added to the first row's predicted trans where it is decoded
FAULTS = {"altered": _altered}
