"""The multi-view regressor's training as ``cli/train_multiview.py`` builds
it: ``TrainingConfig`` in ``multi_view`` mode (the configuration's
``training_config``, SMILify's schema, over the port's defaults) →
``regressor_config`` → ``MultiViewSMILRegressor``, the apply and loss
functions of ``train/multiview_setup.py`` at the epoch-0 loss weights,
``build_optimizer`` (AdamW, the global-norm clip, the backbone's group at
its multiplier, the non-finite skip) and ``make_train_step``, fed by
``DeviceDataCache.batch`` with seeded shuffles of the cache, one step
after another, on one card.

Parameters: ``check_steps``, ``warmup_steps``, ``trace_steps`` and the
traffic's (``inputs_mv.py``): ``views_present`` ([views, share] pairs),
``visible`` (a joint's probability in a present view), ``fov_deg``,
``distance`` and ``elevation_rad`` (the camera rig's ranges). The batch is
the configuration's ``training.batch_size`` (frames); the rate counts view
images, present or masked, of every step enqueued in the window over the
seconds until the card has finished them.

Set-up draws the frames and the weights, fills the cache, builds the
model, optimizer and step, takes the first ``check_steps`` steps (AdamW's
first moment read after the first) and ``warmup_steps`` more, then hands
the same step to the window. After the window the reference computes its
steps on the same batches and the training rule compares them, with
:func:`backbone_grad_spread` beside its numbers; :func:`head_out_gap`
compares what runs after the ViT alone, the program's and the reference's
from the program's own ViT output on the first batch, before the first
step.

``calibrate.py`` takes no new driver, so this file carries the controls
(:func:`control_numbers`: the ViT in fp8 and the rest in TF32, or the ViT
in bfloat16 and only the rest in TF32) and the readings' command:

    python -m portbench.drivers.multiview_train [--workload NAME] [--sound SEED ...]
        [--control SEED ...] [--control-head SEED ...] [--faults SEED ...] [--out FILE]"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from portbench import faults, harness, inputs, inputs_mv, program, trace, work, work_mv
from portbench.drivers.regressor_train import first_steps, fp8
from portbench.reference import multiview as ref_mv


def training_config(cfg: dict):
    """The port's ``TrainingConfig`` of the configuration's overrides."""
    from smilify_tpu_torch.train.config import config_from_dict

    return config_from_dict(cfg["training_config"]).validate()


def check_widths(rcfg, cfg: dict) -> None:
    """The program's resolved config against the widths the reference
    reads (a shape that differs fails the weights' strict load instead)."""
    h, f = cfg["head"], cfg["fusion"]
    got = (rcfg.decoder_dim, rcfg.decoder_depth, rcfg.decoder_heads, rcfg.decoder_mlp_dim,
           rcfg.ief_iters, rcfg.fusion_heads, rcfg.fusion_layers, rcfg.max_views,
           rcfg.num_canonical_cameras)
    want = (h["dim"], h["depth"], h["heads"], h["mlp"], h["iters"], f["heads"], f["layers"],
            cfg["views"], cfg["canonical_cameras"])
    if got != want:
        raise ValueError(f"training_config resolves to {got}, the widths say {want}")


def build_program(r: harness.Run, inp: dict):
    """(model, optimizer, step, cache, batch, apply function) of the port's
    multi-view trainer."""
    from smilify_tpu_torch.cli.train_regressor import joint_importance_on
    from smilify_tpu_torch.models.multiview import MultiViewSMILRegressor
    from smilify_tpu_torch.train import multiview_setup, trainer
    from smilify_tpu_torch.train.config import resolve_ignored_joint_indices

    cfg, dev = r.config, torch.device(r.device)
    tc = training_config(cfg)
    spec = program.spec(inp["mesh_np"], r.device)
    rcfg = tc.regressor_config(spec)
    check_widths(rcfg, cfg)
    res = cfg["image_size"]
    with dev:
        model = MultiViewSMILRegressor(rcfg, img_size=res)
    model.load_state_dict(inp["weights"], strict=True)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.train()
    apply_fn = multiview_setup.make_multiview_apply_fn(rcfg, spec, (res, res))
    loss_fn = multiview_setup.make_multiview_loss_fn(
        spec, rcfg, tc.get_loss_weights_for_epoch(0), (res, res),
        joint_importance=joint_importance_on(tc, spec, dev),
        ignored_joint_indices=resolve_ignored_joint_indices(tc, spec.joint_names))
    opt = trainer.build_optimizer(tc, tc.get_learning_rate_for_epoch(0), backbone_frozen=False,
                                  model=model)
    step = trainer.make_train_step(model, apply_fn, loss_fn, opt,
                                   accum_steps=tc.training.gradient_accumulation_steps)
    cache = trainer.DeviceDataCache(inp["frames"], r.device)
    return model, opt, step, cache, tc.training.batch_size, apply_fn


def backbone_grad_spread(prog: dict, ref: dict) -> float:
    """How far the backbone's first gradients stray from one common scale:
    over the backbone's leaves whose reference gradient is at least the
    median leaf's, each leaf's norm ratio, program over reference, against
    the median of those ratios; the median of |ratio / median − 1|. A joint
    seen in one view leaves the DLT's damped normal equations
    ill-conditioned, which moves the loss and, through the clip, every
    leaf's gradient by one common factor, the same in a sound run and in a
    lower precision; the backbone's own precision moves its leaves apart."""
    g_med = statistics.median(ref["grad"].values())
    keys = [k for k, g in ref["grad"].items() if k.startswith("backbone.") and g >= g_med]
    ratios = [prog["grad"][k] / ref["grad"][k] for k in keys]
    mid = statistics.median(ratios)
    if not mid > 0:
        return float("inf")
    return statistics.median(abs(r / mid - 1.0) for r in ratios)


def check_numbers(prog: dict, ref: dict) -> dict:
    """The training rule's numbers and :func:`backbone_grad_spread`."""
    return dict(harness.training_numbers(prog, ref),
                backbone_grad_spread=backbone_grad_spread(prog, ref))


# the decoded predictions :func:`head_out_gap` compares
PREDS = ("global_rot", "joint_rot", "betas", "trans", "view_fov", "view_cam_rot", "view_cam_trans")


def program_head_outputs(model, apply_fn, batch) -> dict:
    """The program's decoded predictions of ``batch`` at its weights as they
    stand, through the apply function its step runs, and the ViT's output
    they came from, read by a forward hook that leaves it as it is."""
    feats = []
    hook = model.backbone.register_forward_hook(lambda mod, args, out: feats.append(out))
    try:
        with torch.no_grad():
            preds = apply_fn(model, batch, True)
    finally:
        hook.remove()
    n = batch["images"].shape[0] * batch["images"].shape[1]
    return {"preds": {k: preds[k].float() for k in PREDS},
            "pooled": torch.cat([f.pooled for f in feats])[:n].float(),
            "tokens": torch.cat([f.tokens for f in feats])[:n].float()}


def head_out_gap(preds: dict, ref: dict) -> float:
    """What runs after the ViT, held alone: the worst group's gap, by norm
    and relative to the reference's, between two sets of decoded predictions
    from the same ViT output (the fusion, the IEF decoder, the camera head
    and the decode, forward, with no loss and no DLT in between)."""
    norm = torch.linalg.vector_norm
    return max(float(norm(preds[k] - ref[k]) / norm(ref[k]).clamp_min(1e-30)) for k in PREDS)


def reference_heads(r: harness.Run, inp: dict, idx, pooled, tokens) -> dict:
    """The reference's decoded predictions of the samples ``idx`` from the
    given ViT output."""
    cfg = r.config
    with torch.no_grad():
        return ref_mv.from_features(inp["weights"], pooled, tokens,
                                    inp["frames"].batch(idx, r.device), cfg,
                                    cfg["model"]["J"], cfg["model"]["B"])


def bf16(f):
    """``f`` on its operands cast to bfloat16, its result back in float32,
    as autocast runs a linear layer or a convolution."""
    return lambda x, w, b, **kw: f(x.to(torch.bfloat16), w.to(torch.bfloat16),
                                   None if b is None else b.to(torch.bfloat16), **kw).float()


def vit_precision(lower: str | None):
    """(linear, conv2d) of the reference's ViT: float32 (``None``), fp8
    e4m3 (``"vit"``) or bfloat16, as the program runs it (``"head"``)."""
    if lower == "vit":
        return (lambda x, w, b: F.linear(fp8(x), fp8(w), b),
                lambda x, w, b, **kw: F.conv2d(fp8(x), fp8(w), b, **kw))
    if lower == "head":
        return bf16(F.linear), bf16(F.conv2d)
    return F.linear, F.conv2d


def reference_steps(r: harness.Run, inp: dict, order, lower: str | None = None) -> dict:
    """The reference's first steps on the same batches; ``lower`` computes
    them a precision lower: the ViT as :func:`vit_precision` gives it and
    every float32 matmul outside it in TF32."""
    cfg, tcfg = r.config, r.config["training_config"]
    J, B = cfg["model"]["J"], cfg["model"]["B"]
    batches = [inp["frames"].batch(idx, r.device) for idx in order]
    o = tcfg["optimizer"]
    opt = {"lr": o["learning_rate"], "weight_decay": o["weight_decay"],
           "clip": o["gradient_clip_norm"],
           "backbone_lr_multiplier": tcfg["model"]["backbone_lr_multiplier"]}
    lin, conv = vit_precision(lower)
    harness.tf32(lower is not None)
    try:
        losses, first, after = ref_mv.train_steps(inp["weights"], inp["m"], batches, cfg, J, B,
                                                  cfg["loss_weights"], opt, lin, conv)
    finally:
        harness.tf32(False)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    return {"losses": losses, "grad": {k: norm(g) for k, g in first.items()},
            "change": {k: norm(after[k] - inp["weights"][k]) for k in first}}


def run(r: harness.Run) -> harness.Outcome:
    with harness.planted(r):
        return _run(r)


def _run(r: harness.Run) -> harness.Outcome:
    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    harness.tf32(False)
    p, cfg = r.params, r.config
    inp = inputs_mv.multiview_inputs(cfg, p, r.seed, r.device)
    model, opt, step, cache, batch, apply_fn = build_program(r, inp)
    items_per_step = batch * cfg["views"]
    order = inputs.order_iter(cfg["cache_samples"], r.seed, batch)
    checked = list(itertools.islice(order, p["check_steps"]))
    heads = program_head_outputs(model, apply_fn, cache.batch(checked[0]))
    prog = first_steps(model, opt, step, [cache.batch(idx) for idx in checked])
    for idx in itertools.islice(order, p["warmup_steps"]):
        step(cache.batch(idx))
    harness.sync(dev)
    setup_s = time.perf_counter() - r.t0
    steps, seconds = 0, 0.0
    if not r.readings_only:
        t0 = time.perf_counter()
        deadline = t0 + r.seconds
        while True:
            step(cache.batch(next(order)))
            steps += 1
            if time.perf_counter() >= deadline:
                break
        harness.sync(dev)
        seconds = time.perf_counter() - t0
    obs = {"chips": 1, "window": {"seconds": seconds, "steps": steps,
                                  "items": steps * items_per_step},
           "work": {"flops_per_item": 3 * work_mv.view_image_flops(cfg),
                    "peak_flops": work.PEAK_BF16}}
    if r.trace:
        def steps_of(n):
            idx = [next(order) for _ in range(n)]
            return lambda: [step(cache.batch(i)) for i in idx]
        t = trace.record(steps_of(p["trace_steps"]), dev, steps_of(2))
        obs["trace"] = dict(t, steps=p["trace_steps"])
        obs["breakdown"] = trace.breakdown(t)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del model, opt, step, cache
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_numbers(prog, reference_steps(r, inp, checked))
    numbers["head_out_gap"] = head_out_gap(
        heads["preds"], reference_heads(r, inp, checked[0], heads["pooled"], heads["tokens"]))
    rate = {"train_images_per_s": steps * items_per_step / seconds} if seconds else {}
    return harness.Outcome(numbers=numbers, rate=rate, setup_s=setup_s, attempted=steps,
                           failed=0, memory_peak_bytes=peak, count=1, obs=obs)


def control_numbers(r: harness.Run, lower: str = "vit") -> dict:
    """The control's numbers: the reference a precision lower (``lower``, as
    :func:`reference_steps` takes it) against the reference; for
    ``head_out_gap``, what runs after the ViT in TF32 against float32 on
    the same ViT output."""
    inp = inputs_mv.multiview_inputs(r.config, r.params, r.seed, r.device)
    batch = training_config(r.config).training.batch_size
    order = list(itertools.islice(inputs.order_iter(r.config["cache_samples"], r.seed, batch),
                                  r.params["check_steps"]))
    numbers = check_numbers(reference_steps(r, inp, order, lower), reference_steps(r, inp, order))
    images = inp["frames"].batch(order[0], r.device)["images"]
    with torch.no_grad():
        pooled, tokens = ref_mv.vit(inp["weights"], images.reshape((-1,) + images.shape[2:]),
                                    r.config, *vit_precision(lower))
    harness.tf32(True)
    try:
        low = reference_heads(r, inp, order[0], pooled, tokens)
    finally:
        harness.tf32(False)
    numbers["head_out_gap"] = head_out_gap(low, reference_heads(r, inp, order[0], pooled, tokens))
    return numbers


def _unchanged():
    from smilify_tpu_torch.train import trainer as T

    orig = T.Optimizer.step

    def still(self):
        for q in self.params:
            q.grad = torch.zeros_like(q)
        orig(self)
    return faults.patched(T.Optimizer, "step", still)


def _on_batch(change):
    """``make_train_step``'s steps taking ``change(batch)``."""
    from smilify_tpu_torch.train import trainer as T

    orig = T.make_train_step

    def changed(*args, **kw):
        step = orig(*args, **kw)
        return lambda batch: step(change(batch))
    return faults.patched(T, "make_train_step", changed)


def _half_batch():
    return _on_batch(lambda b: {k: v[: len(v) // 2] for k, v in b.items()})


def _mask_ignored():
    return _on_batch(lambda b: dict(b, view_mask=torch.ones_like(b["view_mask"])))


def _no_triangulation():
    from smilify_tpu_torch.train import multiview_setup as M

    orig = M.make_multiview_loss_fn

    def without(spec, rcfg, weights, *args, **kw):
        return orig(spec, rcfg, dict(weights, triangulation_consistency=0.0), *args, **kw)
    return faults.patched(M, "make_multiview_loss_fn", without)


# faults.py: the gradients zeroed before AdamW; the step on the first half
# of each batch's frames; every view slot read as present; the DLT term
# left out of the loss
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "mask_ignored": _mask_ignored,
          "no_triangulation": _no_triangulation}


def main(argv=None) -> None:
    """The readings a cell's limits are set from, on the card: sound runs,
    the control and each fault (``calibrate.py``'s, for this driver)."""
    ap = argparse.ArgumentParser(description="readings for a multi-view cell's limits")
    ap.add_argument("--workload", default="train_mv4_vitl_b32")
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--control-head", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(1)
    jobs = ([("sound", s, None) for s in args.sound] + [("control", s, None) for s in args.control]
            + [("control_head", s, None) for s in args.control_head]
            + [(f, s, f) for s in args.faults for f in FAULTS])
    readings = []
    for kind, seed, fault in jobs:
        t = time.perf_counter()
        r = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False, t0=t, readings_only=True,
                        fault=fault)
        numbers = ({"control": lambda: control_numbers(r, "vit"),
                    "control_head": lambda: control_numbers(r, "head")}.get(kind)
                   or (lambda: run(r).numbers))()
        ok, _ = harness.judge(numbers, cell["limits"])
        row = {"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
               "correct": ok, "seconds": time.perf_counter() - t}
        readings.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(readings, indent=1))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
