"""A sequence fit: ``SmalFitter.run_stage`` over all the cell's frames at
once in a closed loop, as the fitter CLI fits a clip (``--iter-chunk``
steps back to back, their losses read back once a chunk).

Parameters: ``frames``, ``stage`` (a row of the configuration's stage
table), ``approx_max_faces`` (the work-list cap; null for the exact
raster), ``chunk``, ``check_steps`` (the first steps the check compares),
``trace_steps`` (the traced window's steps, a multiple of ``chunk``).

Set-up makes the mesh and the targets, builds the fitter, takes its first
``check_steps`` steps through ``run_stage`` (Adam's state read after the
first by an optimizer hook) and one chunk more, then hands the same fitter
to the window: whole stages, repeated, until the first chunk that ends past
``--seconds``. The rate is the frame-steps of the window's chunks over the
window's seconds. After the window the reference takes the same first
steps from the same inputs, and the training rule compares them."""

from __future__ import annotations

import gc
import time

import torch

from portbench import faults, harness, inputs, program, trace, work
from portbench.reference import fit as ref_fit
from portbench.reference import raster, smil

STAGE_FIELDS = ("w_j2d", "w_reproj", "w_betas", "w_pose", "w_limit", "w_splay", "w_temp",
                "num_iters", "lr")
FIELDS = ref_fit.LEAVES


class WindowClosed(Exception):
    """Raised from the chunk callback once the window's time is up."""


def setup_inputs(r: harness.Run) -> dict:
    cfg, p = r.config, r.params
    mesh_np = inputs.mesh(cfg["model"], r.seed)
    m = smil.to_torch(mesh_np, r.device)
    size = tuple(cfg["image_size"])
    cap = p["approx_max_faces"]
    return {"mesh_np": mesh_np, "m": m, "size": size,
            "k_sub": None if cap is None else -(-cap // raster.GROUP),
            "target": inputs.fit_targets(m, p["frames"], size, r.seed),
            "weights": dict(zip(STAGE_FIELDS, cfg["stages"][p["stage"]]))}


def build_program(r: harness.Run, inp: dict):
    """The port's fitter on the inputs."""
    from smilify_tpu_torch.fitter.fitter import FitData, SmalFitter

    t = inp["target"]
    data = FitData(rgb=None, sil=t["sil"], joints=t["joints"], visibility=t["vis"])
    return SmalFitter(program.spec(inp["mesh_np"], r.device), data, inp["size"],
                      approx_max_faces=r.params["approx_max_faces"], device=r.device)


def stage_weights(inp: dict, **over):
    from smilify_tpu_torch.fitter.stages import StageWeights

    return StageWeights(**dict(inp["weights"], **over))


def first_steps(r: harness.Run, inp: dict, fitter) -> dict:
    """The program's first steps through ``run_stage``: losses, the first
    gradient's norm by leaf (Adam's first moment after one step over
    1 − β1) and the change's norm by leaf."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    grads = {}

    def after_step(opt, args, kwargs):
        if grads:
            return
        for group in opt.param_groups:
            for q in group["params"]:
                m = opt.state.get(q, {}).get("exp_avg")
                grads[q.data_ptr()] = (0.0 if m is None else
                                       float(torch.linalg.vector_norm(m)) / (1 - group["betas"][0]))

    start = {k: getattr(fitter.params, k).clone() for k in FIELDS}
    losses = []
    handle = register_optimizer_step_post_hook(after_step)
    try:
        fitter.run_stage(r.params["stage"], stage_weights(inp, num_iters=r.params["check_steps"]),
                         callback=lambda s, i, loss, objs: losses.append(float(loss)),
                         chunk=r.params["chunk"])
    finally:
        handle.remove()
    end = {k: getattr(fitter.params, k) for k in FIELDS}
    # the fitter's parameters after a stage are views of Adam's leaves
    return {"losses": losses, "grad": {k: grads.get(end[k].data_ptr(), 0.0) for k in FIELDS},
            "change": {k: float(torch.linalg.vector_norm(end[k] - start[k])) for k in FIELDS}}


def reference_steps(r: harness.Run, inp: dict, tf32_on: bool = False) -> dict:
    harness.tf32(tf32_on)
    try:
        losses, first, after, start = ref_fit.run_steps(
            inp["m"], inp["target"], inp["weights"], *inp["size"], inp["k_sub"],
            r.params["check_steps"])
    finally:
        harness.tf32(False)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    return {"losses": losses, "grad": {k: norm(first[k]) for k in FIELDS},
            "change": {k: norm(after[k] - start[k]) for k in FIELDS}}


def window(fitter, sw, stage: int, chunk: int, seconds: float):
    """Whole stages until the first chunk that ends past ``seconds``:
    (steps, seconds)."""
    steps = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def chunk_done(s, it, loss, objs):
        nonlocal steps
        steps += 1
        if steps % chunk == 0 and time.perf_counter() >= deadline:
            raise WindowClosed

    try:
        while True:
            fitter.run_stage(stage, sw, callback=chunk_done, chunk=chunk)
    except WindowClosed:
        pass
    return steps, time.perf_counter() - t0


def raster_work(inp: dict, fitter) -> dict:
    """The pairs the cap admits at the fitter's parameters, and the step's
    least raster seconds and FLOPs."""
    H, W = inp["size"]
    p = {k: getattr(fitter.params, k).detach() for k in FIELDS}
    with torch.no_grad():
        _, ndc, _, _ = ref_fit.frames(inp["m"], p, H, W)
        tri = ndc[:, inp["m"]["faces"]]
        pairs = raster.pairs(tri[..., :2], tri[..., 2], H, W, inp["k_sub"])
    N, (ny, nx) = tri.shape[0], raster.tile_grid(H, W)
    V, F = inp["mesh_np"]["v_template"].shape[0], inp["mesh_np"]["faces"].shape[0]
    J, B = inp["mesh_np"]["parents"].shape[0], inp["mesh_np"]["shapedirs"].shape[0]
    k_sub = inp["k_sub"] or -(-F // raster.GROUP)
    return {"pairs_per_step": pairs,
            "raster_least_s_per_step": work.raster_least_s(pairs, N, F, ny * nx, k_sub),
            "flops_per_step": work.fit_step_flops(N, V, J, B, pairs), "peak_flops": work.PEAK_FP32}


def run(r: harness.Run) -> harness.Outcome:
    with harness.planted(r):
        return _run(r)


def _run(r: harness.Run) -> harness.Outcome:
    p = r.params
    dev = torch.device(r.device)
    harness.tf32(False)
    inp = setup_inputs(r)
    fitter = build_program(r, inp)
    prog = first_steps(r, inp, fitter)
    sw = stage_weights(inp)
    if sw.num_iters % p["chunk"] or p["trace_steps"] % p["chunk"]:
        raise ValueError("the stage's and the traced window's steps must be whole chunks")
    fitter.run_stage(p["stage"], sw._replace(num_iters=p["chunk"]), callback=lambda *a: None,
                     chunk=p["chunk"])
    harness.sync(dev)
    setup_s = time.perf_counter() - r.t0
    steps, seconds = (0, 0.0) if r.readings_only else window(
        fitter, sw, p["stage"], p["chunk"], r.seconds)
    obs = {"chips": 1, "window": {"seconds": seconds, "steps": steps,
                                  "items": steps * p["frames"]}}
    if r.trace:
        def stage(n):
            return lambda: fitter.run_stage(p["stage"], sw._replace(num_iters=n),
                                            callback=lambda *a: None, chunk=p["chunk"])
        obs["trace"] = dict(trace.record(stage(p["trace_steps"]), dev, stage(p["chunk"])),
                            steps=p["trace_steps"])
        obs["breakdown"] = trace.breakdown(obs["trace"])
        obs["work"] = raster_work(inp, fitter)
    elif steps:
        obs["work"] = raster_work(inp, fitter)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del fitter
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = harness.training_numbers(prog, reference_steps(r, inp))
    rate = {"fit_frame_steps_per_s": steps * p["frames"] / seconds} if seconds else {}
    return harness.Outcome(numbers=numbers, rate=rate, setup_s=setup_s, attempted=steps,
                           failed=0, memory_peak_bytes=peak, count=1, obs=obs)


def _unchanged():
    from smilify_tpu_torch.fitter import fitter as F

    def zero(self, leaves):
        for leaf in leaves.values():
            leaf.grad.zero_()
    return faults.patched(F.SmalFitter, "_reduce_grads", zero)


def _half_batch():
    from smilify_tpu_torch.fitter import fitter as F

    orig = F.forward_losses

    def half(spec, params, data, weights, *args, visibility_override=None, **kw):
        n = params.global_rot.shape[0] // 2
        per_frame = ("global_rot", "joint_rot", "trans", "fov")
        p = F.FitParams(**{k: getattr(params, k)[:n] if k in per_frame else getattr(params, k)
                           for k in F.FitParams.fields()})
        d = F.FitData(rgb=None, sil=data.sil[:n], joints=data.joints[:n],
                      visibility=data.visibility[:n])
        vis = None if visibility_override is None else visibility_override[:n]
        return orig(spec, p, d, weights, *args, visibility_override=vis, **kw)
    return faults.patched(F, "forward_losses", half)


# faults.py: the gradients zeroed before each update; the loss over the first half of the frames
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
