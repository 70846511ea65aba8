"""Headline benchmark of the port: fitter iterations per second on one card
(port of the root ``bench.py``).

    python -m smilify_tpu_torch.bench [--model PKL] [--device cuda]

Times the full fitter step (SMIL forward, joint projection, soft-silhouette
raster forward and backward in the CUDA kernels, loss suite, temporal terms,
Adam) on one 512×512 frame with the stage-1 weights (``OPT_WEIGHTS[1]``), on
a reachable target: a perturbed pose of the model rendered to a silhouette
plus its projected joints (``synthetic_fit_data``). Adam is the JAX bench's
``optax.adam(lr, b1=0.5)``: β=(0.5, 0.999) over every parameter at the
stage's lr, with no separate fov group and no freeze (unlike ``SmalFitter``).

Two raster modes: the fitter CLI's default cap ``auto_approx_max_faces``
(800 faces a tile at 512² on the card; the exact raster elsewhere) and the
exact raster. Two ways to drive the step, the JAX package's two dispatch
modes in eager PyTorch: "single dispatch" is one step followed by a
read-back of its loss; "chained 10" is 10 steps back to back with one
read-back of their losses, the meaning of ``SmalFitter.run_stage(chunk=10)``.
Each rate is the slope of two chain lengths (``tools/_timing.timeit_chain``);
each phase starts from fresh parameters.

The model is the pickle given by ``--model``; without one, the procedural
spec of SMILy_STICK's width that ``chip_smoke.py`` uses,
``toy_model_spec(55, 55, 5)`` (V=3025, F=5832, J=55, made from a seed).

Prints one JSON line with the JAX bench's keys, less its TPU-era baseline
caveats: ``value`` is the chained-10 rate in the default raster mode.
``vs_baseline`` is null: the reference implementation's throughput has not
been measured beside the card. Added: the exact chained-10 rate, the model,
the device, and the card's name and power limit as ``nvidia-smi`` reports
them.
"""

from __future__ import annotations

import argparse
import json

import torch

from smilify_tpu_torch._device import card_line, resolve_device, set_float32_matmul
from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
from smilify_tpu_torch.fitter.fitter import (
    FitParams,
    forward_losses,
    init_params,
    synthetic_fit_data,
    temporal_losses,
)
from smilify_tpu_torch.fitter.priors import (
    default_limit_prior,
    default_pose_prior,
    shape_prior_from_spec,
)
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
from smilify_tpu_torch.render.cameras import default_camera
from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces
from smilify_tpu_torch.tools._timing import timeit_chain

STICK_WIDTH = (55, 55, 5)   # toy_model_spec(V_side, J, B): V=3025, F=5832, J=55
IMAGE_SIZE = (512, 512)
N_FRAMES = 1
WARMUP = 3
ITERS = 30
CHUNK = 10


def load_spec(model=None, device="cuda"):
    """(spec, description): the pickle at ``model``, else the STICK-width toy spec."""
    if model:
        spec = load_model_spec(model, align_symmetry=False, device=device)
        name = model
    else:
        spec = toy_model_spec(*STICK_WIDTH, device=device)
        name = "toy_model_spec({}, {}, {})".format(*STICK_WIDTH)
    return spec, f"{name} (V={spec.n_verts}, F={spec.n_faces}, J={spec.n_joints})"


def fit_step(spec, data, weights, image_size, approx_max_faces=None):
    """Fresh parameters and the bench's step on them: ``(params, step)``,
    where ``params`` is a :class:`FitParams` of leaf tensors and ``step()``
    takes one Adam step in place and returns the step's loss (on the
    device, not read back)."""
    sp = shape_prior_from_spec(spec)
    pp = default_pose_prior(spec)
    lp = default_limit_prior(spec)
    p0 = init_params(spec, int(data.joints.shape[0]), sp)
    params = FitParams(**{k: getattr(p0, k).clone().requires_grad_(True)
                          for k in FitParams.fields()})
    leaves = [getattr(params, k) for k in FitParams.fields()]
    opt = torch.optim.Adam(leaves, lr=weights.lr, betas=(0.5, 0.999), eps=1e-8)
    camera = default_camera(device=spec.device)

    def step():
        opt.zero_grad(set_to_none=True)
        total, _ = forward_losses(spec, params, data, weights, pp, lp, sp, image_size,
                                  approx_max_faces=approx_max_faces, camera=camera)
        tj, tg, tt = temporal_losses(params, weights.w_temp)
        loss = total + tj + tg + tt
        loss.backward()
        for leaf in leaves:
            # optax updates every parameter's moments; torch.optim skips a None grad
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        opt.step()
        return loss.detach()

    return params, step


def single_dispatch(step):
    """Chain link of the single-dispatch mode: one step, its loss read back."""
    def chain(state):
        float(step())
        return state
    return chain


def chained(step, chunk=CHUNK):
    """Chain link of the chained mode: ``chunk`` steps, their losses read back once."""
    def chain(state):
        torch.stack([step() for _ in range(chunk)]).cpu()
        return state
    return chain


def time_modes(spec, data, weights, image_size, approx_max_faces, repeats=3, target_s=1.0):
    """(single-dispatch, chained-10) iterations per second of the bench's
    step in one raster mode, each phase from fresh parameters."""
    params, step = fit_step(spec, data, weights, image_size, approx_max_faces)
    single = 1.0 / timeit_chain(single_dispatch(step), params, n1=ITERS // 3, n2=ITERS,
                                warmup=WARMUP, repeats=repeats, target_s=target_s)
    params, step = fit_step(spec, data, weights, image_size, approx_max_faces)
    chain = CHUNK / timeit_chain(chained(step), params, n1=1, n2=4, warmup=1,
                                 repeats=repeats, target_s=target_s)
    return single, chain


def run(spec, model_name, image_size=IMAGE_SIZE, repeats=3, target_s=1.0) -> dict:
    """The bench's result on ``spec`` (on its device), as a dict."""
    H, W = image_size
    data = synthetic_fit_data(spec, N_FRAMES, image_size)
    weights = OPT_WEIGHTS[1]   # the full-loss stage
    cap = auto_approx_max_faces(image_size, device=spec.device)
    single, chain = time_modes(spec, data, weights, image_size, cap, repeats, target_s)
    exact_single, exact_chain = (
        time_modes(spec, data, weights, image_size, None, repeats, target_s)
        if cap is not None else (single, chain))
    dev = spec.device
    return {
        "metric": "smal_fitter_opt_iters_per_sec_per_chip",
        "value": chain,
        "unit": f"iters/sec ({H}x{W}, F={spec.n_faces}, sil+kp+priors, 1 frame, rendered-GT "
                f"fit target, {CHUNK} steps back to back per loss read-back)",
        "vs_baseline": None,
        "single_dispatch_iters_per_sec": single,
        "raster_mode": "exact" if cap is None else f"worklist_cap_{cap} (CLI default)",
        "exact_single_dispatch_iters_per_sec": exact_single,
        "exact_chained10_iters_per_sec": exact_chain,
        "model": model_name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "card": card_line() if dev.type == "cuda" else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="model pickle (default: the STICK-width toy spec)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_float32_matmul(dev)
    spec, name = load_spec(args.model, dev)
    print(json.dumps(run(spec, name)), flush=True)


if __name__ == "__main__":
    main()
