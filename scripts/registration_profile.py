"""One-off measurement: 3D registration's step at 8 targets on one NVIDIA GPU,
and which of its operations give a different result from run to run.

    python3 scripts/registration_profile.py [--root DIR] [--deterministic] \\
        [--label NAME] [--out build/registration_profile_NAME.json]

``--root`` imports ``smilify_tpu_torch`` from another checkout (e.g. a
``git archive`` of an earlier commit under ``build/``), so one call can hold
two versions side by side; ``--deterministic`` runs everything under
``torch.use_deterministic_algorithms(True, warn_only=True)``. The workload
is ``chip_smoke.py`` phase 9's: the STICK-width template
(``bench.load_spec``) against 8 posed scans of ``toy_model_spec(75, 55, 5)``
(F=10,952) at 3000 samples a mesh.

It measures:

* config2's step (``tools/bench_all.py::fitter3d_step``) at 8 targets: wall
  ms a step (``timeit_chain``), and under ``torch.profiler`` the device
  busy ms and the device operations a step, with the top operations;
* reproducibility: ``StageManager`` run twice (2 stages of 6 steps, as
  ``chip_smoke.py``'s scale-out check), the two runs' largest parameter
  difference and loss-trajectory difference;
* the sources: at one fixed parameter state and fixed draws, each loss
  term's gradient computed three times (bitwise equal or not, largest
  difference), ``cumsum`` of the template's face areas and the face choice
  it feeds, and, in isolation with a fixed upstream gradient, the backward
  of each index primitive the registration used (``x[..., idx, :]``,
  ``take_along_dim``, ``torch.gather``, ``index_select``) and of
  ``ops/gather.py``'s gathers where the checkout has them.

Prints the card's name and power limit, then one JSON line, which ``--out``
also gets.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 3
PROFILED_STEPS = 5


def device_ops(run):
    """{operation: (device µs, count)} over ``run()`` (kernels, copies, fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize() if torch.cuda.is_available() else None
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return by_name


def repeat_gap(fn):
    """Run ``fn() -> {name: tensor}`` REPEATS times: {name: [bitwise equal to
    the first run, largest |difference|]}."""
    runs = [{k: v.detach().clone() for k, v in fn().items()} for _ in range(REPEATS)]
    return {k: [all(torch.equal(r[k], runs[0][k]) for r in runs[1:]),
                max(float((r[k].double() - runs[0][k].double()).abs().max()) for r in runs[1:])]
            for k in runs[0]}


def step_timing(spec, meshes):
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.tools._timing import timeit_chain

    step, params = bench_all.fitter3d_step(spec, meshes)
    ms = 1e3 * timeit_chain(step, params, n1=10, n2=40, warmup=3, repeats=3, target_s=0.5)
    by_name = device_ops(lambda: [step(params) for _ in range(PROFILED_STEPS)])
    busy = sum(us for us, _ in by_name.values()) / 1e3 / PROFILED_STEPS
    ops = sum(n for _, n in by_name.values()) / PROFILED_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": ms, "device_busy_ms": busy, "device_ops": ops,
            "top": [[name[:90], us / 1e3 / PROFILED_STEPS, n / PROFILED_STEPS]
                    for name, (us, n) in top]}


def two_runs(spec, targets):
    from smilify_tpu_torch.fitter.fitter3d import Fit3DParams, Stage, StageManager

    out = []
    for _ in range(2):
        mgr = StageManager(spec, targets, seed=0)
        mgr.add_stage(Stage("init", "init", n_its=6, lr=0.01))
        mgr.add_stage(Stage("default", "default", n_its=6, lr=0.005))
        traj = []
        mgr.run(callback=lambda s, i, loss, o: traj.append(float(loss)), chunk=3)
        out.append((np.asarray(traj), {k: getattr(mgr.params, k).cpu() for k in Fit3DParams.fields()}))
    (t0, p0), (t1, p1) = out
    return {"bitwise_equal": all(torch.equal(p0[k], p1[k]) for k in p0),
            "max_param_diff": max(float((p0[k] - p1[k]).abs().max()) for k in p0),
            "max_traj_diff": float(np.abs(t0 - t1).max())}


def sources(spec, targets, dev):
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.fitter.fitter3d import (
        fitter3d_forward,
        init_3d_params,
        registration_losses,
        registration_uniforms,
        template_topology,
    )

    B = targets.verts.shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    params = init_3d_params(spec, B)
    for k in params.fields():
        leaf = getattr(params, k)
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=g, device=dev)).requires_grad_(True)
    uniforms = registration_uniforms(B, 3000, torch.Generator(device=dev).manual_seed(6), dev)
    topo = template_topology(spec)
    out = {}
    for term in ("chamfer", "edge", "normal", "laplacian"):
        def grads(term=term):
            for k in params.fields():
                getattr(params, k).grad = None
            total, _ = registration_losses(spec, topo, params, targets, None, {term: 1.0},
                                           uniforms=uniforms)
            total.backward()
            return {k: getattr(params, k).grad for k in params.fields()}

        gap = repeat_gap(grads)
        out[f"grad_{term}"] = [all(v[0] for v in gap.values()), max(v[1] for v in gap.values())]

    with torch.no_grad():
        verts, _ = fitter3d_forward(spec, params)
        faces = spec.faces.long()
        tri = verts[:, faces]                                              # (B, F, 3, 3)
        areas = 0.5 * torch.linalg.norm(torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                                                           tri[..., 2, :] - tri[..., 0, :]), dim=-1)
        probs = areas / areas.sum(-1, keepdim=True)

    def choice():
        cdf = torch.cumsum(probs, dim=-1)
        fidx = torch.searchsorted(cdf, (uniforms[0] * cdf[..., -1:]).contiguous(), right=True)
        return {"cumsum": cdf, "face_choice": fidx}

    for k, v in repeat_gap(choice).items():
        out[k] = v
    out["cumsum_1d"] = repeat_gap(lambda: {"c": torch.cumsum(probs[0], dim=0)})["c"]

    theta = torch.cat([params.global_rot[:, None], params.joint_rot], 1).detach().requires_grad_(True)
    up = torch.randn(verts.shape, generator=g, device=dev)

    def lbs_grad():
        theta.grad = None
        (smil_forward(spec, params.betas.detach(), theta).verts * up).sum().backward()
        return {"theta": theta.grad}

    out["smil_forward_backward"] = repeat_gap(lbs_grad)["theta"]

    x = verts.detach().clone().requires_grad_(True)                        # (B, V, 3) vertices
    xf = torch.randn(tri.shape[:2] + (3,), generator=g, device=dev).requires_grad_(True)  # faces
    edges = topo.edges[0] if isinstance(topo.edges, tuple) else topo.edges
    fidx = choice()["face_choice"]
    prims = {
        "index_edges": (x, edges[:, 0], lambda s, i: s[..., i, :]),
        "take_along_dim_faces": (x, faces[:, 0].expand(B, -1),
                                 lambda s, i: torch.take_along_dim(s, i[..., None], dim=-2)),
        "gather_sampled": (xf, fidx, lambda s, i: torch.gather(s, 1, i[..., None].expand(*i.shape, 3))),
        "index_select_edges": (x, edges[:, 0], lambda s, i: s.index_select(1, i)),
    }
    try:
        from smilify_tpu_torch.ops.gather import gather_rows, take_rows

        prims["gather_rows_table_edges"] = (x, topo.edges, gather_rows)
        prims["gather_rows_tensor_edges"] = (x, edges, gather_rows)
        prims["take_rows_sampled"] = (xf, fidx, take_rows)
    except ImportError:
        pass
    for name, (src, idx, fn) in prims.items():
        gy = torch.randn(fn(src, idx).shape, generator=g, device=dev)

        def bwd(src=src, idx=idx, fn=fn, gy=gy):
            src.grad = None
            (fn(src, idx) * gy).sum().backward()
            return {"g": src.grad}

        out[f"bwd_{name}"] = repeat_gap(bwd)["g"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout to import smilify_tpu_torch from")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--label", default="run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0", help="cpu for a rehearsal at a small size")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import smilify_tpu_torch
    from smilify_tpu_torch._device import card_line
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter3d import pad_target_meshes
    from smilify_tpu_torch.tools.synthetic_data import posed_target_meshes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    spec, _ = load_spec(device=dev)
    scan = toy_model_spec(75, 55, 5, seed=1, device=dev)
    faces = scan.faces.cpu().numpy()
    posed = posed_target_meshes(scan, 8, seed=7)
    targets = pad_target_meshes([(v, faces) for v in posed], device=dev)
    res = {"label": args.label, "package": smilify_tpu_torch.__file__,
           "deterministic_mode": args.deterministic, "card": card_line(),
           "step_8_targets": step_timing(spec, [(v, faces) for v in posed]),
           "two_stage_manager_runs": two_runs(spec, targets),
           "sources": sources(spec, targets, dev)}
    res["seconds"] = time.perf_counter() - t0
    print(res["card"], flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    out = Path(args.out or ROOT / "build" / f"registration_profile_{args.label}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")


if __name__ == "__main__":
    main()
