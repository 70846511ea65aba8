"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the raster kernels from ``smilify_tpu_torch/csrc`` with ``nvcc``,
holds each kernel to its plain PyTorch version on the card, drives the
port's main path (the fitter, ``SmalFitter``) in both raster modes at the
full width of the SMILy_STICK model (a procedural spec of the same width:
V=3025, F=5832, J=55, B=5, made from a seed) at 512², checks the results,
and profiles a few fitter steps. Imports nothing of JAX or of the JAX
package ``smilify_tpu``.

Output: progress lines, then (before the last line) one ``{"kernels": [...]}``
JSON line and the card's ``name, power limit``, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero without that last line; so does a machine
without CUDA, and a directory that holds this script without the package.

Bounds (``bound_ms``): the larger of the bytes each kernel must move (inputs
read once, outputs written once) over 3.35 TB/s and its FP32 operations over
67 TFLOP/s (published H100 SXM peaks at 700 W). Operations = the (pixel,
face) pairs this run's data made each kernel evaluate (counted by the
kernels themselves, after the cull and the saturation early-out) times the
FP32 operations per pair counted from ``csrc/raster.cuh`` (an FMA counts 2;
exp and log1p count 1 each).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SIZE = (512, 512)
SIGMA = 1e-4
STICK_WIDTH = dict(V_side=55, J=55, B=5)   # V=3025, F=5832, J=55 (SMILy_STICK: 3020, 6019, 55)
ITERS_PER_STAGE = 10
ALPHA_ATOL = 1e-5                          # tests/test_torch_raster.py
GRAD_ATOL, GRAD_RTOL = 5e-3, 1e-3          # tests/test_torch_raster.py
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
FWD_OPS_PER_PAIR = 76    # fwd_term: 3 edges × 18, min/inside/sign 14, softplus 5, ×valid, +=
BWD_OPS_PER_PAIR = 93    # bwd_term: signed distance 68, sigmoid 4, weight 5, edge pick 5, 6 grads 11


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def scene(spec, n_frames, dev):
    """Triangles of ``spec`` posed as ``synthetic_fit_data`` poses them:
    (tri_xy (N, F, 3, 2), tri_z (N, F, 3), valid (N, F))."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.fitter.fitter import synthetic_poses
    from smilify_tpu_torch.render.cameras import default_camera

    betas, theta, trans = (torch.from_numpy(a).to(dev) for a in synthetic_poses(spec, n_frames))
    cam = default_camera(device=dev)
    with torch.no_grad():
        verts = smil_forward(spec, betas, theta).verts + trans[:, None]
        pv = cam.world_to_view(verts)
        ndc = cam.view_to_ndc(pv)
        tri = torch.cat([ndc[..., :2], pv[..., 2:3]], -1)[:, spec.faces]
    valid = torch.any(tri[..., 2] > cam.znear, dim=-1)
    return tri[..., :2].contiguous(), tri[..., 2].contiguous(), valid


def kernel_phase(spec, n_frames, dev, timed):
    """K1-K4 against their plain versions on the card at the main path's
    shapes; returns one record per kernel."""
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW

    H, W = SIZE
    N = n_frames
    T = R._tile_grid(H, W)[2]
    k_sub = math.ceil(R.auto_approx_max_faces(SIZE, device=dev) / R.FACE_GROUP)
    tri, z, valid = scene(spec, N, dev)
    face, mask = R._pack_faces(tri, valid), R._tile_cull_mask(tri, valid, H, W, SIGMA)
    flat = RW._pack_faces_flat(tri, valid)
    idx, cnt = RW._tile_worklists(tri, z, valid, H, W, SIGMA, k_sub)
    work = torch.zeros(N * T, dtype=torch.int32, device=dev)

    # the cotangent of the fitter's silhouette term at stage 2 (w_reproj 1000,
    # mean over H·W pixels, through alpha = 1 − e^−S), with random signs
    S0 = R.exact_fwd(face, mask, H, W, SIGMA)
    u = torch.rand(S0.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    gS = (torch.exp(-S0) * (2 * u - 1) * (1000.0 / (H * W))).contiguous()

    cases = [
        ("exact_fwd", R.exact_fwd, R.exact_fwd_plain, (face, mask, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:162", FWD_OPS_PER_PAIR, (face, mask), True),
        ("exact_bwd", R.exact_bwd, R.exact_bwd_plain, (face, mask, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:267", BWD_OPS_PER_PAIR, (face, mask, gS), False),
        ("worklist_fwd", RW.worklist_fwd, RW.worklist_fwd_plain, (flat, idx, cnt, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:226", FWD_OPS_PER_PAIR, (flat, idx, cnt), True),
        ("worklist_bwd", RW.worklist_bwd, RW.worklist_bwd_plain,
         (flat, idx, cnt, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:252", BWD_OPS_PER_PAIR, (flat, idx, cnt, gS),
         False),
    ]
    records = []
    for name, kernel, plain, args, replaces, ops_per_pair, inputs, is_fwd in cases:
        out = kernel(*args, work=work)
        ref = plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output (N={N})")
        if is_fwd:
            err = float((torch.exp(-ref) - torch.exp(-out)).abs().max())
            ok = err <= ALPHA_ATOL
            check(float(out.max()) > 1.0, f"{name}: the mesh covers no pixel (N={N})")
        else:
            err = float((out - ref).abs().max())
            ok = bool(torch.isclose(out, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL).all())
            check(float(ref.abs().max()) > 0, f"{name}: zero gradient (N={N})")
        check(ok, f"{name}: kernel disagrees with its plain version (N={N}, max abs err {err})")
        pairs = int(work.sum()) * R.FACE_GROUP * R.TILE_PIX
        rec = {"name": name, "route": "cuda", "source": "smilify_tpu_torch/csrc/raster.cu",
               "replaces": replaces, "launches": None, "max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: kernel(*args), reps=20)
            rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
            b_ms, b_by = bound(nbytes(*inputs, out), pairs * ops_per_pair)
            rec.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"  N={N} {name}: max abs err {err:.3g}, pairs {pairs}"
            + (f", {rec['ms']:.4f} ms (plain {rec['plain_ms']:.2f} ms, bound "
               f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})" if timed else ""))
        records.append(rec)
    return records


def kernel_wrappers():
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW

    return {"exact_fwd": R.exact_fwd, "exact_bwd": R.exact_bwd,
            "worklist_fwd": RW.worklist_fwd, "worklist_bwd": RW.worklist_bwd}


def drive_fitter(spec, data, cap, dev):
    """The main path: every stage of ``test_schedule`` through
    ``SmalFitter.run_stage``. Returns (per-stage losses, per-stage seconds,
    the last stage's loss at the start and at the end of the fit, fitter)."""
    from smilify_tpu_torch.fitter.fitter import SmalFitter
    from smilify_tpu_torch.fitter.stages import test_schedule

    fitter = SmalFitter(spec, data, SIZE, approx_max_faces=cap, device=dev)
    schedule = test_schedule(ITERS_PER_STAGE)
    start = fitter.params
    losses, seconds = [], []
    for stage, weights in enumerate(schedule):
        seen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitter.run_stage(stage, weights, chunk=ITERS_PER_STAGE,
                         callback=lambda s, it, loss, objs: seen.append(float(loss)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(seen)
    with torch.no_grad():
        last = [float(fitter._total_loss(p, schedule[-1], fitter.data.visibility)[0])
                for p in (start, fitter.params)]
    return losses, seconds, last, fitter


def silhouette(fitter, cap):
    from smilify_tpu_torch.fitter.fitter import _posed, _project_frames
    from smilify_tpu_torch.render.rasterizer import soft_silhouette

    with torch.no_grad():
        verts, joints, _, _ = _posed(fitter.spec, fitter.params, fitter.allow_limb_scaling)
        ndc, _ = _project_frames(fitter.camera, fitter.params.fov, verts, joints, SIZE)
        return soft_silhouette(ndc, fitter.spec.faces, SIZE, znear=fitter.camera.znear,
                               approx_max_faces=cap)


def iou(a, b):
    a, b = a > 0.5, b > 0.5
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def reference_phase(spec, dev):
    """The port against the repo's own references on a small input: the
    kernel raster against the all-faces reference raster on the card, and one
    fitter loss on the card against the same loss on the CPU (plain
    versions)."""
    from smilify_tpu_torch.fitter.fitter import SmalFitter, synthetic_fit_data
    from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
    from smilify_tpu_torch.render.rasterizer import soft_silhouette

    size = (128, 128)
    tri, z, valid = scene(spec, 2, dev)
    verts = torch.cat([tri, z[..., None]], -1).reshape(2, -1, 3)
    faces = torch.arange(verts.shape[1], device=dev).reshape(-1, 3)
    a_k = soft_silhouette(verts, faces, size)
    a_r = soft_silhouette(verts, faces, size, use_reference=True)
    err = float((a_k - a_r).abs().max())
    log(f"  exact raster vs all-faces reference at 128²: max |Δalpha| {err:.3g}")
    check(err <= 1e-4, f"raster disagrees with the reference raster ({err})")

    data = synthetic_fit_data(spec, 1, size)
    losses = []
    for d in (dev, "cpu"):
        f = SmalFitter(spec, data, size, device=d)
        total, _ = f._total_loss(f.params, OPT_WEIGHTS[2], f.data.visibility)
        losses.append(float(total))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    log(f"  fitter loss at 128²: card {losses[0]!r}, CPU {losses[1]!r} (rel {rel:.3g})")
    check(rel <= 1e-4, "fitter loss on the card disagrees with the CPU")


def profile_phase(spec, data, dev, mode, cap):
    """Device time by operation over 5 steps of stage 2 in one raster mode,
    and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smilify_tpu_torch.fitter.fitter import SmalFitter
    from smilify_tpu_torch.fitter.stages import test_schedule

    steps = 5
    fitter = SmalFitter(spec, data, SIZE, approx_max_faces=cap, device=dev)
    weights = test_schedule(steps)[2]
    fitter.run_stage(2, weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter.run_stage(2, weights)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fitter.run_stage(2, weights)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # kernels, copies and fills; not the ranges the optimizer annotates
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        log("  profile: the profiler recorded no device events")
        return
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / steps
    n_events = sum(n for _, n in by_name.values()) / steps
    log(f"  {mode} step in stage 2: wall {wall_ms:.3f} ms (unprofiled), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall), {n_events:.0f} device "
        f"operations")
    log(f"  device time per step by operation, over {steps} profiled steps:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {us / 1e3 / steps:8.4f} ms  {n / steps:5.0f}x  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    import smilify_tpu_torch

    check(Path(smilify_tpu_torch.__file__).resolve().parent.parent == ROOT,
          f"smilify_tpu_torch imported from {smilify_tpu_torch.__file__}, not beside this script")
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter import synthetic_fit_data
    from smilify_tpu_torch.render import _kernels
    from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    log("[1/5] build")
    t0 = time.perf_counter()
    lib = _kernels.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    spec = toy_model_spec(**STICK_WIDTH, device=dev)
    log(f"  spec: V={spec.n_verts} F={spec.n_faces} J={spec.n_joints} B={spec.n_betas}")

    log("[2/5] kernels against their plain versions at 512²")
    records = kernel_phase(spec, 1, dev, timed=True)
    kernel_phase(spec, 4, dev, timed=False)

    log("[3/5] main path: SmalFitter, 4 stages × 10 steps, 1 frame at 512²")
    data = synthetic_fit_data(spec, 1, SIZE)
    cover = float(data.sil.mean())
    log(f"  target silhouette covers {cover:.4f} of the image")
    check(0.005 < cover < 0.5, "target silhouette coverage out of range")
    cap = auto_approx_max_faces(SIZE, device=dev)
    modes = {"exact": (None, ("exact_fwd", "exact_bwd")),
             "capped": (cap, ("worklist_fwd", "worklist_bwd"))}
    counts, fitters = {}, {}
    for mode, (mode_cap, used) in modes.items():
        drive_fitter(spec, data, mode_cap, dev)          # warm-up (allocator, cuBLAS)
        for fn in kernel_wrappers().values():
            fn.launches = 0
        losses, seconds, last, fitter = drive_fitter(spec, data, mode_cap, dev)
        counts[mode] = {name: fn.launches for name, fn in kernel_wrappers().items()}
        fitters[mode] = fitter
        log(f"  {mode} (approx_max_faces={mode_cap}): launches {counts[mode]}")
        for stage, (ls, s) in enumerate(zip(losses, seconds)):
            log(f"    stage {stage}: loss {ls[0]:.6g} -> {ls[-1]:.6g}, "
                f"{ITERS_PER_STAGE / s:.2f} steps/s")
            check(len(ls) == ITERS_PER_STAGE and all(math.isfinite(v) for v in ls),
                  f"{mode} stage {stage}: non-finite loss")
            # fov's lr of 1 makes the first steps of a stage overshoot: the
            # loss falls below its start within the stage, not monotonically
            check(min(ls[ITERS_PER_STAGE // 2:]) < ls[0], f"{mode} stage {stage}: loss did not fall")
        log(f"    last stage's loss at the start of the fit {last[0]:.6g}, at its end {last[1]:.6g}")
        check(last[1] < 0.5 * last[0], f"{mode}: the fit did not halve the last stage's loss")
        raster_s = sum(seconds[1:])
        log(f"  {mode}: {ITERS_PER_STAGE * 4 / sum(seconds):.2f} steps/s over all 4 stages, "
            f"{ITERS_PER_STAGE * 3 / raster_s:.2f} steps/s over the 3 raster stages")
        for k, n in counts[mode].items():
            check((n > 0) == (k in used), f"{mode}: kernel {k} launched {n} times")
        verts, _ = fitter.forward_frames()
        check(bool(torch.isfinite(verts).all()), f"{mode}: non-finite fitted vertices")
    for rec in records:
        mode = "exact" if rec["name"].startswith("exact") else "capped"
        rec["launches"] = counts[mode][rec["name"]]

    for mode, fitter in fitters.items():
        log(f"  {mode} fit: IoU with the target {iou(silhouette(fitter, None), data.sil):.4f}")
    f = fitters["exact"]
    iou_cap = iou(silhouette(f, cap), silhouette(f, None))
    log(f"  IoU of capped (cap {cap}) against exact on the exact fit's pose: {iou_cap:.4f}")
    check(iou_cap >= 0.99, "capped raster IoU against exact below 0.99")

    log("[4/5] references")
    reference_phase(spec, dev)

    log("[5/5] where the time goes")
    for mode, (mode_cap, _) in modes.items():
        profile_phase(spec, data, dev, mode, mode_cap)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
