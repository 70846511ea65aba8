"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``smilify_tpu_torch/csrc`` with ``nvcc`` (one
process per library, started together), holds each kernel to its plain
PyTorch version on the card, drives the port's paths at the full width of
the SMILy_STICK model (a procedural spec of the same width: V=3025, F=5832,
J=55, B=5, made from a seed) and checks their results:

  * the fitter (``SmalFitter``) in both raster modes, 1 frame at 512², with
    a profile of a few steps at 1 and 10 frames;
  * the bench path: ``smilify_tpu_torch.bench`` and ``tools.bench_all``'s
    configs 1, 3, 3b and 3c (N=1 and N=10 frames, both raster modes, the
    FP32 peak probe K5) with short timing windows;
  * the batched fitter against independent fits, a progressive fit, and
    ``tools.bench_corpus`` at 8 clips.

Each path runs with every kernel's launch count set to 0 just before it and
read just after. Imports nothing of JAX or of the JAX package ``smilify_tpu``.

Output: progress lines, then (before the last line) one ``{"kernels": [...]}``
JSON line and the card's ``name, power limit``, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero without that last line; so does a machine
without CUDA, and a directory that holds this script without the package.

Bounds (``bound_ms``): the larger of the bytes each kernel must move (inputs
read once, outputs written once) over 3.35 TB/s and its FP32 operations over
67 TFLOP/s (published H100 SXM peaks at 700 W). Raster operations = the
(pixel, face) pairs this run's data made each kernel evaluate (counted by
the kernels themselves, after the cull and the saturation early-out) times
the FP32 operations per pair (``render/_kernels.py``, counted from
``csrc/raster.cuh``); K5's = 32 streams × 2 × 128 rounds an element.

The backward kernels K2 and K4 run many blocks a tile and add their counts
of evaluated subgroups to ``work``: the count is held, tile by tile, to the
one their plain versions imply, and the blocks launched and the blocks that
found work (both derived from the inputs by the kernels' exit rule) are
logged. Their records add ``ms_10_frames`` and ``bound_ms_10_frames`` (10
frames at 512²).
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SIZE = (512, 512)
SIGMA = 1e-4
ITERS_PER_STAGE = 10
ALPHA_ATOL = 1e-5                          # tests/test_torch_raster.py
GRAD_ATOL, GRAD_RTOL = 5e-3, 1e-3          # tests/test_torch_raster.py
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# K5: the plain version rounds each round once, as the kernel's FMA does, so
# the two agree to a few ulps; one skipped block of 8 rounds moves the output
# by 7.7e-6 relative, and rounding multiply and add apart by 4.1e-6
PEAK_RTOL = 1e-6
PEAK_FFMA = 256            # FFMAs in fma_peak_kernel's SASS: 32 streams × 8 unrolled rounds
PEAK_RATE_RANGE = (0.50, 1.05)   # K5's rate as a share of PEAK_FP32_PER_S
# BatchedFitter against independent fits: tests/test_fitter_batch.py's rtol
# 2e-4; atol 5e-4 where the JAX test has 1e-5. That holds on the CPU, where
# the port is deterministic; on the card the float sums of one 4-frame launch
# run in another order than those of two 2-frame launches (the backward
# kernels' atomicAdd, cuBLAS's kernel for another batch), and Adam turns a
# gradient component that is only rounding noise into a step. Measured on the
# H100: one log_beta_scales entry 1.44e-4 off (1.41e-4 past rtol, the same in
# five repeats), every other field within 1e-5; atol is that worst
# difference with about 3.5× headroom.
BATCH_RTOL, BATCH_ATOL = 2e-4, 5e-4
RASTER_CU = ROOT / "smilify_tpu_torch" / "csrc" / "raster.cu"
# the backward kernels' launch shape: constants of csrc/raster.cu
BWD_SHAPE = ("kBwdThreads", "kK2Slice", "kK4Span")


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


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


def raster_inputs(spec, n_frames, size, dev):
    """The raster kernels' inputs for ``n_frames`` posed frames at ``size``:
    packed faces and cull words (exact), flat faces and work lists capped as
    the fitting CLIs cap them (work list), and gS, the cotangent of the
    fitter's silhouette term at stage 2 (w_reproj 1000, mean over H·W
    pixels, through alpha = 1 − e^−S) with random signs. S comes from K1."""
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW

    H, W = size
    k_sub = math.ceil(R.auto_approx_max_faces(size, device=dev) / R.FACE_GROUP)
    tri, z, valid = scene(spec, n_frames, dev)
    face, mask = R._pack_faces(tri, valid), R._tile_cull_mask(tri, valid, H, W, SIGMA)
    idx, cnt = RW._tile_worklists(tri, z, valid, H, W, SIGMA, k_sub)
    S0 = R.exact_fwd(face, mask, H, W, SIGMA)
    u = torch.rand(S0.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    gS = (torch.exp(-S0) * (2 * u - 1) * (1000.0 / (H * W))).contiguous()
    return SimpleNamespace(H=H, W=W, N=n_frames, T=R._tile_grid(H, W)[2], C=face.shape[1],
                           k_sub=k_sub, face=face, mask=mask, flat=RW._pack_faces_flat(tri, valid),
                           idx=idx, cnt=cnt, gS=gS)


def plain_work(kind, x):
    """(N·T,) int32: the 8-face subgroups the plain version of K2 (``kind``
    "exact": its cull bits) or K4 ("worklist": its list entries) evaluates in
    each (frame, tile); 0 where the tile's |gS| never exceeds GRAD_SKIP."""
    from smilify_tpu_torch.render import rasterizer as R

    on = x.gS.abs().amax(dim=-1) > R.GRAD_SKIP
    n = R._mask_bits(x.mask, x.N, x.T, x.C).sum(dim=(-1, -2)) if kind == "exact" else x.cnt
    return torch.where(on, n, 0).reshape(-1).to(torch.int32)


def bwd_shape(source):
    """{name: value} of the BWD_SHAPE constants in the CUDA source text."""
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", source).group(1)) for k in BWD_SHAPE}


def bwd_blocks(kind, x, shape):
    """(blocks launched, blocks that find work) of one K2 or K4 launch at
    the launch shape ``shape`` (:func:`bwd_shape`), derived from the inputs
    by the kernels' exit rule: a block finds work when its slice holds a
    cull bit or a list entry and its tile's |gS| exceeds GRAD_SKIP somewhere."""
    from smilify_tpu_torch.render import rasterizer as R

    on = x.gS.abs().amax(dim=-1) > R.GRAD_SKIP
    if kind == "exact":
        bits = R._mask_bits(x.mask, x.N, x.T, x.C).reshape(x.N, x.T, -1, shape["kK2Slice"])
        live = bits.any(dim=-1)
    else:
        live = x.cnt[..., None] > torch.arange(0, x.k_sub, shape["kK4Span"], device=x.cnt.device)
    return live.numel(), int((live & on[..., None]).sum())


def kernel_phase(spec, n_frames, size, dev, timed=()):
    """K1-K4 against their plain versions on the card at one shape that the
    driven paths launch (``n_frames`` frames at ``size``², the work lists
    capped as the fitting CLIs cap them there); K2's and K4's ``work``
    counts against the subgroups their plain versions evaluate. Times the
    kernels named in ``timed``; returns one record per kernel."""
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW
    from smilify_tpu_torch.render._kernels import BWD_OPS_PER_PAIR, FWD_OPS_PER_PAIR

    x = raster_inputs(spec, n_frames, size, dev)
    H, W, N = x.H, x.W, x.N
    face, mask, flat, idx, cnt, gS = x.face, x.mask, x.flat, x.idx, x.cnt, x.gS
    work = torch.zeros(N * x.T, dtype=torch.int32, device=dev)
    cases = [
        ("exact_fwd", R.exact_fwd, R.exact_fwd_plain, (face, mask, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:162", FWD_OPS_PER_PAIR, (face, mask), None),
        ("exact_bwd", R.exact_bwd, R.exact_bwd_plain, (face, mask, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:267", BWD_OPS_PER_PAIR, (face, mask, gS), "exact"),
        ("worklist_fwd", RW.worklist_fwd, RW.worklist_fwd_plain, (flat, idx, cnt, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:226", FWD_OPS_PER_PAIR, (flat, idx, cnt), None),
        ("worklist_bwd", RW.worklist_bwd, RW.worklist_bwd_plain,
         (flat, idx, cnt, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:252", BWD_OPS_PER_PAIR, (flat, idx, cnt, gS),
         "worklist"),
    ]
    records = []
    for name, kernel, plain, args, replaces, ops_per_pair, inputs, bwd in cases:
        work.zero_()    # the backward kernels add to it, block by block
        out = kernel(*args, work=work)
        ref = plain(*args)
        torch.cuda.synchronize()
        at = f"N={N}, {H}x{W}"
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output ({at})")
        if bwd is None:
            err = float((torch.exp(-ref) - torch.exp(-out)).abs().max())
            ok = err <= ALPHA_ATOL
            check(float(out.max()) > 1.0, f"{name}: the mesh covers no pixel ({at})")
        else:
            err = float((out - ref).abs().max())
            ok = bool(torch.isclose(out, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL).all())
            check(float(ref.abs().max()) > 0, f"{name}: zero gradient ({at})")
        check(ok, f"{name}: kernel disagrees with its plain version ({at}, max abs err {err})")
        pairs = int(work.sum()) * R.FACE_GROUP * R.TILE_PIX
        rec = {"name": name, "route": "cuda", "source": "smilify_tpu_torch/csrc/raster.cu",
               "replaces": replaces, "launches": None, "max_abs_err": err}
        line = f"  {at} {name}: max abs err {err:.3g}, pairs {pairs}"
        if bwd is not None:
            expect = plain_work(bwd, x)
            bad = int((work != expect).sum())
            check(bad == 0, f"{name}: the subgroups counted differ from the plain version's in "
                            f"{bad} tiles ({at}; {int(work.sum())} against {int(expect.sum())})")
            launched, busy = bwd_blocks(bwd, x, bwd_shape(RASTER_CU.read_text()))
            line += (f", subgroups as the plain version's; {launched} blocks, {busy} with "
                     f"work by the exit rule")
        if name in timed:
            rec["ms"] = cuda_ms(lambda: kernel(*args), reps=20)
            rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
            b_ms, b_by = bound(nbytes(*inputs, out), pairs * ops_per_pair)
            rec.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
            line += (f", {rec['ms']:.4f} ms (plain {rec['plain_ms']:.2f} ms, bound "
                     f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
        log(line)
        records.append(rec)
    return records


def kernel_wrappers():
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW
    from smilify_tpu_torch.tools.peak import fma_peak

    return {"exact_fwd": R.exact_fwd, "exact_bwd": R.exact_bwd,
            "worklist_fwd": RW.worklist_fwd, "worklist_bwd": RW.worklist_bwd,
            "fma_peak": fma_peak}


def zero_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "frames"):
            fn.frames = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def sass_summary(lib, kernel):
    """Opcode counts of ``kernel`` in the SASS of ``lib`` (None without cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                ops[m.group(1)] += 1
    return ops


def peak_phase(dev):
    """K5 against its plain version on the card at a small shape and at the
    JAX probe's shape, then timed at that shape; returns its record."""
    from smilify_tpu_torch.tools import peak

    g = torch.Generator(device=dev).manual_seed(0)
    errs = []
    for shape in ((8, 1024), peak.SHAPE):
        x = torch.rand(shape, generator=g, device=dev) + 0.5
        out, ref = peak.fma_peak(x), peak.fma_peak_plain(x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"fma_peak: non-finite output at {shape}")
        rel = float(((out - ref).abs() / ref.abs()).max())
        log(f"  fma_peak {shape}: max rel err {rel:.3g} against its plain version")
        check(rel <= PEAK_RTOL, f"fma_peak disagrees with its plain version at {shape} ({rel})")
        errs.append(float((out - ref).abs().max()))
    ms = cuda_ms(lambda: peak.fma_peak(x), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: peak.fma_peak_plain(x), reps=2, warmup=1)
    b_ms, b_by = bound(nbytes(x, out), peak.flops(x.numel()))
    rate = peak.flops(x.numel()) / (ms * 1e-3)
    log(f"  fma_peak {tuple(x.shape)}: {ms:.4f} ms = {rate / 1e12:.2f} TFLOP/s "
        f"({100 * rate / PEAK_FP32_PER_S:.1f}% of 67), plain {plain_ms:.2f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}")
    lo, hi = PEAK_RATE_RANGE
    check(lo * PEAK_FP32_PER_S <= rate <= hi * PEAK_FP32_PER_S,
          f"fma_peak rate {rate / 1e12:.2f} TFLOP/s outside {lo:.0%}-{hi:.0%} of 67 TFLOP/s")
    return {"name": "fma_peak", "route": "cuda", "source": "smilify_tpu_torch/csrc/peak.cu",
            "replaces": "tools/bench_all.py:108", "launches": None, "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


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


def bench_phase(spec, spec_name, dev):
    """The bench path at full width with short timing windows:
    ``smilify_tpu_torch.bench``, then ``tools.bench_all``'s configs 1, 3, 3b
    and 3c. Checks every rate, the capped raster's IoU and which kernels the
    fitter configs launched with how many frames; returns the path's launch
    counts."""
    from smilify_tpu_torch import bench
    from smilify_tpu_torch.tools import bench_all

    quick = dict(repeats=1, target_s=0.0)
    zero_counts()
    head = bench.run(spec, spec_name, SIZE, **quick)
    report = bench_all.run(spec, only=["config1", "config3_", "config3b", "config3c"],
                           size=SIZE[0], **quick)
    counts = read_counts()
    log("  bench: " + json.dumps(head))
    for key, res in report.items():
        log(f"  bench_all {key}: " + json.dumps(res))

    def positive(x):
        return isinstance(x, float) and math.isfinite(x) and x > 0

    check(head["raster_mode"].startswith("worklist_cap_800"), "bench: not in the CLI-default mode")
    for k in ("value", "single_dispatch_iters_per_sec", "exact_single_dispatch_iters_per_sec",
              "exact_chained10_iters_per_sec"):
        check(positive(head[k]), f"bench: {k} = {head[k]}")
    check(all(positive(v) for v in report["config1_smil_forward_stick"].values()),
          "bench_all config1: a rate is not finite and positive")
    peak = report["fp32_fma_peak_gflops_measured"] * 1e9
    lo, hi = PEAK_RATE_RANGE
    check(lo * PEAK_FP32_PER_S <= peak <= hi * PEAK_FP32_PER_S,
          f"bench_all: FP32 peak {peak / 1e12:.2f} TFLOP/s outside {lo:.0%}-{hi:.0%} of 67")
    expect = {"config3_smalfitter_512": (1, ("exact_fwd", "exact_bwd")),
              "config3b_smalfitter_512_window10": (10, ("exact_fwd", "exact_bwd")),
              "config3c_smalfitter_512_window10_worklist": (10, ("worklist_fwd", "worklist_bwd"))}
    for key, (frames, used) in expect.items():
        res = report[key]
        for k in ("step_ms", "iters_per_sec", "chained10_step_ms", "chained10_iters_per_sec",
                  "raster_work_bound_gflops", "raster_work_bound_over_peak_pct"):
            check(positive(res[k]), f"bench_all {key}: {k} = {res[k]}")
        for k, n in res["kernel_launches"].items():
            check((n > 0) == (k in used), f"bench_all {key}: kernel {k} launched {n} times")
        check(all(res["kernel_frames_per_launch"].get(k) == frames for k in used),
              f"bench_all {key}: frames per launch {res['kernel_frames_per_launch']}, "
              f"expected {frames}")
    iou_c = report["config3c_smalfitter_512_window10_worklist"]["iou_vs_exact"]
    check(iou_c >= 0.99, f"bench_all config3c: capped IoU against exact {iou_c} below 0.99")
    log(f"  launches over the bench path: {counts}")
    check(all(n > 0 for n in counts.values()), "bench path: a kernel was never launched")
    return counts


def batched_phase(spec, spec_name, dev):
    """BatchedFitter (2 clips × 2 frames at 128²) against independent
    SmalFitter runs, a progressive fit, and bench_corpus at 8 clips."""
    from smilify_tpu_torch.fitter.fitter import FitData, FitParams, SmalFitter, synthetic_fit_data
    from smilify_tpu_torch.fitter.fitter_batch import BatchedFitter
    from smilify_tpu_torch.fitter.progressive import ProgressiveFitter
    from smilify_tpu_torch.fitter.stages import StageWeights, test_schedule
    from smilify_tpu_torch.tools import bench_corpus

    size, S, N = (128, 128), 2, 2
    flat = synthetic_fit_data(spec, S * N, size)
    clips = FitData(rgb=None, sil=flat.sil.reshape(S, N, *size),
                    joints=flat.joints.reshape(S, N, -1, 2),
                    visibility=flat.visibility.reshape(S, N, -1))
    # tests/test_fitter_batch.py's schedule: the stage-0 freeze path, then every term
    schedule = [StageWeights(1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 3, 1e-2),
                StageWeights(1.0, 0.5, 0.1, 0.01, 0.01, 0.01, 0.1, 4, 1e-2)]
    zero_counts()
    batched = BatchedFitter(spec, clips, size, device=dev)
    batched.fit(schedule)
    counts = read_counts()
    frames = {k: kernel_wrappers()[k].frames for k in ("exact_fwd", "exact_bwd")}
    log(f"  batched fit: launches {counts}, frames {frames}")
    check(counts["exact_fwd"] == counts["exact_bwd"] == 4 and
          all(frames[k] == 4 * S * N for k in frames) and counts["worklist_fwd"] == 0,
          "batched fit: expected one exact launch of all S·N frames a raster step")
    worst = 0.0
    for s in range(S):
        single = SmalFitter(spec, FitData(rgb=None, sil=clips.sil[s], joints=clips.joints[s],
                                          visibility=clips.visibility[s]), size, device=dev)
        single.fit(schedule)
        got = batched.sequence_params(s)
        for k in FitParams.fields():
            a, b = getattr(got, k), getattr(single.params, k)
            err = float(((a - b).abs() / (BATCH_ATOL + BATCH_RTOL * b.abs())).max())
            log(f"    clip {s} {k}: max abs diff {float((a - b).abs().max()):.3g} "
                f"({err:.3g} of the tolerance)")
            worst = max(worst, err)
    check(worst <= 1.0, f"batched fit differs from independent fits ({worst:.3g} × tolerance)")

    data = synthetic_fit_data(spec, 1, SIZE)
    prog = ProgressiveFitter(spec, data, SIZE, scales=(1, 4, 2, 1), device=dev)
    losses = [float(x) for x in prog.fit(test_schedule(5), chunk=5)]
    log(f"  progressive fit (scales 1, 4, 2, 1; 4 × 5 steps): stage losses {losses}")
    check(all(math.isfinite(x) for x in losses) and set(prog._fitters) == {1, 2, 4},
          "progressive fit: non-finite loss or a scale not run")

    res = bench_corpus.run(spec, spec_name, clips=8, size=256, chunk=10)
    log("  bench_corpus: " + json.dumps(res))
    check(all(math.isfinite(res[k]) and res[k] > 0 for k in
              ("single_clip_iter_ms", "batched_step_ms", "speedup_vs_sequential")),
          "bench_corpus: a rate is not finite and positive")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    import smilify_tpu_torch

    check(Path(smilify_tpu_torch.__file__).resolve().parent.parent == ROOT,
          f"smilify_tpu_torch imported from {smilify_tpu_torch.__file__}, not beside this script")
    from smilify_tpu_torch._device import card_line
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.fitter.fitter import synthetic_fit_data
    from smilify_tpu_torch.render import _kernels
    from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces
    from smilify_tpu_torch.utils.visualization import silhouette_iou

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    log("[1/7] build")
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    log(f"  built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())
    ops = sass_summary(libs["peak"], "fma_peak_kernel")
    if ops is None:
        log("  SASS: no cuobjdump")
    else:
        log(f"  SASS of fma_peak_kernel: {ops['FFMA']} FFMA of {sum(ops.values())} "
            f"instructions; {dict(ops.most_common())}")
        check(ops["FFMA"] == PEAK_FFMA,
              f"fma_peak_kernel has {ops['FFMA']} FFMA in its SASS, expected {PEAK_FFMA}")

    spec, spec_name = load_spec(device=dev)
    log(f"  spec: {spec_name}, B={spec.n_betas}")

    log("[2/7] kernels against their plain versions at the driven paths' shapes")
    records = kernel_phase(spec, 1, SIZE, dev,
                           timed=("exact_fwd", "exact_bwd", "worklist_fwd", "worklist_bwd"))
    # frames a launch × image: the fitter's profile and bench_all's N=10
    # configs (K2 and K4 timed there too); bench_corpus (8 clips at 256²);
    # the batched fitter and the progressive fit's coarse scales (128²)
    for n_frames, size in ((4, SIZE), (10, SIZE), (8, (256, 256)), (4, (128, 128))):
        timed = ("exact_bwd", "worklist_bwd") if n_frames == 10 else ()
        for rec, at_n in zip(records, kernel_phase(spec, n_frames, size, dev, timed)):
            if "ms" in at_n:
                rec.update(ms_10_frames=at_n["ms"], bound_ms_10_frames=at_n["bound_ms"])
    records.append(peak_phase(dev))
    log("[3/7] main path: SmalFitter, 4 stages × 10 steps, 1 frame at 512²")
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
        zero_counts()
        losses, seconds, last, fitter = drive_fitter(spec, data, mode_cap, dev)
        counts[mode] = read_counts()
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
    for rec in records[:4]:
        mode = "exact" if rec["name"].startswith("exact") else "capped"
        rec["launches"] = counts[mode][rec["name"]]

    for mode, fitter in fitters.items():
        log(f"  {mode} fit: IoU with the target "
            f"{silhouette_iou(silhouette(fitter, None), data.sil):.4f}")
    f = fitters["exact"]
    iou_cap = silhouette_iou(silhouette(f, cap), silhouette(f, None))
    log(f"  IoU of capped (cap {cap}) against exact on the exact fit's pose: {iou_cap:.4f}")
    check(iou_cap >= 0.99, "capped raster IoU against exact below 0.99")

    log("[4/7] references")
    reference_phase(spec, dev)

    log("[5/7] where the time goes: 1 and 10 frames")
    data10 = synthetic_fit_data(spec, 10, SIZE)
    for frames, d in ((1, data), (10, data10)):
        for mode, (mode_cap, _) in modes.items():
            profile_phase(spec, d, dev, f"{mode}, {frames} frame(s),", mode_cap)

    log("[6/7] bench path: bench, bench_all configs 1, 3, 3b, 3c (short windows)")
    bench_counts = bench_phase(spec, spec_name, dev)
    records[4]["launches"] = bench_counts["fma_peak"]

    log("[7/7] batched and progressive fitters, bench_corpus")
    batched_phase(spec, spec_name, dev)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
