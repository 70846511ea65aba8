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
    ``tools.bench_corpus`` at 8 clips;
  * the fitter CLIs (``cli.optimize_to_joints`` capped, exact and with the
    Phong panel; ``cli.optimize_corpus``) on a synthetic replicAnt sequence
    at 512², the model loaded from a pickle with Morton-sorted faces; the
    committed JPEG fixtures decoded by the card machine's OpenCV against the
    pixels imageio decoded on the test CPU; ``optimize_to_joints`` on a true
    JPEG frame at 128², ``--exact`` on the card and on the CPU (held to each
    other) and the default route on the card;
  * 3D registration (``cli.optimise_3d.register``) of 8 target scans of
    10,952 faces, twice, the two runs bitwise equal (no global
    deterministic mode: the gathers' backward adds in an order fixed by the
    indices, ``ops/gather.py``); config2's step (``tools.bench_all``) timed
    and profiled at 1 and 8 targets, and config2 itself;
  * the data pipeline: ``data.synthetic.synthesize_multiview`` at its
    defaults (4 views at 96², chunks of 32) for 1,600 samples, one K1 launch
    of 32 frames a (view, chunk), K1 held to its plain version at that
    shape; ``train.trainer.DeviceDataCache`` over the samples; all of them
    written to an HDF5 store by the port's codec (``utils/hdf5_io.py``) and
    read back;
  * neural serving (``bench_all`` configs 4 and 5a at full width: ResNet-50
    + IEF head 256 × 4 × 3 at 224², seeded weights): the card held to the
    CPU in float32 (TF32 off) and bf16 autocast held to float32, with one
    5a sample's views all masked; ``cli.run_inference`` on 16 replicAnt
    frames from a checkpoint written by ``train.trainer.save_checkpoint``
    (smoothing, animation export, Phong renders on the card), and its model
    in one batch of 16 against batches of 8 in float32 and in bf16; 64
    samples of ``synthesize_multiview`` (4 views at 224², K1 held to its
    plain version at that shape) through ``DeviceDataCache`` into 5a's
    model and ``BenchmarkAccumulator``; ``bench_all`` configs 4,
    5a and 5b (18 views, the mouse-width spec) with short windows; and a
    profile of config 4 at B=128 in bf16: the device's busy share, the top
    operations, the FLOPs its layers' shapes give and the ``mfu`` against
    989 TFLOP/s (H100 SXM dense bf16);
  * training (``bench_all`` configs 4b, 4c and 5c: the train steps, with
    their ``mfu``; config 4b's profile at B=128): one config-4b train step
    at B=2 in float32 on the card against the CPU (loss, gradients,
    parameters and BatchNorm statistics after the step) and bf16 against
    float32 on the loss; a learning check of the single-view regressor on 64
    ``synthesize_multiview`` samples at 224² in ``DeviceDataCache`` (K1
    launched by the generator), with a non-finite batch that must be
    skipped; ``cli.train_regressor`` for 2 epochs on 16 replicAnt frames,
    from the device cache and through the host pipeline, then
    ``cli.run_inference`` on its checkpoint; ``cli.train_pointnet``; and the
    input-pipeline bench's synthetic, serial, threaded and cached_staged
    modes. The training path reaches no kernel; its launch counts are read
    and must stay 0;
  * slice 5 (phase 13): configs 4 and 5a exported by ``serve.py`` with a
    symbolic batch, loaded in a fresh process that imports only torch and
    ``smilify_tpu_torch.serve`` and served at B=1/8/128 (5a: 1/8) against
    the live model, ``cli.export_serving --verify`` and ``--shard-data``,
    ``cli.run_inference --shard`` against the run without it; then, through ``torch.distributed.run`` of this script's rank role
    (``--scaleout-rank BACKEND DIR``), one rank over NCCL and two ranks of
    the one card over gloo: the frame-sharded fit (K1/K2 and K3/K4 on
    every rank, launched as often as in the unsharded fit), the clip- and
    grid-sharded corpus fitters, ``ShardedStageManager`` (two runs of
    ``StageManager`` first, which must be at 0.000 of the gate) and config
    4b's data-parallel train step, each against its single-process
    counterpart;
  * slice 6 (phase 14), on what phases 8, 9, 11 and 13 leave under
    ``build/``: ``cli.generate_video`` on phase 8's corpus fit (4 frames at
    512², frame 0 held to the CPU's render by the Phong gate) and
    ``--collage``; ``cli.run_inference --video`` on phase 11's checkpoint and
    its video path on phase 13's 5a checkpoint, every video read back;
    ``cli.read_fitter_stages`` and ``utils.authoring.build_model_from_registration``
    on phase 9's registration, the authored model loaded on the card with
    one exact silhouette (one K1 launch, held to its plain version), the
    measurement CSVs, ``betas_from_measurements``, the native PCA loader
    built into ``build/native/`` and ``cli.prepare_meshes`` on phase 9's
    scans as STL; ``cli.export_gltf`` on phase 11's animation, its keyframes
    evaluated from the file against ``smil_forward``; ``utils.monitoring``
    (a trace, ``recommend_batch_size`` for resnet50 and config 4b's step at
    that batch) and ``cli.show_latest_checkpoint``; the OpenCV paths:
    ``cli.run_inference`` on phase 14's own mp4 as raw-video input, card
    against CPU; one augmented epoch of config 4b's regressor from a
    replicAnt PNG folder, card against CPU; augmentation's blur and warps and
    the undistortion of an image and of points against the test CPU's
    OpenCV (``tools/opencv_paths.py``, ``tests/fixtures/opencv_paths.npz``);
  * the learning proofs (phase 15): ``tools.prove_learning``'s ``memorize``
    for the single- and multi-view regressors (K1 renders their samples),
    each held to the JAX gates: loss ratio ≥ 20, PCK@5 ≥ 0.7, PCK@10 ≥ 0.9;
    then a toy ``heldout`` in two calls (``--until 2``, then the rest): the
    two calls' store digests equal (K1 regenerates the data bitwise), the
    history continuous and the steps counted over both;
  * the HDF5 stores (phase 16), through the port's codec: the committed
    fixtures of ``tests/fixtures/hdf5`` (h5py- and JAX-written) read bit for
    bit as ``expected.npz`` holds them; phase 10's store written again by
    ``data.synthetic.generate_synthetic_multiview`` (200 K1 launches), the
    file phase 10's bit for bit; ``cli.train_multiview`` from it for 2
    epochs through the host pipeline (ResNet-50 + IEF, bf16, 4 views at
    96²), ``cli.benchmark_model`` on its checkpoint from the file and from
    the same samples in memory (equal bit for bit), ``cli.dataset_viewer``
    on one sample; ``cli.preprocess_replicant`` on 16 frames at 224² into
    a single-view store, ``cli.train_regressor`` from it and
    ``cli.run_inference`` on it; a SLEAP session written by
    ``tools.synthetic_data.write_sleap_session`` (3 cameras, 24 frames)
    through ``cli.preprocess_sleap_multiview``;
  * slice 10 (phase 17), what the JAX package needs PyYAML and
    matplotlib for, without either: ``python -m smilify_tpu_torch.cli.optimise_3d`` in a
    process of its own on phase 9's 8 scans in two batches, from a YAML
    stage file (comments, two stages of 20 steps, a flow ``loss_weights``,
    ``custom_lrs``, ``args``) read by the port's reader
    (``utils/yaml_io.py``), its merged npz bitwise equal to ``register``
    given the same stages in this process, its loss plots at their sizes;
    the fixtures of ``tests/fixtures/plots`` (PyYAML's values, matplotlib's
    polygon masks, axis limits and 3D projections, its viridis table) met
    with 0 keys apart; a COCO file of polygon segmentations through
    ``data.loaders.load_smil_sequence(alt_seg=False)``, 0 pixels from
    matplotlib's masks; and every plot site's files (``utils/plotting.py``)
    at the JAX package's pixel sizes: the trainers' history and 3D-keypoint
    plots of phases 12 and 16, ``benchmark_model``'s two of phase 16, the
    three ``utils.visualization`` plots on (a)'s registration and
    ``cli.plot_pca_data`` on phase 14's CSV.

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

Every raster kernel's count of evaluated 8-face subgroups (``work``) is
held, tile by tile, to the one its plain version computes. The forward
kernels K1 and K3 run one thread-block cluster a tile and write the count
once a tile, after the saturation early-out; phase 2 also runs them on a
saturating scene (6,000 large overlapping triangles made from a seed), logs
how many tiles stopped early and fails if none did. The backward kernels K2
and K4 run many blocks a tile and add their counts to ``work``; the blocks
launched and the blocks that found work (both derived from the inputs by
the kernels' exit rule) are logged. The records of K1-K4 add
``ms_10_frames`` and ``bound_ms_10_frames`` (10 frames at 512²); K1's adds
``data_pipeline``, its launches, time and bound at the data pipeline's
shape (32 frames at 96²) with the pipeline's rates. A kernel's time is the
median of three windows of launches, printed with their spread
(``ms_spread``).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
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
# the raster kernels' launch shapes: constants of csrc/raster.cu
FWD_SHAPE = ("kFwdCluster", "kFwdLanes", "kFwdThreads")
BWD_SHAPE = ("kBwdThreads", "kK2Slice", "kK4Span")
# the saturating scene: large triangles (circumradius 0.3-0.45 in NDC)
# centred in the middle of the image, so the tiles deep inside the covered
# region reach S ≥ 20 within the first batch and the tiles at its rim never do
SAT_FACES = 6000
SAT_SEED = 4
# a kernel's time: the median of this many windows of launches (chip_smoke
# phases 2 and 10), printed with their spread
TIMING_WINDOWS = 3
# phase 10, the data pipeline: synthesize_multiview at its defaults (4 views
# at 96², chunks of 32) for 1,600 samples, the first generalization run's
# size; the device cache's batch; all the samples written to HDF5 by the
# port's codec and read back
DATA_SAMPLES = 1600
DATA_VIEWS, DATA_RES, DATA_CHUNK = 4, 96, 32
DATA_BATCH = 32
# phase 11, neural serving: configs 4/5a at 224² on B=2 for the card-vs-CPU
# check; run_inference on 16 frames; 64 multi-view samples in batches of 8;
# config 4's profile at B=128
SERVE_RES, SERVE_B, SERVE_FRAMES = 224, 2, 16
SERVE_MV_SAMPLES, SERVE_MV_VIEWS, SERVE_MV_BATCH, SERVE_MV_CHUNK = 64, 4, 8, 32
PROFILE_B, PROFILE_STEPS = 128, 3
PEAK_BF16_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# the card against the CPU, both float32 with TF32 off: max |Δ| over the
# decoded predictions and the raw IEF history, relative to max(1, max |CPU|)
# (measured on the H100: 2.4e-6 for config 4, 4.0e-6 for 5a)
SERVE_FP32_TOL = 2e-5
# bf16 autocast of the backbone against float32 on the card, the same measure
# (measured: 1.0e-2 and 1.5e-2)
SERVE_BF16_TOL = 0.1
# phase 8, JPEG frames: the committed fixtures (Pillow-written; the pixels
# imageio decoded from them on the test CPU), the card machine's OpenCV decode
# gated at JPEG_LEVELS grey levels; a fit on a true JPEG frame at JPEG_SIZE²
# (small enough for the CPU's fit beside the card's), the two held to each
# other by tests/test_torch_cli.py's gate on the end parameters (port vs JAX)
JPEG_FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
JPEG_LEVELS = 1
JPEG_SIZE = 128
CLI_PARAM_ATOL = 1e-4


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


def cuda_ms_windows(fn, reps, windows=TIMING_WINDOWS, warmup=2):
    """(median, [min, max]) of the mean milliseconds of ``fn()`` over
    ``windows`` windows of ``reps`` launches each (:func:`cuda_ms`), so that
    one cold window does not stand for the kernel."""
    ms = sorted(cuda_ms(fn, reps, warmup if w == 0 else 0) for w in range(windows))
    return ms[len(ms) // 2], [ms[0], ms[-1]]


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


def saturating_scene(n_frames, dev):
    """SAT_FACES large triangles a frame, made on the card from SAT_SEED:
    (tri_xy (N, F, 3, 2), tri_z (N, F, 3), valid (N, F)). Centres uniform in
    [−0.5, 0.5]², vertices at circumradius 0.3-0.45 around them, 120° ± 20°
    apart; z in [1, 2]; 5% of the faces invalid."""
    g = torch.Generator(device=dev).manual_seed(SAT_SEED)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    N, F = n_frames, SAT_FACES
    centre = uniform(-0.5, 0.5, N, F, 1, 2)
    turn = torch.arange(3, device=dev) * (2 * math.pi / 3)
    angle = uniform(0, 2 * math.pi, N, F, 1) + turn + uniform(-0.35, 0.35, N, F, 3)
    radius = uniform(0.3, 0.45, N, F, 3)
    tri = centre + radius[..., None] * torch.stack([angle.cos(), angle.sin()], -1)
    return tri.contiguous(), uniform(1.0, 2.0, N, F, 3), uniform(0, 1, N, F) > 0.05


def raster_inputs(spec, n_frames, size, dev, saturating=False):
    """The raster kernels' inputs for ``n_frames`` frames at ``size`` of the
    posed mesh (or of :func:`saturating_scene`): packed faces and cull words
    (exact), flat faces and work lists capped as the fitting CLIs cap them
    (work list), and gS, the cotangent of the fitter's silhouette term at
    stage 2 (w_reproj 1000, mean over H·W pixels, through alpha = 1 − e^−S)
    with random signs. S comes from K1."""
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW

    H, W = size
    k_sub = math.ceil(R.auto_approx_max_faces(size, device=dev) / R.FACE_GROUP)
    tri, z, valid = saturating_scene(n_frames, dev) if saturating else scene(spec, n_frames, dev)
    face, mask = R._pack_faces(tri, valid), R._tile_cull_mask(tri, valid, H, W, SIGMA)
    idx, cnt = RW._tile_worklists(tri, z, valid, H, W, SIGMA, k_sub)
    S0 = R.exact_fwd(face, mask, H, W, SIGMA)
    u = torch.rand(S0.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    gS = (torch.exp(-S0) * (2 * u - 1) * (1000.0 / (H * W))).contiguous()
    return SimpleNamespace(H=H, W=W, N=n_frames, T=R._tile_grid(H, W)[2], C=face.shape[1],
                           k_sub=k_sub, face=face, mask=mask, flat=RW._pack_faces_flat(tri, valid),
                           idx=idx, cnt=cnt, gS=gS)


def listed_work(kind, x):
    """(N·T,) int32: every 8-face subgroup a tile has to offer, its cull
    bits (``kind`` "exact") or its list entries ("worklist")."""
    from smilify_tpu_torch.render import rasterizer as R

    n = R._mask_bits(x.mask, x.N, x.T, x.C).sum(dim=(-1, -2)) if kind == "exact" else x.cnt
    return n.reshape(-1).to(torch.int32)


def plain_work(kind, x):
    """(N·T,) int32: the 8-face subgroups the plain version of K2 (``kind``
    "exact") or K4 ("worklist") evaluates in each (frame, tile): all it has
    to offer, or 0 where the tile's |gS| never exceeds GRAD_SKIP."""
    from smilify_tpu_torch.render import rasterizer as R

    on = x.gS.abs().amax(dim=-1).reshape(-1) > R.GRAD_SKIP
    return torch.where(on, listed_work(kind, x), 0).to(torch.int32)


def source_constants(source, names):
    """{name: value} of the ``constexpr int`` constants ``names`` in CUDA source text."""
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", source).group(1)) for k in names}


def fwd_err_reading(ref, out, work, face=None, mask=None, H=None, W=None):
    """Where a forward kernel's alpha error peaks, read from the plain S
    (N, T, TILE_PIX) and the kernel's: S and |ΔS| at that pixel (|ΔS| also in
    float32 ulps of S; alpha = 1 - exp(-S), so the alpha error is
    exp(-S)·|ΔS|), the faces its tile evaluated (subgroups × FACE_GROUP) and
    the most any tile evaluated. Given the exact raster's packed faces and
    cull words, also: the faces whose term at that pixel moves its float32
    sum (at least half an ulp of S), the largest term, its d/σ (d the signed
    squared distance) and how many of those faces share its d (faces around
    one vertex, whose float32 roundings of d add up), the frame's median
    edge in NDC (the cancellation in d grows with it), and both the kernel's
    and the plain float32 alpha against the float64 plain version's."""
    from smilify_tpu_torch.render import rasterizer as R

    i = int((torch.exp(-ref) - torch.exp(-out)).abs().argmax())
    n, t, p = np.unravel_index(i, tuple(ref.shape))
    S, dS = float(ref[n, t, p]), abs(float(out[n, t, p]) - float(ref[n, t, p]))
    faces = work.view(ref.shape[0], ref.shape[1]) * R.FACE_GROUP
    rec = {"S": S, "dS": dS, "dS_ulps": dS / (max(S, 1e-30) * 2.0 ** -23),
           "tile_faces": int(faces[n, t]), "max_tile_faces": int(faces.max()),
           "max_S": float(ref.max())}
    if face is None:
        return rec
    px, py = R._tile_pixels(H, W, torch.float64, face.device)
    fa = face[n].reshape(1, -1, 8).double()
    d, _ = R._signed_distance(px[t, p].view(1, 1, 1), py[t, p].view(1, 1, 1), fa)
    terms = (fa[..., 6:7] * torch.nn.functional.softplus(-d / SIGMA)).flatten()
    d = d.flatten()
    k = int(terms.argmax())
    adding = (terms > 0) & (terms >= S * 2.0 ** -24)
    xy = fa[0, :, :6].reshape(-1, 3, 2)[fa[0, :, 6] > 0]
    rec["faces_adding"] = int(adding.sum())
    rec["largest_term"] = float(terms[k])
    rec["share_its_d"] = int((adding & ((d - d[k]).abs() <= 1e-9 * d[k].abs())).sum())
    rec["d_over_sigma"] = float(d[k]) / SIGMA
    rec["median_edge"] = float((xy[:, [1, 2, 0]] - xy).norm(dim=-1).median())
    ref64 = R.exact_fwd_plain(face.double(), mask, H, W, SIGMA)
    a64 = torch.exp(-ref64)
    rec["kernel_vs_f64"] = float((torch.exp(-out.double()) - a64).abs().max())
    rec["plain_vs_f64"] = float((torch.exp(-ref.double()) - a64).abs().max())
    return rec


def err_line(r):
    line = (f"at the worst pixel S {r['S']:.4g}, |dS| {r['dS']:.3g} ({r['dS_ulps']:.1f} ulps of "
            f"S), its tile {r['tile_faces']} faces (most in a tile {r['max_tile_faces']}), "
            f"max S {r['max_S']:.4g}")
    if "faces_adding" in r:
        line += (f"; {r['faces_adding']} faces add to S there (largest term "
                 f"{r['largest_term']:.3g} at d/sigma {r['d_over_sigma']:.3g}, shared by "
                 f"{r['share_its_d']}), median edge {r['median_edge']:.4f} NDC; alpha against "
                 f"the float64 plain version's: kernel {r['kernel_vs_f64']:.3g}, float32 plain "
                 f"{r['plain_vs_f64']:.3g}")
    return line


def bwd_blocks(kind, x, shape):
    """(blocks launched, blocks that find work) of one K2 or K4 launch at
    the launch shape ``shape`` (:func:`source_constants`), derived from the
    inputs by the kernels' exit rule: a block finds work when its slice holds
    a cull bit or a list entry and its tile's |gS| exceeds GRAD_SKIP
    somewhere."""
    from smilify_tpu_torch.render import rasterizer as R

    on = x.gS.abs().amax(dim=-1) > R.GRAD_SKIP
    if kind == "exact":
        bits = R._mask_bits(x.mask, x.N, x.T, x.C).reshape(x.N, x.T, -1, shape["kK2Slice"])
        live = bits.any(dim=-1)
    else:
        live = x.cnt[..., None] > torch.arange(0, x.k_sub, shape["kK4Span"], device=x.cnt.device)
    return live.numel(), int((live & on[..., None]).sum())


def kernel_phase(spec, n_frames, size, dev, timed=(), saturating=False):
    """K1-K4 against their plain versions on the card at one shape that the
    driven paths launch (``n_frames`` frames at ``size``², the work lists
    capped as the fitting CLIs cap them there), each kernel's ``work``
    counts against the subgroups its plain version evaluates, tile by tile.
    ``saturating``: K1 and K3 only, on :func:`saturating_scene`, failing
    unless some tile stopped early. Times the kernels named in ``timed``;
    returns one record per kernel."""
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render import rasterizer_worklist as RW
    from smilify_tpu_torch.render._kernels import BWD_OPS_PER_PAIR, FWD_OPS_PER_PAIR

    x = raster_inputs(spec, n_frames, size, dev, saturating)
    H, W, N = x.H, x.W, x.N
    face, mask, flat, idx, cnt, gS = x.face, x.mask, x.flat, x.idx, x.cnt, x.gS
    work = torch.empty(N * x.T, dtype=torch.int32, device=dev)
    cases = [
        ("exact_fwd", R.exact_fwd, R.exact_fwd_plain, (face, mask, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:162", FWD_OPS_PER_PAIR, (face, mask), "exact"),
        ("exact_bwd", R.exact_bwd, R.exact_bwd_plain, (face, mask, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer.py:267", BWD_OPS_PER_PAIR, (face, mask, gS), "exact"),
        ("worklist_fwd", RW.worklist_fwd, RW.worklist_fwd_plain, (flat, idx, cnt, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:226", FWD_OPS_PER_PAIR, (flat, idx, cnt),
         "worklist"),
        ("worklist_bwd", RW.worklist_bwd, RW.worklist_bwd_plain,
         (flat, idx, cnt, gS, H, W, SIGMA),
         "smilify_tpu/render/rasterizer_worklist.py:252", BWD_OPS_PER_PAIR, (flat, idx, cnt, gS),
         "worklist"),
    ]
    if saturating:
        cases = [c for c in cases if c[0].endswith("_fwd")]
    records = []
    for name, kernel, plain, args, replaces, ops_per_pair, inputs, kind in cases:
        fwd = name.endswith("_fwd")
        # the forward kernels write every tile's entry once; the backward
        # ones add to it, block by block
        work.fill_(-1 if fwd else 0)
        out = kernel(*args, work=work)
        if fwd:
            expect = torch.empty_like(work)
            ref = plain(*args, work=expect)
        else:
            ref, expect = plain(*args), plain_work(kind, x)
        torch.cuda.synchronize()
        at = f"N={N}, {H}x{W}{', saturating scene' if saturating else ''}"
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output ({at})")
        if fwd:
            err = float((torch.exp(-ref) - torch.exp(-out)).abs().max())
            ok = err <= ALPHA_ATOL
            check(float(out.max()) > 1.0, f"{name}: the mesh covers no pixel ({at})")
        else:
            err = float((out - ref).abs().max())
            ok = bool(torch.isclose(out, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL).all())
            check(float(ref.abs().max()) > 0, f"{name}: zero gradient ({at})")
        check(ok, f"{name}: kernel disagrees with its plain version ({at}, max abs err {err})")
        bad = int((work != expect).sum())
        check(bad == 0, f"{name}: the subgroups counted differ from the plain version's in "
                        f"{bad} tiles ({at}; {int(work.sum())} against {int(expect.sum())})")
        pairs = int(work.sum()) * R.FACE_GROUP * R.TILE_PIX
        rec = {"name": name, "route": "cuda", "source": "smilify_tpu_torch/csrc/raster.cu",
               "replaces": replaces, "launches": None, "max_abs_err": err}
        line = (f"  {at} {name}: max abs err {err:.3g}, pairs {pairs}, subgroups as the plain "
                f"version's in every tile")
        if fwd:
            stopped = int((expect < listed_work(kind, x)).sum())
            rec["err_at"] = (fwd_err_reading(ref, out, expect, face, mask, H, W)
                             if name == "exact_fwd" else fwd_err_reading(ref, out, expect))
            line += f"; {stopped} of {N * x.T} tiles stopped early; {err_line(rec['err_at'])}"
            if saturating:
                check(stopped > 0, f"{name}: no tile stopped early on the saturating scene ({at})")
        else:
            launched, busy = bwd_blocks(kind, x, source_constants(RASTER_CU.read_text(),
                                                                  BWD_SHAPE))
            line += f"; {launched} blocks, {busy} with work by the exit rule"
        if name in timed:
            rec["ms"], rec["ms_spread"] = cuda_ms_windows(lambda: kernel(*args), reps=20)
            rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
            b_ms, b_by = bound(nbytes(*inputs, out), pairs * ops_per_pair)
            rec.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
            lo, hi = rec["ms_spread"]
            line += (f", {rec['ms']:.4f} ms (median of {TIMING_WINDOWS} windows, {lo:.4f}-"
                     f"{hi:.4f}; plain {rec['plain_ms']:.2f} ms, bound "
                     f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
        log(line)
        records.append(rec)
    return records


def zero_counts():
    """Start the kernels' counts anew (the run records throughout)."""
    from smilify_tpu_torch.utils import monitoring

    monitoring.reset()


def read_counts(what="launches"):
    """Each kernel's launches (or, for the raster kernels, ``"frames"``)
    since :func:`zero_counts`, as the recorder's counters hold them."""
    from smilify_tpu_torch.utils import monitoring

    counters = monitoring.summary()["counters"]
    names = {k: f"raster.{k}.{what}" for k in ("exact_fwd", "exact_bwd", "worklist_fwd",
                                                 "worklist_bwd")}
    if what == "launches":
        names["fma_peak"] = "peak.fma.launches"
    return {k: counters.get(name, 0) for k, name in names.items()}


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
    ms, spread = cuda_ms_windows(lambda: peak.fma_peak(x), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: peak.fma_peak_plain(x), reps=2, warmup=1)
    b_ms, b_by = bound(nbytes(x, out), peak.flops(x.numel()))
    rate = peak.flops(x.numel()) / (ms * 1e-3)
    log(f"  fma_peak {tuple(x.shape)}: {ms:.4f} ms (median of {TIMING_WINDOWS} windows, "
        f"{spread[0]:.4f}-{spread[1]:.4f}) = {rate / 1e12:.2f} TFLOP/s "
        f"({100 * rate / PEAK_FP32_PER_S:.1f}% of 67), plain {plain_ms:.2f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}")
    lo, hi = PEAK_RATE_RANGE
    check(lo * PEAK_FP32_PER_S <= rate <= hi * PEAK_FP32_PER_S,
          f"fma_peak rate {rate / 1e12:.2f} TFLOP/s outside {lo:.0%}-{hi:.0%} of 67 TFLOP/s")
    return {"name": "fma_peak", "route": "cuda", "source": "smilify_tpu_torch/csrc/peak.cu",
            "replaces": "tools/bench_all.py:108", "launches": None, "max_abs_err": max(errs),
            "ms": ms, "ms_spread": spread, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


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


def device_ops(run, host=True):
    """{operation name: (device µs, count)} over ``run()``: the kernels,
    copies and fills, not the ranges the optimizer annotates. ``host=False``
    traces the device only, which slows a run of many small host
    operations far less."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return by_name


def log_device_ops(by_name, steps, top):
    log(f"  device time per step by operation, over {steps} profiled steps:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {us / 1e3 / steps:8.4f} ms  {n / steps:5.0f}x  {name[:100]}")


def profile_phase(spec, data, dev, mode, cap):
    """Device time by operation over 5 steps of stage 2 in one raster mode,
    and the device's busy share of the wall time."""
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
    by_name = device_ops(lambda: fitter.run_stage(2, weights))
    if not by_name:
        log("  profile: the profiler recorded no device events")
        return
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / steps
    n_events = sum(n for _, n in by_name.values()) / steps
    log(f"  {mode} step in stage 2: wall {wall_ms:.3f} ms (unprofiled), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall), {n_events:.0f} device "
        f"operations")
    log_device_ops(by_name, steps, 12)


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
    frames = {k: read_counts("frames")[k] for k in ("exact_fwd", "exact_bwd")}
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


def posed_silhouette(spec, params, cap=None):
    """The soft silhouette (1, H, W) of frame 0 of ``params`` (rest limb
    scales as the fitter's, the default camera at the frame's fov)."""
    from smilify_tpu_torch.fitter.fitter import _posed, _project_frames
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.rasterizer import soft_silhouette

    cam = default_camera(device=spec.device)
    with torch.no_grad():
        verts, joints, _, _ = _posed(spec, params, True)
        ndc, _ = _project_frames(cam, params.fov, verts, joints, SIZE)
        return soft_silhouette(ndc, spec.faces, SIZE, znear=cam.znear, approx_max_faces=cap)


def k3_subgroups(spec, dev):
    """(8-face subgroups on the capped work lists, subgroups K3 evaluated)
    over the tiles of one posed frame at 512²."""
    from smilify_tpu_torch.render import rasterizer_worklist as RW

    x = raster_inputs(spec, 1, SIZE, dev)
    work = torch.empty(x.N * x.T, dtype=torch.int32, device=dev)
    RW.worklist_fwd(x.flat, x.idx, x.cnt, x.H, x.W, SIGMA, work=work)
    return int(listed_work("worklist", x).sum()), int(work.sum())


def check_frame_exports(out_dir, frames, stages):
    """Every frame folder holds st{s}_ep0.{png,pkl,ply} for each stage of
    ``stages`` and the final st10_ep0; returns the final PNG collages."""
    from smilify_tpu_torch.utils.image_io import read_png

    collages = []
    for frame in frames:
        d = Path(out_dir) / Path(frame).stem
        want = {f"st{s}_ep0.{e}" for s in (*stages, 10) for e in ("png", "pkl", "ply")}
        have = {p.name for p in d.iterdir()}
        check(want <= have, f"{d}: missing exports {sorted(want - have)}")
        collages.append(read_png(d / "st10_ep0.png"))
    return collages


def ply_vertices(path):
    lines = Path(path).read_text().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    start = lines.index("end_header") + 1
    return torch.tensor([[float(v) for v in ln.split()] for ln in lines[start:start + n]])


def jpeg_fixtures(card):
    """The committed JPEG fixtures (``tests/fixtures/jpeg``: Pillow-written,
    quality 75/95, EXIF orientation 6, grayscale) decoded by ``read_image``
    (OpenCV's ``IMREAD_UNCHANGED``) against the pixels imageio decoded from
    them on the test CPU; the gap in grey levels, gated at JPEG_LEVELS."""
    import cv2

    from smilify_tpu_torch.utils.image_io import read_image

    want = np.load(JPEG_FIXTURES / "pixels.npz")
    gaps = {}
    for name in want.files:
        got = read_image(JPEG_FIXTURES / name)
        check(got.dtype == np.uint8 and got.shape == want[name].shape,
              f"JPEG fixture {name}: decoded to {got.dtype} {got.shape}, expected {want[name].shape}")
        gaps[name] = int(np.abs(got.astype(int) - want[name].astype(int)).max())
    log(f"  JPEG fixtures through OpenCV {cv2.__version__} against imageio's pixels on the test "
        f"CPU: max |Δ| in grey levels {gaps} (gate {JPEG_LEVELS}; {card})")
    check(max(gaps.values()) <= JPEG_LEVELS, f"JPEG fixtures: the decode is off by {gaps}")
    return gaps


def cli_jpeg(spec, model, dev, card):
    """``optimize_to_joints`` on a true JPEG frame (``cv2.imwrite``, read
    back through ``read_image``'s OpenCV route) at JPEG_SIZE²: ``--exact``
    on the card (K1/K2) and on the CPU from the same files, the end
    parameters and the PLY's vertices held to each other by the CLI test's
    CLI_PARAM_ATOL; the default route on the card (K3/K4)."""
    from smilify_tpu_torch.cli import optimize_to_joints
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence
    from smilify_tpu_torch.utils.export import load_fitter_checkpoint
    from smilify_tpu_torch.utils.image_io import JPEG_SIGNATURE

    root = ROOT / "build" / "smoke_cli_jpeg"      # beside smoke_cli: phase 14 reads its newest run
    shutil.rmtree(root, ignore_errors=True)
    coco, frames = write_replicant_sequence(str(root), spec, 1, JPEG_SIZE, image_format="jpeg")
    check((Path(coco) / "data" / frames[0]).read_bytes().startswith(JPEG_SIGNATURE),
          f"{frames[0]} is not a JPEG file")
    base = ["--model", model, "--data-root", coco, "--sequence", f"replicAnt:{frames[0]}",
            "--test", "--test-stages", "2"]
    runs = (("exact_card", dev.type, ["--exact"], ("exact_fwd", "exact_bwd")),
            ("exact_cpu", "cpu", ["--exact"], ()),
            ("default_card", dev.type, [], ("worklist_fwd", "worklist_bwd")))
    out = {}
    for label, device, extra, used in runs:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_to_joints.main(base + extra + ["--output-dir", str(root / label), "--device", device])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        log(f"  optimize_to_joints on {frames[0]} (JPEG, {JPEG_SIZE}², 2 test stages), {label}: "
            f"{secs:.2f} s; launches {counts}")
        for k in used:
            check(counts[k] > 0, f"JPEG fit {label}: kernel {k} never launched")
        if device == "cpu":
            check(sum(counts.values()) == 0, f"JPEG fit on the CPU launched kernels {counts}")
        out[label] = {"seconds": secs, "launches": counts}
    card_ck, cpu_ck = (load_fitter_checkpoint(str(root / lab), frames, 10, "0")
                       for lab in ("exact_card", "exact_cpu"))
    params_gap = max(float(np.abs(np.asarray(card_ck[k]) - np.asarray(cpu_ck[k])).max())
                     for k in cpu_ck)
    ply = [ply_vertices(root / lab / Path(frames[0]).stem / "st10_ep0.ply")
           for lab in ("exact_card", "exact_cpu")]
    verts_gap = float((ply[0] - ply[1]).abs().max())
    log(f"    --exact card against CPU on the same JPEG: end parameters max |Δ| {params_gap:.3g}, "
        f"PLY vertices {verts_gap:.3g} (gate {CLI_PARAM_ATOL:g}; {card})")
    check(params_gap <= CLI_PARAM_ATOL and verts_gap <= CLI_PARAM_ATOL,
          "the JPEG fit on the card is off the CPU's")
    out.update(params_gap=params_gap, verts_gap=verts_gap)
    return out


def cli_phase(toy, dev, card):
    """The fitter CLIs at full width on a synthetic replicAnt sequence: the
    STICK-width toy spec written as a model pickle (the CLIs load it with
    Morton-sorted faces), 4 frames at 512² rendered from posed copies.
    ``optimize_to_joints`` on frame 0 three times (the default cap: K3/K4;
    ``--exact``: K1/K2; ``--texture``: the Phong panel), then
    ``optimize_corpus`` on the 4 frames as one-frame clips; each with
    ``--test --test-stages 4``."""
    from smilify_tpu_torch.cli import optimize_corpus, optimize_to_joints
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.fitter.fitter import _posed, init_params, params_from_numpy
    from smilify_tpu_torch.fitter.priors import shape_prior_from_spec
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.phong import render_phong
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
    from smilify_tpu_torch.utils.export import load_fitter_checkpoint
    from smilify_tpu_torch.utils.visualization import silhouette_iou

    work = ROOT / "build" / "smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    model = write_model_pkl(str(work / "stick_width.pkl"), toy)
    spec = load_model_spec(model, align_symmetry=False, device=dev)
    check(not torch.equal(spec.faces, toy.faces), "the loaded spec's faces are not Morton-sorted")
    t0 = time.perf_counter()
    coco, frames = write_replicant_sequence(str(work), spec, 4, SIZE[0])
    log(f"  wrote {model} and 4 frames at 512² in {time.perf_counter() - t0:.2f} s")
    for name, s in (("mesh-grid (phase 2)", toy), ("Morton (the CLIs)", spec)):
        listed, evaluated = k3_subgroups(s, dev)
        log(f"  K3 subgroups, 1 posed frame at 512², {name} face order: {listed} on the work "
            f"lists, {evaluated} evaluated")

    cam = default_camera(device=dev)
    start = init_params(spec, 1, shape_prior_from_spec(spec))
    with torch.no_grad():
        v = _posed(spec, start, True)[0][0]
        pv = cam.world_to_view(v)
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        render_phong(v, pv, ndc, spec.faces, SIZE)
        torch.cuda.reset_peak_memory_stats()
        phong_ms = cuda_ms(lambda: render_phong(v, pv, ndc, spec.faces, SIZE), reps=3, warmup=1)
    log(f"  render_phong at 512², F={spec.n_faces}: {phong_ms:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    base = ["--model", model, "--data-root", coco, "--test", "--test-stages", "4",
            "--device", str(dev)]
    runs = {"capped": (["--sequence", f"replicAnt:{frames[0]}"], ("worklist_fwd", "worklist_bwd")),
            "exact": (["--sequence", f"replicAnt:{frames[0]}", "--exact"],
                      ("exact_fwd", "exact_bwd")),
            "texture": (["--sequence", f"replicAnt:{frames[0]}", "--texture"],
                        ("worklist_fwd", "worklist_bwd"))}
    steps = 4 * ITERS_PER_STAGE
    target = read_mask(coco, frames[0])
    init_iou = silhouette_iou(posed_silhouette(spec, start), target)
    collages = {}
    for mode, (args, used) in runs.items():
        out = work / mode
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_to_joints.main(base + args + ["--output-dir", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        log(f"  optimize_to_joints {mode}: {wall:.2f} s wall, {steps / wall:.2f} steps/s "
            f"(40 steps, 5 exports, load included; {card}); launches {counts}")
        for k in used:
            check(counts[k] > 0, f"optimize_to_joints {mode}: kernel {k} never launched")
        if mode == "exact":
            check(counts["worklist_fwd"] == counts["worklist_bwd"] == 0,
                  "optimize_to_joints --exact launched the work-list kernels")
        collages[mode] = check_frame_exports(out, frames[:1], range(4))[0]
        ck = load_fitter_checkpoint(str(out), frames[:1], 10, "0")
        check(all(np.isfinite(a).all() for a in ck.values()),
              f"optimize_to_joints {mode}: non-finite parameters")
        params = params_from_numpy(ck, device=dev)
        with torch.no_grad():
            fitted = _posed(spec, params, True)[0][0].cpu()
        ply = ply_vertices(out / Path(frames[0]).stem / "st10_ep0.ply")
        err = float((fitted - ply).abs().max())
        check(err <= 2e-5, f"optimize_to_joints {mode}: the checkpoint's vertices are {err} off "
                           f"the exported PLY")
        iou = silhouette_iou(posed_silhouette(spec, params), target)
        log(f"    IoU with the target: initial {init_iou:.4f}, final {iou:.4f}; checkpoint "
            f"against PLY max |Δv| {err:.2g}")
        check(iou > init_iou, f"optimize_to_joints {mode}: the fit's IoU did not rise")
    check(bool((collages["texture"] != collages["capped"]).any()),
          "--texture: the collage is the silhouette one")

    out = work / "corpus"
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimize_corpus.main(base + ["--all-replicant", "--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  optimize_corpus, 4 one-frame clips: {wall:.2f} s wall, {4 * steps / wall:.2f} "
        f"clip-steps/s ({card}); launches {counts}, frames a launch "
        f"{read_counts('frames')['worklist_fwd'] / max(1, counts['worklist_fwd']):.1f}")
    check(counts["worklist_fwd"] > 0 and counts["worklist_bwd"] > 0,
          "optimize_corpus: the work-list kernels were never launched")
    check(read_counts("frames")["worklist_bwd"] == 4 * counts["worklist_bwd"],
          "optimize_corpus: a raster launch did not take all 4 clips")
    check_frame_exports(out, frames, range(4))
    ck = load_fitter_checkpoint(str(out), frames, 10, "0")
    check(all(np.isfinite(a).all() for a in ck.values()), "optimize_corpus: non-finite parameters")
    return {"jpeg_fixture_levels": jpeg_fixtures(card), "jpeg_fit": cli_jpeg(spec, model, dev, card)}


def read_mask(coco, frame):
    from smilify_tpu_torch.utils.image_io import read_png

    return read_png(Path(coco).parent / "SMIL" / (frame[:-9] + "ID.png"))[None, :, :, 0] > 0


def registration_phase(toy, dev, card):
    """3D registration at full width: 8 target scans (``toy_model_spec(75,
    55, 5)``: 5,625 vertices, 10,952 faces, about the Atta scan's 10,878),
    posed and scaled from a seed, written as ``.obj`` and read back; the
    optimise_3d CLI's body (``register``) fits the 55-side template to all 8
    at once in two stages (``init``, then ``default``) of 20 steps at 3000
    samples; then config2's step (``bench_all``) at 1 and 8 targets, timed
    and profiled, and config2 itself against one of them."""
    from smilify_tpu_torch.cli.optimise_3d import register
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter3d import Fit3DParams, Stage
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.tools._timing import timeit_chain
    from smilify_tpu_torch.tools.synthetic_data import posed_target_meshes
    from smilify_tpu_torch.utils.export import load_obj, save_obj

    work = ROOT / "build" / "smoke_registration"
    shutil.rmtree(work, ignore_errors=True)
    (work / "scans").mkdir(parents=True)
    scan = toy_model_spec(75, 55, 5, seed=1, device=dev)
    faces = scan.faces.cpu().numpy()
    paths = []
    for i, v in enumerate(posed_target_meshes(scan, 8, seed=7)):
        paths.append(str(work / "scans" / f"scan{i}.obj"))
        save_obj(paths[-1], v, faces)
    log(f"  8 target scans of V={scan.n_verts}, F={scan.n_faces}; template V={toy.n_verts}, "
        f"F={toy.n_faces}")
    stages = [Stage("init", "init", n_its=20, lr=0.01),
              Stage("default", "default", n_its=20, lr=0.005)]
    seen, chunk_end = [], {}

    def on_step(b, stage, it, loss, objs):
        # called for every step after its chunk of 10 was read back: the
        # clock at the first step of a chunk marks that chunk's end
        seen.append(objs["chamfer"])
        if it % 10 == 0:
            chunk_end[stage, it] = time.perf_counter()

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    register(toy, paths, stages, str(work / "results"), batch_size=-1, num_samples=3000,
             chunk=10, callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = []
    register(toy, paths, [Stage("init", "init", n_its=20, lr=0.01),
                          Stage("default", "default", n_its=20, lr=0.005)],
             str(work / "results_again"), batch_size=-1, num_samples=3000, chunk=10,
             callback=lambda b, stage, it, loss, objs: again.append(objs["chamfer"]))
    first_npz, again_npz = (np.load(work / d / "batch_0" / "default.npz")
                            for d in ("results", "results_again"))
    differ = [k for k in first_npz.files if not np.array_equal(first_npz[k], again_npz[k])]
    log(f"  the same registration run again: chamfer trajectories "
        f"{'bitwise equal' if again == seen else 'differ'}, final npz arrays that differ: "
        f"{differ or 'none'}")
    check(again == seen and not differ, "registration: two runs of the same registration differ")
    step_ms = [1e3 * (chunk_end[st.name, 10] - chunk_end[st.name, 0]) / 10 for st in stages]
    log(f"  registration, 8 targets, 2 × 20 steps at 3000 samples: {wall:.2f} s wall (obj "
        f"loading, topology and npz included); steady {step_ms[0]:.2f} / {step_ms[1]:.2f} ms a "
        f"step in stage init / default (a chunk of 10 between read-backs; {card}); launches "
        f"{read_counts()}")
    first, last = float(np.mean(seen[:5])), float(np.mean(seen[-5:]))
    log(f"    chamfer: first 5 steps {first:.6g}, last 5 {last:.6g}")
    check(all(math.isfinite(c) for c in seen) and last < first, "registration: chamfer did not fall")
    data = np.load(work / "results" / "batch_0" / "default.npz")
    want = {*Fit3DParams.fields(), "verts", "joints", "faces", "labels"}
    check(set(data.files) == want and data["verts"].shape == (8, toy.n_verts, 3)
          and np.isfinite(data["verts"]).all(), f"registration npz: keys {data.files}")

    meshes = [load_obj(p) for p in paths]
    steps = 5
    for n in (1, 8):
        step, params = bench_all.fitter3d_step(toy, meshes[:n])
        ms = 1e3 * timeit_chain(step, params, n1=10, n2=40, warmup=3, repeats=3, target_s=0.5)
        by_name = device_ops(lambda: [step(params) for _ in range(steps)])
        check(bool(by_name), "registration: the profiler recorded no device events")
        busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / steps
        n_ops = sum(k for _, k in by_name.values()) / steps
        log(f"  config2's step at {n} target(s): {ms:.3f} ms (timeit_chain), device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / ms:.1f}%), {n_ops:.0f} device operations a "
            f"step ({card})")
        log_device_ops(by_name, steps, 6)
        check(all(torch.isfinite(getattr(params, k)).all() for k in params.fields()),
              f"registration step at {n} target(s): non-finite parameters")

    res = bench_all.bench_fitter3d(toy, paths[0], repeats=3, target_s=0.5)
    log(f"  bench_all config2 (1 target, 3000 samples): {json.dumps(res)} ({card})")
    check(math.isfinite(res["step_ms"]) and res["step_ms"] > 0, "config2: step_ms not positive")

def data_k1_phase(spec, dev, images, n_views, res, chunk, where):
    """K1 against its plain version at a shape the data pipeline launches
    it: the first (view, chunk) of a ``synthesize_multiview`` run over
    ``len(images)`` samples of ``n_views`` views at ``res``², chunks of
    ``chunk`` (parameters and camera made as it makes them). Phase 2's gates
    (alpha within ALPHA_ATOL, ``work`` equal tile by tile); timed over
    TIMING_WINDOWS windows. Then that chunk's view-0 ``images`` (the run's
    (N, views, res, res, 3) uint8 output) against the plain version's alpha,
    coloured and quantized as the generator does: within one level. Returns
    K1's record at that shape."""
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.data import synthetic as S
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render._kernels import FWD_OPS_PER_PAIR

    C = min(chunk, len(images))
    betas, grot, jrot, _ = S.draw_parameters(spec, len(images))
    theta = np.concatenate([grot[:, None], jrot], axis=1)[:C]
    with torch.no_grad():
        verts = smil_forward(spec, torch.from_numpy(betas[:C]).to(dev),
                             torch.from_numpy(theta).to(dev)).verts
        ndc = S.view_ndc(verts, *S.ring_cameras_opencv(n_views, resolution=res)[0], res)
    tri = ndc[:, spec.faces.long()]
    valid = torch.any(tri[..., 2] > S.ZNEAR, dim=-1)
    H = W = res
    face, mask = R._pack_faces(tri[..., :2], valid), R._tile_cull_mask(tri[..., :2], valid,
                                                                      H, W, R.SIGMA)
    T = R._tile_grid(H, W)[2]
    work = torch.full((C * T,), -1, dtype=torch.int32, device=dev)
    expect = torch.empty_like(work)
    out = R.exact_fwd(face, mask, H, W, R.SIGMA, work=work)
    ref = R.exact_fwd_plain(face, mask, H, W, R.SIGMA, work=expect)
    torch.cuda.synchronize()
    at = f"N={C}, {H}x{W}, {where}'s first (view, chunk)"
    check(bool(torch.isfinite(out).all()), f"exact_fwd: non-finite output ({at})")
    check(float(out.max()) > 1.0, f"exact_fwd: the mesh covers no pixel ({at})")
    err = float((torch.exp(-ref) - torch.exp(-out)).abs().max())
    check(err <= ALPHA_ATOL, f"exact_fwd disagrees with its plain version ({at}, max abs err {err})")
    bad = int((work != expect).sum())
    check(bad == 0, f"exact_fwd: the subgroups counted differ from the plain version's in {bad} "
                    f"tiles ({at})")
    pairs = int(work.sum()) * R.FACE_GROUP * R.TILE_PIX
    err_at = fwd_err_reading(ref, out, expect, face, mask, H, W)
    ms, spread = cuda_ms_windows(lambda: R.exact_fwd(face, mask, H, W, R.SIGMA), reps=20)
    plain_ms = cuda_ms(lambda: R.exact_fwd_plain(face, mask, H, W, R.SIGMA), reps=2, warmup=1)
    b_ms, b_by = bound(nbytes(face, mask, out), pairs * FWD_OPS_PER_PAIR)
    log(f"  {at} exact_fwd: max abs err {err:.3g} (gate {ALPHA_ATOL:g}), pairs {pairs}, "
        f"subgroups as the plain version's in every tile; {err_line(err_at)}; {ms:.4f} ms "
        f"(median of {TIMING_WINDOWS} windows, {spread[0]:.4f}-{spread[1]:.4f}; plain "
        f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    alpha = 1.0 - torch.exp(-R._tiles_to_image(ref, H, W))
    colour = torch.tensor(S.SILHOUETTE_RGB, dtype=torch.float32, device=dev)
    plain_img = (alpha[..., None] * colour * 255).to(torch.uint8).cpu().numpy()
    diff = np.abs(images[:C, 0].astype(int) - plain_img.astype(int)).max()
    log(f"  {where}: the first chunk's view-0 images within {diff} level(s) of the plain version's")
    check(diff <= 1, f"{where}: images differ from the plain raster's by more than 1")
    return {"frames": C, "size": [H, W], "max_abs_err": err, "err_at": err_at,
            "ms": ms, "ms_spread": spread, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def data_phase(toy, dev, card):
    """Phase 10, the data pipeline at full width: the STICK-width toy spec
    written as a model pickle and loaded with Morton-sorted faces, as the
    CLIs load a model. ``synthesize_multiview`` at its defaults for
    DATA_SAMPLES samples (one K1 launch a (view, chunk): exactly
    DATA_VIEWS × the chunks, and no K2-K4), K1 held to its plain version at
    that shape, the ``DeviceDataCache`` over the samples (a batch against the
    host-side gather, an epoch of batches timed), and the samples written to
    an HDF5 store by the port's codec and read back (:func:`hdf5_read_back`).
    Returns K1's record at the pipeline's shape, with its launches and the
    store's numbers, the samples and the store's path."""
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data import synthetic as S
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.train.trainer import DeviceDataCache

    work = ROOT / "build" / "smoke_data"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = load_model_spec(write_model_pkl(str(work / "stick_width.pkl"), toy),
                           align_symmetry=False, device=dev)
    check(not torch.equal(spec.faces, toy.faces), "the loaded spec's faces are not Morton-sorted")
    kw = dict(n_views=DATA_VIEWS, resolution=DATA_RES, chunk_size=DATA_CHUNK, device=dev)
    S.synthesize_multiview(spec, 2 * DATA_CHUNK, **kw)           # warm-up (allocator, cuBLAS)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = S.synthesize_multiview(spec, DATA_SAMPLES, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    n_k1 = DATA_VIEWS * math.ceil(DATA_SAMPLES / DATA_CHUNK)
    log(f"  synthesize_multiview: {DATA_SAMPLES} samples, {DATA_VIEWS} views at {DATA_RES}², "
        f"chunks of {DATA_CHUNK}: {seconds:.3f} s = {DATA_SAMPLES / seconds:.1f} samples/s "
        f"({card}); launches {counts}")
    check(counts["exact_fwd"] == n_k1, f"synthesize_multiview launched K1 {counts['exact_fwd']} "
                                       f"times, expected {n_k1}")
    check(all(n == 0 for k, n in counts.items() if k != "exact_fwd"),
          f"synthesize_multiview launched another kernel than K1: {counts}")

    check(len(samples) == DATA_SAMPLES, "synthesize_multiview: wrong number of samples")
    images = np.stack([s["images"] for s in samples])
    check(images.shape == (DATA_SAMPLES, DATA_VIEWS, DATA_RES, DATA_RES, 3)
          and images.dtype == np.uint8, f"synthesize_multiview: images {images.shape}")
    cover = (images.max(-1) > 0).mean(axis=(2, 3))
    log(f"  silhouette coverage a view: {cover.min():.4f}-{cover.max():.4f} "
        f"(mean {cover.mean():.4f}); keypoints visible {np.mean([s['keypoint_visibility'].mean() for s in samples]):.4f}")
    check(cover.min() > 0.0 and cover.max() < 1.0, "synthesize_multiview: an empty or full image")
    for k in ("keypoints_2d", "keypoints_3d"):
        check(all(np.isfinite(s[k]).all() for s in samples), f"synthesize_multiview: non-finite {k}")

    # the same run again under the profiler (device activity only): K1's
    # device time summed over its launches there, against that run's own
    # wall time (the run alone, not the profiler's set-up and read-out)
    span = []

    def profiled_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.synthesize_multiview(spec, DATA_SAMPLES, **kw)
        torch.cuda.synchronize()
        span.append(time.perf_counter() - t0)

    by_name = device_ops(profiled_run, host=False)
    prof_s = span[0]
    k1_us, k1_n = by_name.get(next((k for k in by_name if "exact_fwd_kernel" in k), ""), (0.0, 0))
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    if by_name:
        check(k1_n == n_k1, f"the profiled run shows {k1_n} K1 launches, expected {n_k1}")
        log(f"  profiled run: wall {prof_s * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / (prof_s * 1e3):.1f}%), K1 {k1_us / 1e3:.1f} ms over {k1_n} "
            f"launches ({100 * k1_us / 1e3 / (prof_s * 1e3):.1f}% of the wall)")
        log_device_ops(by_name, 1, 6)
    else:
        log("  profile: the profiler recorded no device events; K1's share not measured")

    rec = data_k1_phase(spec, dev, images, DATA_VIEWS, DATA_RES, DATA_CHUNK,
                        "the data pipeline")
    rec["launches"] = counts["exact_fwd"]
    rec["samples_per_s"] = DATA_SAMPLES / seconds
    rec["profiled_wall_ms"] = prof_s * 1e3
    rec["k1_device_ms"] = k1_us / 1e3 if by_name else None
    rec["k1_share_of_wall"] = k1_us / 1e3 / (prof_s * 1e3) if by_name else None
    rec["device_busy_ms"] = busy_ms if by_name else None

    t0 = time.perf_counter()
    cache = DeviceDataCache(samples, device=dev)
    torch.cuda.synchronize()
    log(f"  DeviceDataCache: {cache.n} samples, {len(cache.arrays)} columns, {cache.bytes} bytes "
        f"({cache.arrays['images'].numel()} of them images) on {dev}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    idx = np.random.default_rng(0).permutation(DATA_SAMPLES)[:DATA_BATCH]
    batch = cache.batch(idx)
    for k, v in batch.items():
        host = np.stack([np.asarray(samples[i][k]) for i in idx])
        if k == "images":
            host = host.astype(np.float32) * np.float32(1 / 255)
        host = host.astype({np.dtype(np.float64): np.float32,
                            np.dtype(np.int64): np.int32}.get(host.dtype, host.dtype))
        check(np.array_equal(v.cpu().numpy(), host), f"DeviceDataCache batch: {k} differs from "
                                                     f"the host-side gather")
    log(f"  a batch of {DATA_BATCH} equals the host-side gather in all {len(batch)} columns")
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in cache.iterate(DATA_BATCH, np.random.default_rng(rep)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"  epoch {rep}: {n} batches of {DATA_BATCH} in {secs * 1e3:.2f} ms = "
            f"{n / secs:.1f} batches/s")
    check(n == DATA_SAMPLES // DATA_BATCH, f"DeviceDataCache: {n} batches in an epoch")
    rec["cache_bytes"] = cache.bytes
    rec["batches_per_s"] = n / secs
    del cache

    from smilify_tpu_torch.data.hdf5_dataset import write_multiview_hdf5

    path = str(work / "synthetic.h5")
    t0 = time.perf_counter()
    write_multiview_hdf5(path, samples, **synthetic_store_args(spec))
    write_s = time.perf_counter() - t0
    rec["hdf5"] = {"write_seconds": write_s, **hdf5_read_back(path, samples, "phase 10's store")}
    log(f"  HDF5 (the port's codec): {DATA_SAMPLES} samples written in {write_s:.2f} s, "
        f"{rec['hdf5']['bytes']} bytes")
    return rec, samples, path


def synthetic_store_args(spec):
    """``write_multiview_hdf5``'s arguments for phase 10's samples, as
    ``data/synthetic.py::generate_synthetic_multiview`` passes them."""
    return dict(max_views=DATA_VIEWS, target_resolution=DATA_RES,
                canonical_camera_order=[f"cam_{i}" for i in range(DATA_VIEWS)],
                n_pose=spec.n_joints - 1, n_betas=spec.n_betas, dataset_type="synthetic_multiview")


def hdf5_read_back(path, samples, what):
    """Every sample of the multi-view store at ``path`` read back through
    ``MultiViewHDF5Dataset`` against ``samples`` (phase 10's): the arrays
    equal, the JPEG images within a mean absolute error of 0.02. Returns the
    file's bytes, the read's seconds and samples/s."""
    from smilify_tpu_torch.data.hdf5_dataset import MultiViewHDF5Dataset

    t0 = time.perf_counter()
    ds = MultiViewHDF5Dataset(path)
    check(len(ds) == len(samples), f"HDF5 ({what}): {len(ds)} samples read back")
    worst = 0.0
    for i in range(len(samples)):
        s, orig = ds[i], samples[i]
        for k in ("keypoints_2d", "keypoints_3d", "betas", "joint_rot", "global_rot"):
            check(np.array_equal(s[k], orig[k]), f"HDF5 ({what}): sample {i} {k} differs")
        worst = max(worst, float(np.abs(s["images"] - orig["images"] / 255.0).mean()))
    secs = time.perf_counter() - t0
    ds.close()
    log(f"  HDF5 ({what}): {len(samples)} samples read back through MultiViewHDF5Dataset in "
        f"{secs:.2f} s = {len(samples) / secs:.1f} samples/s, arrays equal, JPEG mean abs "
        f"error at most {worst:.4f}")
    check(worst < 0.02, f"HDF5 ({what}): the JPEG images differ from the samples'")
    return {"bytes": os.path.getsize(path), "read_seconds": secs,
            "read_samples_per_s": len(samples) / secs, "jpeg_mean_abs_err": worst}


def perturb_zero_params(model, seed=0, std=0.02):
    """Draw every all-zero parameter (the delta heads' and camera heads'
    zero-initialized kernels, zero biases) from N(0, std²) with ``seed``, so
    that the outputs depend on the images and a comparison of two runs
    compares something."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def _max_rel_gap(a: dict, b: dict) -> float:
    """max over keys of max |a − b| / max(1, max |b|)."""
    gap = 0.0
    for k in b:
        x, y = a[k].float().cpu(), b[k].float().cpu()
        gap = max(gap, float((x - y).abs().max()) / max(1.0, float(y.abs().max())))
    return gap


def _serve_outputs(model, cfg, spec, inputs, multiview):
    """{decoded predictions, the raw IEF history as history_i} of one call."""
    from smilify_tpu_torch.models.multiview import decode_multiview_predictions
    from smilify_tpu_torch.models.regressor import decode_predictions, float32_region

    with torch.no_grad():
        raw, hist = model(*inputs)
        with float32_region(inputs[0].device):
            dec = (decode_multiview_predictions if multiview else decode_predictions)(cfg, raw, spec)
    dec.update({f"history_{i}": h for i, h in enumerate(hist)})
    return dec


def serving_parity(toy, dev):
    """Configs 4 and 5a (STICK width, 224², seeded weights): the card in
    float32 (TF32 off) against the same model on the CPU, and bf16 autocast
    against float32 on the card; 5a's second sample has every view masked."""
    import copy
    import dataclasses

    from smilify_tpu_torch.tools import bench_all

    cpu_spec = toy.to("cpu")
    rng = np.random.default_rng(11)
    gaps = {}
    for label, multiview in (("config4", False), ("config5a", True)):
        if multiview:
            cfg, model = bench_all.multiview_model(toy, SERVE_MV_VIEWS, SERVE_RES, torch.float32)
            perturb_zero_params(model)
            imgs = rng.random((SERVE_B, SERVE_MV_VIEWS, SERVE_RES, SERVE_RES, 3), dtype=np.float32)
            mask = np.ones((SERVE_B, SERVE_MV_VIEWS), bool)
            mask[1] = False
            host = (torch.from_numpy(imgs), torch.from_numpy(mask),
                    torch.arange(SERVE_MV_VIEWS).expand(SERVE_B, SERVE_MV_VIEWS))
        else:
            cfg, model = bench_all.singleview_model(toy, SERVE_RES, torch.float32)
            perturb_zero_params(model)
            host = (torch.from_numpy(rng.random((SERVE_B, SERVE_RES, SERVE_RES, 3), dtype=np.float32)),)
        cpu_model = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
        card = _serve_outputs(model, cfg, toy, tuple(x.to(dev) for x in host), multiview)
        cpu = _serve_outputs(cpu_model, cfg, cpu_spec, host, multiview)
        gap = _max_rel_gap(card, cpu)
        model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        bf16 = _serve_outputs(model, model.config, toy, tuple(x.to(dev) for x in host), multiview)
        gap16 = _max_rel_gap(bf16, card)
        worst = max(card, key=lambda k: float((card[k].cpu() - cpu[k]).abs().max()))
        log(f"  {label}: card vs CPU float32 max |Δ| / max(1, |CPU|) = {gap:.3e} (worst in "
            f"{worst}; tolerance {SERVE_FP32_TOL:g}, headroom {SERVE_FP32_TOL / max(gap, 1e-30):.1f}x); "
            f"bf16 autocast vs float32 on the card {gap16:.3e} (bound {SERVE_BF16_TOL:g})")
        for out in (card, bf16):
            check(all(bool(torch.isfinite(v).all()) for v in out.values()),
                  f"{label}: non-finite outputs")
        if multiview:
            masked = {k: v[1] for k, v in card.items() if v.shape[0] == SERVE_B}
            check(all(bool(torch.isfinite(v).all()) for v in masked.values()),
                  f"{label}: the fully masked sample's outputs are not finite")
            log(f"  {label}: the sample with every view masked gives finite outputs "
                f"(global_rot {masked['global_rot'].cpu().numpy().round(4).tolist()})")
        check(gap <= SERVE_FP32_TOL, f"{label}: card vs CPU gap {gap:.3e} > {SERVE_FP32_TOL}")
        check(gap16 <= SERVE_BF16_TOL, f"{label}: bf16 gap {gap16:.3e} > {SERVE_BF16_TOL}")
        gaps[label] = {"fp32_card_vs_cpu": gap, "bf16_vs_fp32": gap16}
    return gaps


def serving_cli(toy, dev, work):
    """run_inference on SERVE_FRAMES replicAnt frames at 224² from a
    checkpoint that save_checkpoint wrote (a config-4-shaped regressor, bf16
    backbone): predictions.npz against a direct model call on the same
    frames, smoothed the same way; the animation and the PNGs."""
    import copy
    import dataclasses

    from smilify_tpu_torch.cli import run_inference
    from smilify_tpu_torch.cli.train_regressor import build_dataset
    from smilify_tpu_torch.models.weight_port import build_model
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
    from smilify_tpu_torch.train.config import load_config, resolve_model_spec
    from smilify_tpu_torch.train.trainer import TrainState, save_checkpoint
    from smilify_tpu_torch.utils.animation_export import PredictionSmoother

    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    folder, _ = write_replicant_sequence(str(work / "seq"), toy, SERVE_FRAMES, SERVE_RES,
                                         layout="unreal")
    cfg = load_config(None, overrides={
        "smal_model.smal_file": pkl, "model.backbone_name": "resnet50",
        "model.input_resolution": SERVE_RES, "model.transformer_depth": 4,
        "model.transformer_heads": 8, "model.transformer_dim_head": 32,
        "model.transformer_mlp_dim": 1024, "model.transformer_ief_iters": 3,
        "training.use_mixed_precision": True}, mode="single_view")
    spec = resolve_model_spec(cfg, device=dev)
    rcfg = cfg.regressor_config(spec)
    torch.manual_seed(0)
    model = perturb_zero_params(build_model(rcfg, img_size=SERVE_RES))
    ckpt = save_checkpoint(str(work / "run"), TrainState(model.state_dict()), cfg, "final_model")
    model = model.to(dev).eval().to(memory_format=torch.channels_last)

    zero_counts()
    t0 = time.perf_counter()
    traj = run_inference.main(["--checkpoint", ckpt, "--data-path", folder, "--smooth-window", "3",
                               "--export-animation", str(work / "anim"),
                               "--render-dir", str(work / "frames"), "--device", dev.type])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    cfg.dataset.data_path = folder
    dataset, _ = build_dataset(cfg, spec)
    imgs = torch.from_numpy(np.stack([dataset[i]["image"] for i in range(SERVE_FRAMES)])).to(dev)
    # in run_inference's batches of 8: bf16 convolutions of another batch size
    # round differently (the bf16 gap of serving_parity)
    predict = run_inference.predictor(model, rcfg, spec, False)
    parts = [predict({"image": imgs[i:i + 8]}) for i in range(0, SERVE_FRAMES, 8)]
    direct = {k: torch.cat([p[k] for p in parts]).cpu().numpy() for k in parts[0]}
    keys = [k for k in ("global_rot", "joint_rot", "trans", "betas", "fov", "cam_rot", "cam_trans")
            if k in direct]
    direct = PredictionSmoother(3).smooth_params(direct, keys)
    saved = dict(np.load(work / "run" / "predictions.npz"))
    gap = max(float(np.abs(saved[k] - direct[k]).max()) / max(1.0, float(np.abs(direct[k]).max()))
              for k in direct)
    pngs = sorted(p.name for p in (work / "frames").glob("frame_*.png"))
    log(f"  run_inference: {SERVE_FRAMES} frames at {SERVE_RES}² (bf16 backbone), smoothed, "
        f"animation and renders on {spec.device}, {secs:.2f} s; predictions.npz against a direct "
        f"call on the same frames: max |Δ| / max(1, |direct|) {gap:.3e}; "
        f"{len(pngs)} PNGs; kernel launches {counts}")
    check(sorted(saved) == sorted(direct) and sorted(traj) == sorted(direct),
          "run_inference: predictions.npz keys differ")
    check(gap <= SERVE_FP32_TOL, f"run_inference: predictions.npz differs from a direct call "
                                 f"by {gap:.3e}")
    check(len(pngs) == SERVE_FRAMES, f"run_inference: {len(pngs)} PNGs, expected {SERVE_FRAMES}")
    check((work / "anim.npz").exists() and (work / "anim.json").exists(),
          "run_inference: no animation file")
    check(spec.device.type == "cuda", "run_inference: not on the card")

    # the witness for the batching above: the same model on the same frames in
    # one batch of SERVE_FRAMES against run_inference's batches of 8, in bf16
    # autocast and in float32 (TF32 off), and bf16 against float32 in batches
    # of 8, on the card and on the CPU. Rounding may move bf16 with the
    # batch's shape; float32 must agree to SERVE_FP32_TOL, or the batch size
    # changes the result (a bug)
    def decoded(m, sp, x, dtype, step):
        m.config = dataclasses.replace(rcfg, compute_dtype=dtype)
        pred = run_inference.predictor(m, m.config, sp, False)
        parts = [pred({"image": x[i:i + step]}) for i in range(0, SERVE_FRAMES, step)]
        m.config = rcfg
        return {k: torch.cat([p[k] for p in parts]).cpu() for k in parts[0]}

    def by_key(a, b):
        return {k: float((a[k] - b[k]).abs().max()) / max(1.0, float(b[k].abs().max())) for k in b}

    def pooled_gap(m, x):
        with torch.no_grad():
            ref = m.backbone(x[:8]).pooled.float()
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                low = m.backbone(x[:8]).pooled.float()
        return float((low - ref).abs().max()) / float(ref.abs().max())

    out = {dtype: {step: decoded(model, spec, imgs, dtype, step) for step in (SERVE_FRAMES, 8)}
           for dtype in (torch.bfloat16, torch.float32)}
    batch_bf16 = _max_rel_gap(out[torch.bfloat16][SERVE_FRAMES], out[torch.bfloat16][8])
    batch_fp32 = _max_rel_gap(out[torch.float32][SERVE_FRAMES], out[torch.float32][8])
    bf16_fp32 = _max_rel_gap(out[torch.bfloat16][8], out[torch.float32][8])
    cpu_model = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
    cpu_spec, cpu_imgs = spec.to("cpu"), imgs.cpu()
    cpu = {dtype: decoded(cpu_model, cpu_spec, cpu_imgs, dtype, 8)
           for dtype in (torch.bfloat16, torch.float32)}
    cpu_bf16_fp32 = _max_rel_gap(cpu[torch.bfloat16], cpu[torch.float32])
    fp32_card_cpu = _max_rel_gap(out[torch.float32][8], cpu[torch.float32])
    keys = {k: (f"{v:.2e}", f"{c:.2e}") for (k, v), c in zip(
        by_key(out[torch.bfloat16][8], out[torch.float32][8]).items(),
        by_key(cpu[torch.bfloat16], cpu[torch.float32]).values())}
    log(f"  the checkpoint's model on these frames, one batch of {SERVE_FRAMES} against batches "
        f"of 8 (max |Δ| / max(1, |8s|)): bf16 {batch_bf16:.3e}, float32 {batch_fp32:.3e} "
        f"(tolerance {SERVE_FP32_TOL:g}); bf16 against float32 in batches of 8: card "
        f"{bf16_fp32:.3e}, CPU {cpu_bf16_fp32:.3e}, by key (card, CPU) {keys}; backbone's "
        f"pooled features, bf16 against float32, max |Δ| / max |float32|: card "
        f"{pooled_gap(model, imgs):.3e}, CPU {pooled_gap(cpu_model, cpu_imgs):.3e}; float32 card "
        f"against CPU {fp32_card_cpu:.3e}")
    check(batch_fp32 <= SERVE_FP32_TOL, f"run_inference's model: float32 in one batch of "
                                        f"{SERVE_FRAMES} differs from batches of 8 by {batch_fp32:.3e}")
    check(batch_bf16 <= SERVE_BF16_TOL, f"run_inference's model: bf16 batch gap {batch_bf16:.3e}")
    check(fp32_card_cpu <= SERVE_FP32_TOL, f"run_inference's model: float32 card against CPU "
                                           f"{fp32_card_cpu:.3e}")
    return {"seconds": secs, "frames_per_s": SERVE_FRAMES / secs, "npz_vs_direct": gap,
            "batch16_vs_8_bf16": batch_bf16, "batch16_vs_8_fp32": batch_fp32,
            "bf16_vs_fp32_batch8": bf16_fp32, "cpu_bf16_vs_fp32_batch8": cpu_bf16_fp32,
            "fp32_card_vs_cpu": fp32_card_cpu}


def serving_multiview_data(toy, dev):
    """SERVE_MV_SAMPLES samples of synthesize_multiview at 224² (K1 counted,
    and held to its plain version at that shape) through DeviceDataCache
    batches into 5a's model, then BenchmarkAccumulator."""
    from smilify_tpu_torch.data.synthetic import synthesize_multiview
    from smilify_tpu_torch.models.multiview import (
        decode_multiview_predictions,
        project_through_view_cameras,
    )
    from smilify_tpu_torch.models.regressor import float32_region, forward_model
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.train.benchmark import BenchmarkAccumulator
    from smilify_tpu_torch.train.trainer import DeviceDataCache

    zero_counts()
    samples = synthesize_multiview(toy, SERVE_MV_SAMPLES, SERVE_MV_VIEWS, SERVE_RES,
                                   chunk_size=SERVE_MV_CHUNK, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    n_k1 = SERVE_MV_VIEWS * math.ceil(SERVE_MV_SAMPLES / SERVE_MV_CHUNK)
    check(counts["exact_fwd"] == n_k1, f"synthesize_multiview at {SERVE_RES}²: K1 launched "
                                       f"{counts['exact_fwd']} times, expected {n_k1}")
    k1 = data_k1_phase(toy, dev, np.stack([s["images"] for s in samples]), SERVE_MV_VIEWS,
                       SERVE_RES, SERVE_MV_CHUNK, "multi-view serving")
    k1["launches"] = counts["exact_fwd"]
    cache = DeviceDataCache(samples, device=dev)
    cfg, model = bench_all.multiview_model(toy, SERVE_MV_VIEWS, SERVE_RES)
    perturb_zero_params(model)
    acc = BenchmarkAccumulator()
    vm = torch.ones((SERVE_MV_BATCH, SERVE_MV_VIEWS), dtype=torch.bool, device=dev)
    cids = torch.arange(SERVE_MV_VIEWS, device=dev).expand(SERVE_MV_BATCH, SERVE_MV_VIEWS)
    zero_counts()
    t0 = time.perf_counter()
    n = 0
    with torch.no_grad():
        for batch in cache.iterate(SERVE_MV_BATCH, np.random.default_rng(0), shuffle=False):
            raw, _ = model(batch["images"], vm, cids)
            with float32_region(dev):
                preds = decode_multiview_predictions(cfg, raw, toy)
                _, joints3d = forward_model(toy, preds)
                kp2d = project_through_view_cameras(preds, joints3d, (SERVE_RES, SERVE_RES))
            gt2d = batch["keypoints_2d"].flip(-1).cpu().numpy() / SERVE_RES   # (x, y) px → (y, x)
            acc.add_2d(kp2d.cpu().numpy(), gt2d, batch["keypoint_visibility"].cpu().numpy(), SERVE_RES)
            acc.add_3d(joints3d.cpu().numpy(), batch["keypoints_3d"].cpu().numpy())
            n += batch["images"].shape[0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = read_counts()
    curve, stats = acc.pck_curve("input"), acc.mpjpe_stats()
    n_2d = int(sum(e.size for e in acc.pixel_errors_input))
    log(f"  multi-view serving: {n} samples × {SERVE_MV_VIEWS} views at {SERVE_RES}² from "
        f"DeviceDataCache ({cache.bytes} bytes) in {secs:.3f} s = {n / secs:.1f} frames/s; "
        f"K1 launches in synthesize_multiview {counts['exact_fwd']}, in serving {after}; "
        f"PCK@10 {curve.get(10)}, PCK@50 {curve.get(50)} over {n_2d} visible keypoints; "
        f"MPJPE {stats}")
    check(n == SERVE_MV_SAMPLES, f"multi-view serving: {n} samples")
    check(n_2d > 0 and all(math.isfinite(v) for v in curve.values()), "multi-view serving: PCK")
    check(stats.get("n", 0) > 0 and all(math.isfinite(v) for v in stats.values()),
          "multi-view serving: MPJPE not finite")
    return {"k1": k1, "frames_per_s": n / secs}


def serving_bench_and_profile(spec, dev, card):
    """bench_all configs 4, 5a, 5b with short windows; then config 4 at
    B=PROFILE_B in bf16 under the profiler: busy share, top operations, the
    FLOPs its layers' shapes give and the mfu."""
    from smilify_tpu_torch.models.regressor import decode_predictions, float32_region
    from smilify_tpu_torch.tools import bench_all

    report = bench_all.run(spec, only=["config4_", "config5a", "config5b"], repeats=1,
                           target_s=0.5)
    for key, res in report.items():
        log(f"  bench_all {key}: " + json.dumps(res))
        check(all(v > 0 and math.isfinite(v) for k, v in res.items()
                  if k.endswith(("_ms", "_per_sec"))), f"bench_all {key}: a rate is not positive")
    c4, c5a, c5b = (report[k] for k in ("config4_singleview_resnet50",
                                        "config5a_multiview_4cam_stick",
                                        "config5b_multiview_18cam_mouse"))
    log(f"  serving rates ({card}): config4 {c4['batch8_images_per_sec']:.1f} images/s at B=8, "
        f"{c4['batch128_images_per_sec']:.1f} at B=128; config5a {c5a['stick4_b1_frames_per_sec']:.1f} "
        f"/ {c5a['stick4_b8_frames_per_sec']:.1f} frames/s at B=1 / 8; config5b "
        f"{c5b['mouse18_b1_frames_per_sec']:.1f} / {c5b['mouse18_b8_frames_per_sec']:.1f}")

    cfg, model = bench_all.singleview_model(spec, SERVE_RES)
    imgs = torch.rand(PROFILE_B, SERVE_RES, SERVE_RES, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def step():
        raw, _ = model(imgs)
        with float32_region(dev):
            return decode_predictions(cfg, raw, spec)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_name = device_ops(lambda: [step() for _ in range(PROFILE_STEPS)], host=False)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        flops = bench_all.count_flops(model.backbone, imgs) + bench_all.count_flops(
            model.head, model.backbone(imgs).tokens.float())
    mfu = flops / (wall_ms / 1e3) / PEAK_BF16_PER_S
    out = {"wall_ms": wall_ms, "flops": flops, "mfu": mfu}
    if by_name:
        busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / PROFILE_STEPS
        out.update(device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms)
        log(f"  config4 at B={PROFILE_B}, bf16: wall {wall_ms:.3f} ms a batch (unprofiled), device "
            f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(n for _, n in by_name.values()) / PROFILE_STEPS:.0f} device operations")
        log_device_ops(by_name, PROFILE_STEPS, 10)
    else:
        log("  profile: the profiler recorded no device events; busy share not measured")
    log(f"  config4 at B={PROFILE_B}: {flops / 1e9:.1f} GFLOP a batch (forward hooks), "
        f"{flops / (wall_ms / 1e3) / 1e12:.1f} TFLOP/s")
    log(f"mfu {mfu:.4f} (config4, B={PROFILE_B}, bf16, against {PEAK_BF16_PER_S / 1e12:.0f} "
        f"TFLOP/s dense bf16; {card})")
    check(0 < mfu < 1, f"config4: mfu {mfu} out of range")
    return {"config4": c4, "config5a": c5a, "config5b": c5b, "profile": out}


def serving_phase(toy, dev, card):
    """Phase 11: neural serving at full width (see the module docstring)."""
    work = ROOT / "build" / "smoke_serving"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"parity": serving_parity(toy, dev)}
    out["run_inference"] = serving_cli(toy, dev, work)
    out["multiview_data"] = serving_multiview_data(toy, dev)
    out.update(serving_bench_and_profile(toy, dev, card))
    return out


# phase 12, training on the card: bench_all configs 4b/4c/5c with short
# windows and config 4b's profile at B=128; one config-4b train step at B=2 in
# float32 (TF32 off), the card against the CPU; a learning check of the
# single-view regressor on 64 synthesize_multiview samples at 224² held in
# DeviceDataCache; the trainer CLIs on a 16-frame replicAnt folder at 224²;
# train_pointnet; the input-pipeline bench's modes at B=8, 10 steps each, on
# 16 PNG frames
TRAIN_CMP_B = 2
LEARN_SAMPLES, LEARN_VIEWS, LEARN_B, LEARN_STEPS, LEARN_NAN_AT = 64, 4, 16, 120, 60
LEARN_FALL = 4.0           # the learning check's loss must fall by this factor (measured 6.02x)
CLI_FRAMES, CLI_BATCH = 16, 4
PN_EPOCHS, PN_STEPS, PN_BATCH, PN_POINTS = 3, 30, 8, 1024
PIPE_MODES, PIPE_BATCH, PIPE_STEPS = ("synthetic", "serial", "threaded", "cached_staged"), 8, 10
PIPE_FRAMES = 16           # the folder the modes cycle through (two batches)
# one float32 train step, card against CPU, each gate ~4-20x the gap measured
# on the H100: the loss relative (9.42e-6); the gradients in relative L2
# (2.55e-2; the CPU against itself on fewer threads 3.34e-2: this loss at
# random weights projects keypoints from a camera near the body, and its
# gradients are ill-conditioned); the update in relative L2 over the elements
# whose gradients agree within 1% (5.04e-6, over 53.4% of them; Adam's first
# step is ±lr an element, so the others may differ by 2·lr); the BatchNorm
# statistics max |Δ| / max(1, max |CPU|) (8.10e-7)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL, TRAIN_STATS_TOL = 1e-4, 0.1, 1e-4, 1e-5
TRAIN_DECIDED_MIN = 0.3
# bf16 autocast of the backbone against float32 on the card: the loss,
# relative (measured 0.195)
TRAIN_BF16_LOSS_TOL = 0.5


def _rel_gap(a, b) -> float:
    """max |a − b| / max(1, max |b|), on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def training_rates(spec, dev, card):
    """(a): bench_all configs 4b/4c/5c (short windows) and config 4b at
    B=128 under the profiler: busy share and the top device operations."""
    from smilify_tpu_torch.tools import bench_all

    report = bench_all.run(spec, only=["config4b", "config4c", "config5c"], repeats=1,
                           target_s=0.3)
    for key, res in report.items():
        log(f"  bench_all {key}: " + json.dumps(res))
        check(all(v > 0 and math.isfinite(v) for k, v in res.items()
                  if k.endswith(("_ms", "_per_sec", "mfu"))), f"bench_all {key}: a rate is not positive")
        check(0 < res["mfu"] < 1, f"bench_all {key}: mfu {res['mfu']} out of range")
    c4b, c4c, c5c = (report[k] for k in ("config4b_singleview_train_step",
                                         "config4c_singleview_train_step_gn",
                                         "config5c_multiview_train_step"))
    log(f"  training rates ({card}): config4b {c4b['batch32_images_per_sec']:.1f} / "
        f"{c4b['batch128_images_per_sec']:.1f} images/s at B=32 / 128 (mfu {c4b['batch32_mfu']:.4f} / "
        f"{c4b['batch128_mfu']:.4f}); config4c {c4c['batch32_images_per_sec']:.1f} / "
        f"{c4c['batch128_images_per_sec']:.1f} (mfu {c4c['batch32_mfu']:.4f} / {c4c['batch128_mfu']:.4f}); "
        f"config5c {c5c['batch2_frames_per_sec']:.1f} / {c5c['batch8_frames_per_sec']:.1f} frames/s "
        f"at B=2 / 8 ({c5c['batch8_view_images_per_sec']:.1f} view images/s, mfu "
        f"{c5c['batch2_mfu']:.4f} / {c5c['batch8_mfu']:.4f})")

    _, model, step, make_batch = bench_all.singleview_train_setup(spec)
    batch = make_batch(PROFILE_B, np.random.RandomState(0))
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_name = device_ops(lambda: [step(batch) for _ in range(PROFILE_STEPS)], host=False)
    out = {"wall_ms": wall_ms}
    if by_name:
        busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / PROFILE_STEPS
        out.update(device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms)
        log(f"  config4b at B={PROFILE_B}, bf16: wall {wall_ms:.3f} ms a step (unprofiled), device "
            f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(n for _, n in by_name.values()) / PROFILE_STEPS:.0f} device operations a step")
        log_device_ops(by_name, PROFILE_STEPS, 12)
    else:
        log("  profile: the profiler recorded no device events; busy share not measured")
    return {"config4b": c4b, "config4c": c4c, "config5c": c5c, "profile_4b": out}


def _global_rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖ over every tensor of the two lists together, on the CPU."""
    d = sum(float(((g.detach().double().cpu() - w.detach().double().cpu()) ** 2).sum())
            for g, w in zip(got, want))
    return (d / sum(float((w.detach().double().cpu() ** 2).sum()) for w in want)) ** 0.5


def training_parity(toy, dev, card):
    """(b): one config-4b train step at B=TRAIN_CMP_B in float32 (TF32 off)
    from the same weights and batch on the card and on the CPU: the loss;
    the gradients (relative L2 over all of them, beside the CPU against
    itself on half its threads: this loss's gradients at random weights are
    ill-conditioned); the parameters after the step (Adam's
    first step is ±lr an element: within 2·lr everywhere, and equal where
    the two gradients agree within 1%); the BatchNorm statistics; and the
    loss of the bf16 step against float32 on the card."""
    from smilify_tpu_torch.tools import bench_all

    def setup(spec, dtype):
        _, model, step, make_batch = bench_all.singleview_train_setup(spec, compute_dtype=dtype)
        perturb_zero_params(model)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss, _ = step(make_batch(TRAIN_CMP_B, np.random.RandomState(3)))
        return model, start, float(loss)

    cpu_spec = toy.to("cpu")
    on_card, card_start, card_loss = setup(toy, torch.float32)
    cpu, cpu_start, cpu_loss = setup(cpu_spec, torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))     # the CPU's float sums in another order
    ref, _, _ = setup(cpu_spec, torch.float32)
    torch.set_num_threads(threads)
    check(all(torch.equal(card_start[n].cpu(), cpu_start[n]) for n in cpu_start),
          "training parity: the two models start from different weights")
    names = list(cpu_start)
    cp, pp, rp = (dict(m.named_parameters()) for m in (on_card, cpu, ref))
    grad_gap = _global_rel_l2([cp[n].grad for n in names], [pp[n].grad for n in names])
    grad_ref = _global_rel_l2([rp[n].grad for n in names], [pp[n].grad for n in names])
    param_max = max(float((cp[n].detach().cpu() - pp[n].detach()).abs().max()) for n in names)
    decided = {n: ((cp[n].grad.cpu() - pp[n].grad).abs() * 100 < pp[n].grad.abs()) for n in names}
    kept = sum(int(decided[n].sum()) for n in names) / sum(decided[n].numel() for n in names)
    update_gap = _global_rel_l2(
        [(cp[n].detach().cpu() - cpu_start[n]) * decided[n] for n in names],
        [(pp[n].detach() - cpu_start[n]) * decided[n] for n in names])
    card_sd, cpu_sd = on_card.state_dict(), cpu.state_dict()
    stats = [k for k in cpu_sd if k.endswith(("running_mean", "running_var"))]
    stats_gap = max(_rel_gap(card_sd[k], cpu_sd[k]) for k in stats)
    loss_gap = abs(card_loss - cpu_loss) / max(1.0, abs(cpu_loss))
    _, _, bf16_loss = setup(toy, torch.bfloat16)
    bf16_gap = abs(bf16_loss - card_loss) / max(1.0, abs(card_loss))
    lr = bench_all.TRAIN_LR
    log(f"  one config-4b train step at B={TRAIN_CMP_B}, float32, card ({card}) vs CPU: loss {card_loss:.6f} "
        f"vs {cpu_loss:.6f}, gap {loss_gap:.3e} (gate {TRAIN_LOSS_TOL:g}); gradients, relative L2 "
        f"{grad_gap:.3e} (gate {TRAIN_GRAD_TOL:g}; the CPU against itself on "
        f"{max(1, threads // 2)} of its {threads} threads {grad_ref:.3e}); parameters after the "
        f"step: max |Δ| {param_max:.3e} (gate 2·lr = {2 * lr:g}), relative L2 of the update over the {100 * kept:.1f}% of elements whose "
        f"gradients agree within 1% {update_gap:.3e} (gate {TRAIN_UPDATE_TOL:g}); BatchNorm "
        f"statistics over {len(stats)} tensors {stats_gap:.3e} (gate {TRAIN_STATS_TOL:g}); bf16 "
        f"step's loss {bf16_loss:.6f} against float32 {bf16_gap:.3e} (bound {TRAIN_BF16_LOSS_TOL:g})")
    check(math.isfinite(card_loss) and math.isfinite(bf16_loss), "training parity: loss")
    check(loss_gap <= TRAIN_LOSS_TOL, f"training parity: loss gap {loss_gap:.3e}")
    check(grad_gap <= TRAIN_GRAD_TOL, f"training parity: gradient gap {grad_gap:.3e}")
    check(param_max <= 2 * lr * (1 + 1e-3), f"training parity: a parameter moved {param_max:.3e}")
    check(update_gap <= TRAIN_UPDATE_TOL and kept >= TRAIN_DECIDED_MIN,
          f"training parity: update gap {update_gap:.3e} over {kept:.3f} of the elements")
    check(stats_gap <= TRAIN_STATS_TOL, f"training parity: BatchNorm statistics gap {stats_gap:.3e}")
    check(bf16_gap <= TRAIN_BF16_LOSS_TOL, f"training parity: bf16 loss gap {bf16_gap:.3e}")
    return {"loss": loss_gap, "grads": grad_gap, "grads_cpu_vs_cpu": grad_ref,
            "param_max_abs": param_max, "update_decided": update_gap, "decided_share": kept,
            "bn_stats": stats_gap, "bf16_loss": bf16_gap}


def learning_check(toy, dev, card):
    """(c): the single-view regressor (config 4b's model, bf16 backbone,
    build_optimizer's Adam with the clip and the non-finite skip) trained on
    LEARN_SAMPLES synthesize_multiview samples at 224² (view 0) held in
    DeviceDataCache for LEARN_STEPS steps; step LEARN_NAN_AT gets a NaN
    target: it must move no parameter and not Adam's step count."""
    from smilify_tpu_torch.cli.train_regressor import make_singleview_apply_fn
    from smilify_tpu_torch.data.synthetic import synthesize_multiview
    from smilify_tpu_torch.models.regressor import compute_batch_loss
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.train.config import load_config
    from smilify_tpu_torch.train.trainer import DeviceDataCache, build_optimizer, make_train_step

    zero_counts()
    samples = synthesize_multiview(toy, LEARN_SAMPLES, LEARN_VIEWS, SERVE_RES,
                                   chunk_size=SERVE_MV_CHUNK, device=dev)
    torch.cuda.synchronize()
    k1 = read_counts()["exact_fwd"]
    n_k1 = LEARN_VIEWS * math.ceil(LEARN_SAMPLES / SERVE_MV_CHUNK)
    check(k1 == n_k1, f"learning check: synthesize_multiview launched K1 {k1} times, expected {n_k1}")
    cache = DeviceDataCache(samples, device=dev)
    cfg, model, _, _ = bench_all.singleview_train_setup(toy)
    tcfg = load_config(None, overrides={"optimizer.optimizer_type": "adam"})
    opt = build_optimizer(tcfg, 1e-4, False, model)
    weights = dict(bench_all.TRAIN_WEIGHTS)

    def loss_fn(preds, batch):
        targets = {k: batch[k] for k in ("global_rot", "joint_rot", "betas")}
        targets["keypoints_2d"] = batch["keypoints_2d"][:, 0].flip(-1) / SERVE_RES
        targets["kp_visibility"] = batch["keypoint_visibility"][:, 0]
        return compute_batch_loss(toy, cfg, preds, targets, weights, image_size=(SERVE_RES,) * 2)

    apply_one = make_singleview_apply_fn(cfg, toy)
    step = make_train_step(model, lambda m, b, t: apply_one(m, {"image": b["images"][:, 0]}, t),
                           loss_fn, opt)
    rng = np.random.default_rng(0)
    zero_counts()
    losses, skipped = [], None
    t0 = time.perf_counter()
    while len(losses) < LEARN_STEPS:
        for batch in cache.iterate(LEARN_B, rng):
            if len(losses) == LEARN_NAN_AT:
                bad = dict(batch, betas=batch["betas"].clone())
                bad["betas"][0, 0] = float("nan")
                before = [p.detach().clone() for p in opt.params]
                adam_before = float(opt.adam_step())
                loss, _ = step(bad)
                moved = sum(int(not torch.equal(a, p)) for a, p in zip(before, opt.params))
                skipped = {"loss": float(loss), "params_moved": moved,
                           "adam_step": (adam_before, float(opt.adam_step())),
                           "notfinite_count": int(opt.notfinite_count)}
                losses.append(float("nan"))
                continue
            loss, _ = step(batch)
            losses.append(loss)
            if len(losses) == LEARN_STEPS:
                break
    losses = [float(v) for v in losses]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    epoch = LEARN_SAMPLES // LEARN_B
    first = float(np.mean(losses[:epoch]))
    last = float(np.mean(losses[-epoch:]))
    log(f"  learning check ({card}): {LEARN_STEPS} steps of B={LEARN_B} over {LEARN_SAMPLES} samples "
        f"at {SERVE_RES}² from DeviceDataCache ({cache.bytes} bytes), {secs:.2f} s; mean loss of the "
        f"first epoch {first:.5f}, of the last {last:.5f}: fell {first / last:.2f}x (gate "
        f"{LEARN_FALL:g}x); K1 launches in synthesize_multiview {k1}, in training {counts}")
    log(f"  non-finite batch at step {LEARN_NAN_AT}: loss {skipped['loss']}, parameters moved "
        f"{skipped['params_moved']}, Adam step {skipped['adam_step'][0]:.0f} -> "
        f"{skipped['adam_step'][1]:.0f}, consecutive non-finite count {skipped['notfinite_count']}")
    check(all(math.isfinite(v) for i, v in enumerate(losses) if i != LEARN_NAN_AT),
          "learning check: a non-finite loss")
    check(first / last >= LEARN_FALL, f"learning check: the loss fell {first / last:.2f}x")
    check(not math.isfinite(skipped["loss"]) and skipped["params_moved"] == 0
          and skipped["adam_step"][0] == skipped["adam_step"][1] and skipped["notfinite_count"] == 1,
          f"learning check: the non-finite step was not skipped: {skipped}")
    check(int(opt.notfinite_count) == 0, "learning check: the skip count did not reset")
    check(sum(counts.values()) == 0, f"learning check: training launched kernels {counts}")
    return {"first_epoch_loss": first, "last_epoch_loss": last, "fall": first / last,
            "seconds": secs, "skipped": skipped, "k1_launches": k1}


def training_cli(toy, dev, work, card):
    """(d): train_regressor 2 epochs on a CLI_FRAMES-frame replicAnt folder
    at 224², once from DeviceDataCache and once through the host pipeline
    with thread workers; each writes best_model and final_model; then
    run_inference serves final_model on the card."""
    from smilify_tpu_torch.cli import run_inference, train_regressor
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence

    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    folder, _ = write_replicant_sequence(str(work / "seq"), toy, CLI_FRAMES, SERVE_RES,
                                         layout="unreal")
    out = {}
    for label, extra in (("device_cache", ["training.device_data_cache=true"]),
                         ("host_threads", ["training.num_workers=2", "training.worker_mode=thread"])):
        run = work / label
        zero_counts()
        t0 = time.perf_counter()
        state = train_regressor.main([
            "--model", pkl, "--data-path", folder, "--epochs", "2", "--output-dir", str(run),
            "--device", dev.type, "--set", "model.backbone_name=resnet50",
            f"model.input_resolution={SERVE_RES}", f"training.batch_size={CLI_BATCH}",
            "model.freeze_backbone=false", "dataset.train_ratio=0.5", "dataset.val_ratio=0.25",
            "dataset.test_ratio=0.25", "dataset.dataset_fraction=1.0",
            "training.use_mixed_precision=true", "output.num_visualization_samples=2", *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = sorted(p.name for p in run.glob("*.pt"))
        hist = [(h["epoch"], round(h["loss"], 5), round(h.get("val_loss", float("nan")), 5))
                for h in state.history]
        log(f"  train_regressor ({label}; {card}): 2 epochs, {secs:.2f} s; (epoch, loss, val_loss) {hist}; "
            f"checkpoints {files}; kernel launches {read_counts()}")
        check(len(state.history) == 2 and all(math.isfinite(h["loss"]) and
                                              math.isfinite(h.get("val_loss", float("nan")))
                                              for h in state.history),
              f"train_regressor ({label}): losses {hist}")
        check({"best_model.pt", "final_model.pt"} <= set(files),
              f"train_regressor ({label}): checkpoints {files}")
        out[label] = {"seconds": secs, "history": state.history}
    zero_counts()
    t0 = time.perf_counter()
    traj = run_inference.main(["--checkpoint", str(work / "host_threads" / "final_model"),
                               "--data-path", folder, "--device", dev.type])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  run_inference on host_threads/final_model ({card}): {CLI_FRAMES} frames in {secs:.2f} s; "
        f"outputs {sorted(traj)}; kernel launches {read_counts()}")
    check(all(np.isfinite(np.asarray(v)).all() and len(v) == CLI_FRAMES for v in traj.values()),
          "run_inference on the trained checkpoint: non-finite or missing predictions")
    out["run_inference_seconds"] = secs
    return out


def training_pointnet(toy, dev, work, card):
    """(e): train_pointnet for PN_EPOCHS epochs at constant sampling scales;
    the last epoch's mean loss must be below the first's."""
    from smilify_tpu_torch.cli import train_pointnet
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    pkl = write_model_pkl(str(work / "stick_width_pn.pkl"), toy)
    t0 = time.perf_counter()
    state = train_pointnet.main(["--model", pkl, "--epochs", str(PN_EPOCHS), "--steps-per-epoch",
                                 str(PN_STEPS), "--batch", str(PN_BATCH), "--points", str(PN_POINTS),
                                 "--output-dir", str(work / "pointnet"), "--device", dev.type])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in state.history]
    log(f"  train_pointnet ({card}): {PN_EPOCHS} epochs × {PN_STEPS} steps of {PN_BATCH} clouds × "
        f"{PN_POINTS} points, {secs:.2f} s; epoch losses {[round(v, 5) for v in losses]}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"train_pointnet: the loss did not fall {losses}")
    check((work / "pointnet" / "final_model.pt").exists(), "train_pointnet: no checkpoint")
    return {"seconds": secs, "losses": losses}


def training_input_pipeline(work, card):
    """(f): the port's input-pipeline bench, one process a mode."""
    from smilify_tpu_torch.tools import bench_input_pipeline

    t0 = time.perf_counter()
    report = bench_input_pipeline.main(["--modes", *PIPE_MODES, "--batch", str(PIPE_BATCH),
                                        "--steps", str(PIPE_STEPS), "--frames", str(PIPE_FRAMES),
                                        "--work", str(work / "pipeline")])
    log(f"  input pipeline ({card}), ms a step at B={PIPE_BATCH}, {PIPE_STEPS} steps, 224²: "
        + ", ".join(f"{m} {report[f'{m}_step_ms']:.2f}" for m in PIPE_MODES)
        + f" ({time.perf_counter() - t0:.1f} s)")
    check(all(report[f"{m}_step_ms"] > 0 for m in PIPE_MODES), "input pipeline: a mode's time")
    return report


def training_phase(toy, dev, card):
    """Phase 12: training on the card (see the constants above)."""
    work = ROOT / "build" / "smoke_training"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    for name, fn in (("rates", lambda: training_rates(toy, dev, card)),
                     ("parity", lambda: training_parity(toy, dev, card)),
                     ("learning", lambda: learning_check(toy, dev, card)),
                     ("cli", lambda: training_cli(toy, dev, work, card)),
                     ("pointnet", lambda: training_pointnet(toy, dev, work, card)),
                     ("input_pipeline", lambda: training_input_pipeline(work, card))):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    return out


# phase 13, slice 5 on the card. (a) serving export: config-4 and config-5a
# checkpoints (phase 11's widths, zero kernels drawn from a seed) exported
# with a symbolic batch for cuda, loaded in a fresh process that imports only
# torch and the serving module, B=1/8/128 (5a: 1/8) held to the live model;
# export_serving --verify, and --shard-data over the one card. (b) one rank
# on NCCL through torch.distributed.run and (c) two ranks on the one card
# over gloo: the sharded fitters against their unsharded counterparts and
# config 4b's data-parallel train step against the single-process one
EXPORT_ATOL = 1e-4                 # the artifact against the live model (export_serving --verify)
EXPORT_BATCHES = {"config4": (1, 8, 128), "config5a": (1, 8)}
EXPORT_TIMED = (8, 128)            # config 4's artifact against the live model, images/s
EXPORT_REPS = 10
SCALE_FRAMES, SCALE_CAP = 10, 800
SCALE_CLIPS = 4
SCALE_DDP_B = 128
# the JAX tests' gates (tests/test_fitter_frames.py, test_fitter_batch.py,
# test_fitter3d.py): loss trajectory (rtol, atol), end parameters (rtol, atol)
SCALE_SEQ_TOL = ((1e-3, 1e-6), (3e-3, 3e-3))
SCALE_CLIPS_TOL = ((2e-4, 1e-6), (3e-3, 1e-3))
SCALE_GRID_TOL = ((1e-3, 1e-6), (3e-3, 3e-3))
# GridShardedFitter 1 × 2 on two ranks of the card is held to the JAX gate
# against BatchedFitter with the frames a launch of a rank (the clips in
# halves): the raster's and the products' float sums change with the frames
# a launch, and Adam turns gradients that are rounding noise (the leaf
# joints' log_beta_scales, fed by 2 frames a clip) into steps of ±lr, so
# BatchedFitter at 8 frames a launch lands ~7× the parameter gate from the
# same fit at 4 (logged beside the check). A planted fault, the frame-mean
# terms without their 1/Df, must land outside the gate
SCALE_REG_TOL = ((1e-4, 1e-7), (3e-3, 3e-3))
# the two-stage schedule of tests/test_fitter_frames.py (stage 0 torso only)
SCALE_SCHEDULE = (
    dict(num_iters=3, lr=1e-2, w_j2d=1.0, w_reproj=0.0, w_betas=0.0, w_pose=0.0, w_limit=0.0,
         w_splay=0.0, w_temp=0.0),
    dict(num_iters=4, lr=1e-2, w_j2d=1.0, w_reproj=0.5, w_betas=0.1, w_pose=0.01, w_limit=0.01,
         w_splay=0.01, w_temp=0.5),
)
SCALE_RANK_TIMEOUT = 300
DDP_STATS_TOL_2RANKS = 1e-6        # 2 × 64 against 128: the running statistics, relative
DDP_RATE_STEPS = 5


def _export_checkpoints(toy, work):
    """Config-4 and config-5a checkpoints (ResNet-50 + IEF 256 × 4 × 3 at
    224², bf16 backbone; 5a with 4 views) written by save_checkpoint."""
    from smilify_tpu_torch.models.weight_port import build_model
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.train.config import load_config, resolve_model_spec
    from smilify_tpu_torch.train.trainer import TrainState, save_checkpoint

    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    ckpts = {}
    for label, mode in (("config4", "single_view"), ("config5a", "multi_view")):
        cfg = load_config(None, overrides={
            "smal_model.smal_file": pkl, "model.backbone_name": "resnet50",
            "model.input_resolution": SERVE_RES, "model.transformer_depth": 4,
            "model.transformer_heads": 8, "model.transformer_dim_head": 32,
            "model.transformer_mlp_dim": 1024, "model.transformer_ief_iters": 3,
            "multiview.num_views_to_use": SERVE_MV_VIEWS,
            "training.use_mixed_precision": True}, mode=mode)
        rcfg = cfg.regressor_config(resolve_model_spec(cfg, device="cpu"))
        torch.manual_seed(0)
        model = perturb_zero_params(build_model(rcfg, img_size=SERVE_RES))
        ckpts[label] = save_checkpoint(str(work / label), TrainState(model.state_dict()), cfg,
                                       "final_model")
    return ckpts


def export_inputs(label, batch):
    """The serving inputs of ``label`` at ``batch``, from a seed (numpy): the
    fresh process and this one make the same."""
    rng = np.random.RandomState(1000 * batch + (5 if label == "config5a" else 4))
    if label == "config4":
        return (rng.rand(batch, SERVE_RES, SERVE_RES, 3).astype(np.float32),)
    V = SERVE_MV_VIEWS
    mask = np.ones((batch, V), bool)
    mask[0, -1] = False
    return (rng.rand(batch, V, SERVE_RES, SERVE_RES, 3).astype(np.float32), mask,
            np.tile(np.arange(V, dtype=np.int32), (batch, 1)))


def _rate(fn, batch, reps=EXPORT_REPS):
    """Items a second of ``fn()`` over ``reps`` calls after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def serve_fresh(artifacts, out_npz):
    """The fresh process's body: only torch and the serving module (TF32
    off, as every entry point of the port sets it)."""
    import smilify_tpu_torch.serve as serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    outs, rates = {}, {}
    for label, path in artifacts.items():
        model = serve.load_serving_artifact(path)
        for b in EXPORT_BATCHES[label]:
            inputs = tuple(torch.from_numpy(a).to("cuda") for a in export_inputs(label, b))
            got = model(*inputs)
            outs.update({f"{label}_{b}_{k}": v.float().cpu().numpy() for k, v in got.items()})
            if label == "config4" and b in EXPORT_TIMED:
                rates[b] = _rate(lambda: model(*inputs), b)
    np.savez(out_npz, **outs)
    loaded = sorted(n for n in sys.modules if n.startswith("smilify_tpu"))
    print(json.dumps({"rates": rates, "modules": loaded}), flush=True)


def serving_export_phase(toy, dev, card):
    """(a): export, load in a fresh process, serve B=1/8/128 from one
    symbolic artifact against the live model; --verify; --shard-data."""
    from smilify_tpu_torch import serve
    from smilify_tpu_torch.cli import export_serving
    from smilify_tpu_torch.cli.run_inference import load_model_from_checkpoint

    work = ROOT / "build" / "smoke_serving_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpts = _export_checkpoints(toy, work)
    arts, out = {}, {}
    for label, ckpt in ckpts.items():
        arts[label] = str(work / f"{label}.pt2z")
        t0 = time.perf_counter()
        if label == "config4":
            meta = export_serving.main(["--checkpoint", ckpt, "--output", arts[label],
                                        "--platforms", "cuda", "--verify"])
        else:
            meta = serve.export_serving_artifact(ckpt, arts[label], platforms=("cuda",))
        secs = time.perf_counter() - t0
        out[label] = {"artifact_bytes": meta["artifact_bytes"], "export_s": secs,
                      "verify_max_abs": meta.get("verify_max_abs")}
        log(f"  {label}: exported with a symbolic batch in {secs:.1f} s, "
            f"{meta['artifact_bytes']:,} bytes; outputs {meta['output_keys']}"
            + (f"; export_serving --verify max |Δ| {meta['verify_max_abs']:.3e}"
               if "verify_max_abs" in meta else ""))
        check(meta["batch_size"] == "symbolic", f"{label}: the artifact's batch is not symbolic")
    meta = export_serving.main(["--checkpoint", ckpts["config4"], "--output",
                                str(work / "config4_sharded.pt2z"), "--batch", "8",
                                "--platforms", "cuda", "--shard-data", "--verify"])
    check(meta["data_sharded"] and meta["n_devices"] == torch.cuda.device_count(),
          f"--shard-data: n_devices {meta['n_devices']}")
    out["shard_data"] = {"n_devices": meta["n_devices"], "verify_max_abs": meta["verify_max_abs"]}
    log(f"  export_serving --shard-data --batch 8: {meta['n_devices']} card(s), --verify max |Δ| "
        f"{meta['verify_max_abs']:.3e}")

    code = ("import sys, json; sys.path.insert(0, {root!r}); import chip_smoke; "
            "chip_smoke.serve_fresh({arts!r}, {npz!r})").format(
        root=str(ROOT), arts=arts, npz=str(work / "served.npz"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))
    check(proc.returncode == 0, f"the fresh serving process failed:\n{proc.stderr[-3000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  fresh process ({time.perf_counter() - t0:.1f} s): modules of the package it "
        f"imported {fresh['modules']}")
    check(fresh["modules"] == ["smilify_tpu_torch", "smilify_tpu_torch.serve"],
          f"the serving process imported {fresh['modules']}")
    served = dict(np.load(work / "served.npz"))
    for label, ckpt in ckpts.items():
        model, cfg, rcfg, spec, _ = load_model_from_checkpoint(ckpt, device=dev)
        predict = serve.build_predict_fn(model, rcfg, spec, cfg.mode == "multi_view")
        gaps = {}
        for b in EXPORT_BATCHES[label]:
            inputs = tuple(torch.from_numpy(a).to(dev) for a in export_inputs(label, b))
            with torch.no_grad():
                live = predict(*inputs)
            gaps[b] = max(float(np.abs(served[f"{label}_{b}_{k}"] - v.float().cpu().numpy()).max())
                          for k, v in live.items())
            check(sorted(k for k in served if k.startswith(f"{label}_{b}_"))
                  == sorted(f"{label}_{b}_{k}" for k in live), f"{label} B={b}: output keys")
            if label == "config4" and b in EXPORT_TIMED:
                with torch.no_grad():
                    out[label][f"live_b{b}_images_per_s"] = _rate(lambda: predict(*inputs), b)
                out[label][f"artifact_b{b}_images_per_s"] = fresh["rates"][str(b)]
        out[label]["max_abs_vs_live"] = gaps
        log(f"  {label}: the artifact against the live model, max |Δ| over every output key by "
            f"batch {gaps} (gate {EXPORT_ATOL:g})")
        for b, g in gaps.items():
            check(g <= EXPORT_ATOL, f"{label} B={b}: the artifact is {g:.3e} from the live model")
        del model, predict
        torch.cuda.empty_cache()
    out["run_inference_shard"] = run_inference_shard(toy, dev, ckpts["config4"], work)
    c4 = out["config4"]
    log(f"  config4 images/s ({card}; logged, not gated): artifact "
        + ", ".join(f"B={b} {c4[f'artifact_b{b}_images_per_s']:.1f}" for b in EXPORT_TIMED)
        + "; live model " + ", ".join(f"B={b} {c4[f'live_b{b}_images_per_s']:.1f}"
                                      for b in EXPORT_TIMED))
    return out


def run_inference_shard(toy, dev, ckpt, work):
    """run_inference --shard (the model replicated on every visible card,
    strided shares of each batch) against the run without it, on 16
    replicAnt frames at 224² from the config-4 checkpoint."""
    from smilify_tpu_torch.cli import run_inference
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence

    folder, _ = write_replicant_sequence(str(work / "seq"), toy, SERVE_FRAMES, SERVE_RES,
                                         layout="unreal")
    runs = {}
    for label, extra in (("one", []), ("shard", ["--shard"])):
        t0 = time.perf_counter()
        runs[label] = run_inference.main(["--checkpoint", ckpt, "--data-path", folder,
                                          "--device", dev.type] + extra)
        runs[label + "_s"] = time.perf_counter() - t0
    n = torch.cuda.device_count()
    gap = max(float(np.abs(runs["shard"][k] - v).max()) / max(1.0, float(np.abs(v).max()))
              for k, v in runs["one"].items())
    # one card: the same batches; several: bf16 convolutions of smaller shares
    gate = SERVE_FP32_TOL if n == 1 else SERVE_BF16_TOL
    log(f"  run_inference --shard over {n} card(s): {runs['shard_s']:.2f} s against "
        f"{runs['one_s']:.2f} s, predictions max |Δ| / max(1, |one|) {gap:.3e} (gate {gate:g})")
    check(sorted(runs["shard"]) == sorted(runs["one"]) and gap <= gate,
          f"run_inference --shard: {gap:.3e} from the run without it")
    return {"cards": n, "seconds": runs["shard_s"], "seconds_one": runs["one_s"], "gap": gap}


def scaleout_launch(nproc, backend, work):
    """``torch.distributed.run`` of this script's rank role on ``nproc``
    ranks of the one card; every rank's results."""
    for p in work.glob(f"scaleout_{backend}_*.json"):
        p.unlink()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), "--scaleout-rank",
           backend, str(work)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SCALE_RANK_TIMEOUT,
                          cwd=str(ROOT))
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("  ", "rank")):
            log("  " + line)
    check(proc.returncode == 0, f"{nproc} rank(s) over {backend} failed ({proc.returncode}):\n"
                                f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    outs = [json.loads((work / f"scaleout_{backend}_{r}.json").read_text()) for r in range(nproc)]
    log(f"  {nproc} rank(s) over {backend}: {secs:.1f} s, launch included")
    return outs, secs


def _traj_params_gap(traj, ref_traj, params, ref_params, tol, what, gated=True):
    """Hold a fit's trajectory and end parameters to the reference's (with
    ``gated=False`` only measure the gaps)."""
    (t_rtol, t_atol), (p_rtol, p_atol) = tol
    traj, ref_traj = np.asarray(traj), np.asarray(ref_traj)
    check(len(traj) == len(ref_traj), f"{what}: {len(traj)} steps against {len(ref_traj)}")
    traj_gap = float(np.max(np.abs(traj - ref_traj) / (t_atol + t_rtol * np.abs(ref_traj))))
    worst = {}
    for k, a in params.items():
        a, b = a.detach().cpu().double(), getattr(ref_params, k).detach().cpu().double()
        worst[k] = float(torch.max(torch.abs(a - b) / (p_atol + p_rtol * torch.abs(b))))
    p_gap = max(worst.values())
    log(f"    {what}: trajectory at {traj_gap:.3f} of its gate (rtol {t_rtol:g}, atol {t_atol:g}), "
        f"end parameters at {p_gap:.3f} of theirs (rtol {p_rtol:g}, atol {p_atol:g}; worst "
        f"{max(worst, key=worst.get)})")
    if gated:
        check(traj_gap <= 1.0, f"{what}: loss trajectory off the reference's")
        check(p_gap <= 1.0, f"{what}: end parameters off the reference's")
    return {"traj_of_gate": traj_gap, "params_of_gate": p_gap}


def _fit_traj(fitter):
    from smilify_tpu_torch.fitter.stages import StageWeights

    traj = []
    fitter.fit([StageWeights(**w) for w in SCALE_SCHEDULE], chunk=2,
               callback=lambda s, i, loss, o: traj.append(float(loss)))
    torch.cuda.synchronize()
    return traj


def scaleout_sequence(spec, dev, rank, world):
    """The frame-sharded fit of SCALE_FRAMES frames at 512² over a
    ``('frames',)`` mesh of every rank, exact and capped, against SmalFitter
    on the card; the raster launches of each."""
    from smilify_tpu_torch.fitter.fitter import FitParams, SmalFitter, synthetic_fit_data
    from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter
    from smilify_tpu_torch.train.multihost import make_mesh

    data = synthetic_fit_data(spec, SCALE_FRAMES, SIZE)
    mesh = make_mesh((world,), ("frames",), dev)
    out = {}
    for mode, cap in (("exact", None), ("capped", SCALE_CAP)):
        zero_counts()
        ref = SmalFitter(spec, data, SIZE, approx_max_faces=cap, device=dev)
        ref_traj = _fit_traj(ref)
        ref_counts = read_counts()
        zero_counts()
        t0 = time.perf_counter()
        sharded = ShardedSequenceFitter(spec, data, SIZE, mesh=mesh, approx_max_faces=cap,
                                        device=dev)
        traj = _fit_traj(sharded)
        secs = time.perf_counter() - t0
        counts = read_counts()
        full = sharded.gathered_params()
        log(f"rank {rank}: frame-sharded fit, {mode}: {sharded.n_local} of {sharded.n_frames} "
            f"frames on this rank, {secs:.2f} s; raster launches {counts}, unsharded {ref_counts}")
        gaps = _traj_params_gap(traj, ref_traj, {k: getattr(full, k) for k in FitParams.fields()},
                                ref.params, SCALE_SEQ_TOL, f"rank {rank}: frame-sharded {mode}")
        used = ("exact_fwd", "exact_bwd") if cap is None else ("worklist_fwd", "worklist_bwd")
        check(all(counts[k] == ref_counts[k] > 0 for k in used)
              and all(counts[k] == 0 for k in counts if k not in used),
              f"rank {rank}: frame-sharded {mode} launched {counts}, the unsharded fit {ref_counts}")
        out[mode] = dict(gaps, launches=counts, seconds=secs)
    return out


def scaleout_corpus(spec, dev, rank, mesh_shape):
    """ShardedBatchedFitter (1-D) and GridShardedFitter on ``mesh_shape``
    over SCALE_CLIPS clips of one frame a ``frames`` rank at 512², against
    BatchedFitter with the frames a launch of a rank (its clips cut into
    as many launches as the mesh has ``frames`` ranks); with more than one
    such rank, also the planted fault."""
    from smilify_tpu_torch.fitter import fitter_batch
    from smilify_tpu_torch.fitter.fitter import FitData, FitParams, synthetic_fit_data
    from smilify_tpu_torch.fitter.fitter_batch import (
        BatchedFitter,
        GridShardedFitter,
        ShardedBatchedFitter,
    )
    from smilify_tpu_torch.train.multihost import make_mesh

    n = mesh_shape[1]
    flat = synthetic_fit_data(spec, SCALE_CLIPS * n, SIZE, seed=7)
    data = FitData(rgb=None, **{k: getattr(flat, k).reshape((SCALE_CLIPS, n) + getattr(flat, k).shape[1:])
                                for k in ("sil", "joints", "visibility")})

    def batched(clips):
        fitter = BatchedFitter(spec, FitData(rgb=None, sil=data.sil[clips],
                                             joints=data.joints[clips],
                                             visibility=data.visibility[clips]), SIZE, device=dev)
        return _fit_traj(fitter), {k: getattr(fitter.params, k) for k in FitParams.fields()}

    cut = SCALE_CLIPS // n
    parts = [batched(slice(g * cut, (g + 1) * cut)) for g in range(n)]
    ref_traj = list(np.sum([t for t, _ in parts], axis=0))
    ref = FitParams(**{k: torch.cat([p[k] for _, p in parts]) for k in FitParams.fields()})
    out = {}
    if n > 1:
        one_traj, one = batched(slice(None))
        out["one_launch"] = _traj_params_gap(
            one_traj, ref_traj, one, ref, SCALE_GRID_TOL,
            f"rank {rank}: BatchedFitter at {SCALE_CLIPS * n} frames a launch against "
            f"{cut * n} (rounding, not gated)", gated=False)
    fitters = [("grid", GridShardedFitter, mesh_shape, ("clips", "frames"), SCALE_GRID_TOL)]
    if mesh_shape == (1, 1):
        fitters.insert(0, ("clips", ShardedBatchedFitter, (1,), ("clips",), SCALE_CLIPS_TOL))
    for name, cls, shape, axes, tol in fitters:
        zero_counts()
        fitter = cls(spec, data, SIZE, mesh=make_mesh(shape, axes, dev), device=dev)
        traj = _fit_traj(fitter)
        full = fitter.gathered_params()
        log(f"rank {rank}: {cls.__name__} on {SCALE_CLIPS} clips × {n} frame(s), mesh "
            f"{dict(zip(axes, shape))}: (clips, frames) {fitter.n_local} on this rank; raster "
            f"launches {read_counts()}")
        out[name] = _traj_params_gap(traj, ref_traj, {k: getattr(full, k) for k in FitParams.fields()},
                                     ref, tol, f"rank {rank}: {type(fitter).__name__}")
    if n > 1:
        kept = fitter_batch._FRAME_MEAN_TERMS
        fitter_batch._FRAME_MEAN_TERMS = frozenset()
        try:
            fitter = GridShardedFitter(spec, data, SIZE, mesh=make_mesh(mesh_shape, ("clips", "frames"), dev),
                                       device=dev)
            traj = _fit_traj(fitter)
            full = fitter.gathered_params()
        finally:
            fitter_batch._FRAME_MEAN_TERMS = kept
        planted = _traj_params_gap(traj, ref_traj, {k: getattr(full, k) for k in FitParams.fields()},
                                   ref, SCALE_GRID_TOL,
                                   f"rank {rank}: planted fault, no 1/Df (must fail)", gated=False)
        check(max(planted.values()) > 1.0, "the grid check passed a planted fault (no 1/Df)")
        out["planted_no_1_over_Df"] = planted
    return out


def scaleout_registration(dev, spec, rank, world):
    """ShardedStageManager on phase 9's 8 targets against StageManager (2
    stages of 6 steps at 3000 samples), in torch's default mode: two runs of
    StageManager must be at 0.000 of the gate (the gathers' backward adds in
    an order fixed by the indices, ``ops/gather.py``), the sharded run within
    the JAX test's gates of the single one."""
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter3d import (
        Fit3DParams,
        ShardedStageManager,
        Stage,
        StageManager,
        pad_target_meshes,
    )
    from smilify_tpu_torch.tools.synthetic_data import posed_target_meshes

    scan = toy_model_spec(75, 55, 5, seed=1, device=dev)
    faces = scan.faces.cpu().numpy()
    targets = pad_target_meshes([(v, faces) for v in posed_target_meshes(scan, 8, seed=7)],
                                [f"scan{i}" for i in range(8)], device=dev)

    from smilify_tpu_torch.train.multihost import make_mesh

    def run(cls, **kw):
        mgr = cls(spec, targets, seed=0, **kw)
        mgr.add_stage(Stage("init", "init", n_its=6, lr=0.01))
        mgr.add_stage(Stage("default", "default", n_its=6, lr=0.005))
        traj = []
        mgr.run(callback=lambda s, i, loss, o: traj.append(float(loss)), chunk=3)
        torch.cuda.synchronize()
        return mgr, traj

    def fields(params):
        return {k: getattr(params, k) for k in Fit3DParams.fields()}

    once, once_traj = run(StageManager)
    again, again_traj = run(StageManager)
    repeat = _traj_params_gap(again_traj, once_traj, fields(again.params), once.params,
                              SCALE_REG_TOL, f"rank {rank}: two runs of StageManager", gated=False)
    check(max(repeat.values()) == 0.0, f"rank {rank}: two runs of StageManager differ: {repeat}")
    sharded, traj = run(ShardedStageManager, mesh=make_mesh((world,), ("scans",), dev))
    out = _traj_params_gap(traj, once_traj, fields(sharded.gathered_params()), once.params,
                           SCALE_REG_TOL, f"rank {rank}: ShardedStageManager, 8 targets")
    return dict(out, default_runs=repeat)


def scaleout_ddp(spec, dev, rank, world):
    """Config 4b's train step in DistributedDataParallel over every rank at
    a global SCALE_DDP_B: float32 parity with the single-process step (rank
    0 holds the reference), then bf16 images/s beside the undistributed step."""
    import torch.distributed as dist

    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.train.multihost import make_mesh
    from smilify_tpu_torch.train.trainer import shard_batch

    mesh = make_mesh((world,), ("data",), dev)

    def setup(dtype, mesh_):
        _, model, step, make_batch = bench_all.singleview_train_setup(spec, compute_dtype=dtype,
                                                                      mesh=mesh_)
        perturb_zero_params(model)
        return model, step, make_batch(SCALE_DDP_B, np.random.RandomState(3))

    def state(model):
        return ({n: p.detach().clone() for n, p in model.named_parameters()},
                {n: b.detach().clone() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))})

    out = {}
    ref = None
    if rank == 0:
        model, step, batch = setup(torch.float32, None)
        start, _ = state(model)
        loss, _ = step(batch)
        params, stats = state(model)
        ref = {"loss": float(loss), "start": start, "params": params, "stats": stats,
               "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}
        del model, step, batch
        torch.cuda.empty_cache()
    dist.barrier()
    model, step, batch = setup(torch.float32, mesh)
    loss, _ = step(shard_batch(mesh, batch))
    params, stats = state(model)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, step, batch
    torch.cuda.empty_cache()
    if rank == 0:
        names = list(ref["params"])
        loss_gap = abs(float(loss) - ref["loss"]) / max(1.0, abs(ref["loss"]))
        grad_gap = _global_rel_l2([grads[n] for n in names], [ref["grads"][n] for n in names])
        decided = {n: ((grads[n] - ref["grads"][n]).abs() * 100 < ref["grads"][n].abs()) for n in names}
        kept = sum(int(decided[n].sum()) for n in names) / sum(decided[n].numel() for n in names)
        update_gap = _global_rel_l2(
            [(params[n] - ref["start"][n]) * decided[n] for n in names],
            [(ref["params"][n] - ref["start"][n]) * decided[n] for n in names])
        stats_gap = max(float((stats[k] - ref["stats"][k]).abs().max())
                        / float(ref["stats"][k].abs().max()) for k in ref["stats"])
        stats_gate = DDP_STATS_TOL_2RANKS if world > 1 else TRAIN_STATS_TOL
        log(f"rank 0: config 4b's train step, float32, {world} rank(s) × {SCALE_DDP_B // world} in "
            f"DistributedDataParallel against one process at {SCALE_DDP_B}: loss {loss_gap:.3e} "
            f"(gate {TRAIN_LOSS_TOL:g}), gradients {grad_gap:.3e} relative L2 (gate "
            f"{TRAIN_GRAD_TOL:g}), update over the {100 * kept:.1f}% decided elements "
            f"{update_gap:.3e} (gate {TRAIN_UPDATE_TOL:g}), BatchNorm running statistics "
            f"{stats_gap:.3e} relative (gate {stats_gate:g})")
        check(loss_gap <= TRAIN_LOSS_TOL, f"DDP step: loss gap {loss_gap:.3e}")
        check(grad_gap <= TRAIN_GRAD_TOL, f"DDP step: gradient gap {grad_gap:.3e}")
        check(update_gap <= TRAIN_UPDATE_TOL and kept >= TRAIN_DECIDED_MIN,
              f"DDP step: update gap {update_gap:.3e} over {kept:.3f}")
        check(stats_gap <= stats_gate, f"DDP step: statistics gap {stats_gap:.3e}")
        out.update(loss=loss_gap, grads=grad_gap, update_decided=update_gap, decided_share=kept,
                   bn_stats=stats_gap)
        del ref
        torch.cuda.empty_cache()
    dist.barrier()

    # the rates, bf16 (config 4b itself): undistributed on rank 0 alone, then every rank
    if rank == 0:
        model, step, batch = setup(torch.bfloat16, None)
        out["undistributed_images_per_s"] = _rate(lambda: step(batch), SCALE_DDP_B, DDP_RATE_STEPS)
        del model, step, batch
        torch.cuda.empty_cache()
    dist.barrier()
    model, step, batch = setup(torch.bfloat16, mesh)
    local = shard_batch(mesh, batch)
    out["ddp_images_per_s"] = _rate(lambda: step(local), SCALE_DDP_B, DDP_RATE_STEPS)
    if rank == 0:
        log(f"rank 0: config 4b at B={SCALE_DDP_B}, bf16: {out['ddp_images_per_s']:.1f} images/s "
            f"over {world} rank(s) in DistributedDataParallel, {out['undistributed_images_per_s']:.1f} "
            f"undistributed (one card; logged, not gated)")
    return out


def scaleout_rank(backend, work):
    """One rank of (b) or (c): torchrun's environment, the backend given."""
    import torch.distributed as dist

    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.train.multihost import maybe_initialize_multihost, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_multihost(True, device="cuda", backend=backend)
    dev = rank_device("cuda", backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    spec, _ = load_spec(device=dev)
    out = {"rank": rank, "world": world, "backend": backend, "device": str(dev)}
    t0 = time.perf_counter()
    out["sequence"] = scaleout_sequence(spec, dev, rank, world)
    out["corpus"] = scaleout_corpus(spec, dev, rank, (1, world))
    if world == 1:
        out["registration"] = scaleout_registration(dev, spec, rank, world)
    out["ddp"] = scaleout_ddp(spec, dev, rank, world)
    out["seconds"] = time.perf_counter() - t0
    Path(work, f"scaleout_{backend}_{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def scaleout_phase(card):
    """(b) one rank on NCCL, (c) two ranks on the one card over gloo."""
    work = ROOT / "build" / "smoke_scaleout"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    for nproc, backend in ((1, "nccl"), (2, "gloo")):
        ranks, secs = scaleout_launch(nproc, backend, work)
        out[f"{backend}_{nproc}"] = {"seconds": secs, "ranks": ranks}
    log(f"  ({card})")
    return out


# phase 14, slice 6 on the card: the tools on the outputs phases 8, 9, 11
# and 13 leave under build/. The Phong gate of tests/test_torch_cli.py (face
# ids equal on ≥ 99.9% of the pixels, the uint8 frames within one level
# there); the glTF evaluator's tolerance of tests/test_gltf_export.py
TOOLS_FACE_SHARE, TOOLS_LEVELS = 0.999, 1
GLTF_TOL = 3e-4
APPLY_TOL = 1e-6               # PCAMorphData.apply_weights against numpy, float32
TOOLS_MV_SAMPLES = 8           # the 5a checkpoint's video: random views from a seed
TOOLS_SMALL_B = 32             # the train step's second batch for the MB a sample
# betas_from_measurements on the authored model: known betas drawn at 0.5σ of
# its shape prior, 40 vertex-pair distances, 10 Gauss-Newton steps; the
# distances held to the JAX test's 0.01 (tests/test_authoring.py), the betas
# to 0.01 of the largest σ (measured on the H100: 3.3e-7 and 3.4e-6). A model
# PCA'd from posed fits is far from linear at 2σ: there 12 distances and 5
# steps left a distance 0.085 off
BETAS_SPREAD, BETAS_PAIRS, BETAS_ITERS, BETAS_TOL = 0.5, 40, 10, 0.01
# the OpenCV paths (tools/opencv_paths.py) against the test CPU's OpenCV
# (tests/fixtures/opencv_paths.npz): images within OPENCV_LEVELS grey levels,
# intrinsics and keypoints within OPENCV_POINTS_TOL pixels. The warp (two
# chained cv2.warpAffine) is held instead to its numpy model at this
# machine's sampling positions: OpenCV 4.13.0 rounds them to 1/32 px and
# 5.0.0 does not, which moved the pixels by 2.05 levels on the H100's machine
# (the model at 1/32 px reproduces that gap to 1e-4 levels)
OPENCV_FIXTURE = ROOT / "tests" / "fixtures" / "opencv_paths.npz"
OPENCV_LEVELS, OPENCV_POINTS_TOL = 1.0, 1e-2
# an augmented epoch of config 4b's regressor from a replicAnt PNG folder,
# card against CPU in float32: the epoch's mean loss, relative
AUG_LOSS_RTOL = 1e-3


class Captured:
    """Within the block, every ``utils.export.write_video`` call's frames and
    every ``render.phong.rasterize_hard`` call's face ids are kept (the CLIs
    look both up when they call them)."""

    def __enter__(self):
        from smilify_tpu_torch.render import phong
        from smilify_tpu_torch.utils import export

        self.videos, self.face_ids = {}, []
        self._real = (export.write_video, phong.rasterize_hard)
        real_write, real_raster = self._real

        def write_video(path, frames, fps=15):
            self.videos[str(path)] = [np.asarray(f).copy() for f in frames]
            return real_write(path, frames, fps=fps)

        def rasterize_hard(*args, **kw):
            out = real_raster(*args, **kw)
            self.face_ids.append(out[0])
            return out

        export.write_video, phong.rasterize_hard = write_video, rasterize_hard
        return self

    def __exit__(self, *exc):
        from smilify_tpu_torch.render import phong
        from smilify_tpu_torch.utils import export

        export.write_video, phong.rasterize_hard = self._real
        return False


def read_video(path):
    """(frames read back through cv2.VideoCapture, the container's frame count)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return frames, count


def check_video(path, n, shape, what):
    frames, count = read_video(path)
    check(len(frames) == count == n and all(f.shape == shape for f in frames),
          f"{what}: {path} reads back {len(frames)} frames (container: {count}) of "
          f"{frames[0].shape if frames else None}, expected {n} of {shape}")


def tools_video(toy, dev, card, work):
    """(a) generate_video on phase 8's optimize_corpus run (4 frames at 512²),
    held to the same frames rendered on the CPU (frame 0: a CPU raster of
    512² takes ~25 s) by the Phong gate; --collage; run_inference --video on
    phase 11's single-view checkpoint (16 replicAnt frames at 224²); the
    video path of run_inference on phase 13's 5a checkpoint (the
    predictions come from TOOLS_MV_SAMPLES random 4-view samples from a
    seed; phase 16 runs the CLIs on HDF5 stores)."""
    from smilify_tpu_torch.cli import generate_video, run_inference
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence

    run, model = ROOT / "build" / "smoke_cli" / "corpus", ROOT / "build" / "smoke_cli" / "stick_width.pkl"
    args = ["--checkpoint-dir", str(run), "--model", str(model), "--size", str(SIZE[0])]
    out = {}
    with Captured() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_video.main(args + ["--output", str(work / "fit.mp4"), "--device", dev.type])
        secs = time.perf_counter() - t0
    frames = cap.videos[str(work / "fit.mp4")]
    n = len(frames)
    check(n == 4, f"generate_video: {n} frames, expected 4")
    check_video(work / "fit.mp4", n, SIZE + (3,), "generate_video")
    out["generate_video"] = {"frames": n, "seconds": secs, "frames_per_s": n / secs}
    log(f"  generate_video: {n} frames at {SIZE[0]}² rendered (one batched forward) and encoded "
        f"(mp4v) in {secs:.2f} s = {n / secs:.2f} frames/s, model load included ({card})")

    cpu_spec = load_model_spec(str(model), align_symmetry=False, device="cpu")
    params = generate_video.read_frame_params(generate_video.frame_dirs(str(run)), "st10_ep0")
    t0 = time.perf_counter()
    with Captured() as cpu:
        cpu_frame = generate_video.render_sequence(cpu_spec, params[:1], SIZE[0])[0]
    fid, cpu_fid = cap.face_ids[0].cpu().numpy(), cpu.face_ids[0].numpy()
    same = fid == cpu_fid
    diff = int(np.abs(frames[0].astype(int) - cpu_frame.astype(int))[same].max())
    log(f"  frame 0 on the card against the CPU ({time.perf_counter() - t0:.1f} s there): face "
        f"ids equal on {100 * same.mean():.4f}% of the pixels (gate {100 * TOOLS_FACE_SHARE:g}%), "
        f"the mesh on {100 * (fid >= 0).mean():.2f}%; max |Δ| there {diff} level(s) "
        f"(gate {TOOLS_LEVELS})")
    check(same.mean() >= TOOLS_FACE_SHARE and (fid >= 0).mean() > 0.01 and diff <= TOOLS_LEVELS,
          "generate_video: the card's frame fails the Phong gate against the CPU's")
    out["generate_video"].update(face_id_share=float(same.mean()), max_level_diff=diff)

    with Captured() as cap:
        generate_video.main(args + ["--collage", "--output", str(work / "collage.avi")])
    collages = cap.videos[str(work / "collage.avi")]
    check(len(collages) == 4, f"generate_video --collage: {len(collages)} frames")
    check_video(work / "collage.avi", 4, collages[0].shape, "generate_video --collage")
    log(f"  generate_video --collage: 4 frames of {collages[0].shape} (MJPG)")

    folder, _ = write_replicant_sequence(str(work / "seq"), toy, SERVE_FRAMES, SERVE_RES,
                                         layout="unreal")      # phase 11's frames
    ckpt = str(ROOT / "build" / "smoke_serving" / "run" / "final_model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_inference.main(["--checkpoint", ckpt, "--data-path", folder, "--render-dir",
                        str(work / "sv_frames"), "--video", str(work / "sv.mp4"),
                        "--device", dev.type])
    secs = time.perf_counter() - t0
    check_video(work / "sv.mp4", SERVE_FRAMES, (SERVE_RES, SERVE_RES, 3), "run_inference --video")
    out["run_inference_video"] = {"frames": SERVE_FRAMES, "seconds": secs,
                                  "frames_per_s": SERVE_FRAMES / secs}
    log(f"  run_inference --video, phase 11's checkpoint: {SERVE_FRAMES} frames at {SERVE_RES}² "
        f"predicted, rendered, drawn, written as PNGs and encoded in {secs:.2f} s = "
        f"{SERVE_FRAMES / secs:.2f} frames/s, model load included ({card})")

    model5a, _, rcfg, spec5a, _ = run_inference.load_model_from_checkpoint(
        str(ROOT / "build" / "smoke_serving_export" / "config5a" / "final_model"), dev)
    images, mask, cams = (torch.from_numpy(a).to(dev)
                          for a in export_inputs("config5a", TOOLS_MV_SAMPLES))
    preds = run_inference.predictor(model5a, rcfg, spec5a, True)(
        {"images": images, "view_mask": mask, "camera_indices": cams})
    traj = {k: v.cpu().numpy() for k, v in preds.items()}
    t0 = time.perf_counter()
    grids, per_view = run_inference.render_frames(spec5a, rcfg, traj, SERVE_RES,
                                                  str(work / "mv_frames"), True)
    paths = run_inference.write_videos(str(work / "mv.mp4"), grids, per_view)
    secs = time.perf_counter() - t0
    V = SERVE_MV_VIEWS
    check(len(paths) == V + 1, f"5a video: {len(paths)} files")
    for v in range(V):
        check_video(work / f"mv_view{v}.mp4", TOOLS_MV_SAMPLES, (SERVE_RES, SERVE_RES, 3),
                    f"5a view {v}")
    check_video(work / "mv.mp4", TOOLS_MV_SAMPLES, (SERVE_RES, V * SERVE_RES, 3), "5a grid")
    out["multiview_video"] = {"frames": TOOLS_MV_SAMPLES, "views": V, "seconds": secs,
                              "frames_per_s": TOOLS_MV_SAMPLES / secs}
    log(f"  5a video path: {TOOLS_MV_SAMPLES} frames × {V} views at {SERVE_RES}² rendered, "
        f"tiled and encoded ({V} view videos + the grid's) in {secs:.2f} s = "
        f"{TOOLS_MV_SAMPLES / secs:.2f} frames/s ({card})")
    return out


def tools_opencv(toy, dev, card, work):
    """(b) The OpenCV paths of the port on the card's machine: run_inference
    on (a)'s sv.mp4 as raw-video input (``VideoFrameDataset`` →
    ``SequentialVideoReader`` → ``cv2.VideoCapture``), card against CPU by
    phase 11's bf16 gate; one augmented epoch (``cv2.GaussianBlur``) of
    config 4b's regressor from a replicAnt PNG folder, card against CPU in
    float32; augmentation's blur and warps (``cv2.warpAffine``) and the
    undistortion of an image and of points (``cv2.undistort``,
    ``cv2.undistortPoints``) on seeded inputs against the test CPU's OpenCV."""
    import cv2

    from smilify_tpu_torch.cli import run_inference, train_regressor
    from smilify_tpu_torch.tools import opencv_paths
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence

    out = {}
    ckpt = str(ROOT / "build" / "smoke_serving" / "run" / "final_model")
    preds, secs = {}, {}
    for device in (dev.type, "cpu"):
        zero_counts()
        t0 = time.perf_counter()
        traj = run_inference.main(["--checkpoint", ckpt, "--data-path", str(work / "sv.mp4"),
                                   "--device", device])
        torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
        preds[device] = {k: torch.as_tensor(np.asarray(v)) for k, v in traj.items()}
        check(all(len(v) == SERVE_FRAMES and bool(torch.isfinite(v).all())
                  for v in preds[device].values()),
              f"run_inference on sv.mp4 ({device}): {({k: tuple(v.shape) for k, v in preds[device].items()})}")
    gap = _max_rel_gap(preds[dev.type], preds["cpu"])
    log(f"  run_inference on sv.mp4 (raw video, {SERVE_FRAMES} frames decoded by cv2.VideoCapture): "
        f"card {secs[dev.type]:.2f} s, CPU {secs['cpu']:.2f} s; predictions card against CPU "
        f"{gap:.3g} (bf16 backbone on the card; gate {SERVE_BF16_TOL:g}; {card})")
    check(gap <= SERVE_BF16_TOL, "run_inference on raw video: the card is off the CPU")
    out["raw_video"] = {"gap": gap, "seconds": secs}

    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    folder, _ = write_replicant_sequence(str(work / "aug_seq"), toy, CLI_FRAMES, SERVE_RES,
                                         layout="unreal")
    history = {}
    for device in (dev.type, "cpu"):
        t0 = time.perf_counter()
        state = train_regressor.main([
            "--model", pkl, "--data-path", folder, "--epochs", "1",
            "--output-dir", str(work / f"aug_{device}"), "--device", device, "--set",
            "model.backbone_name=resnet50", f"model.input_resolution={SERVE_RES}",
            f"training.batch_size={CLI_BATCH}", "model.freeze_backbone=false",
            "model.transformer_dropout=0.0", "training.num_workers=0",
            "dataset.train_ratio=0.5", "dataset.val_ratio=0.25", "dataset.test_ratio=0.25",
            "dataset.dataset_fraction=1.0", "training.use_mixed_precision=false",
            "augmentation.enabled=true", "output.num_visualization_samples=2"])
        torch.cuda.synchronize()
        history[device] = (state.history[0], time.perf_counter() - t0)
    (card_h, card_s), (cpu_h, cpu_s) = history[dev.type], history["cpu"]
    loss_gap = abs(card_h["loss"] - cpu_h["loss"]) / abs(cpu_h["loss"])
    log(f"  augmented epoch of config 4b's regressor ({CLI_FRAMES // 2} frames at {SERVE_RES}², "
        f"B={CLI_BATCH}, float32): loss card {card_h['loss']:.6g} ({card_s:.2f} s), CPU "
        f"{cpu_h['loss']:.6g} ({cpu_s:.2f} s): {loss_gap:.3g} relative (gate {AUG_LOSS_RTOL:g})")
    check(math.isfinite(card_h["loss"]) and loss_gap <= AUG_LOSS_RTOL,
          "the augmented epoch on the card is off the CPU's")
    out["augmented_epoch"] = {"loss_card": card_h["loss"], "loss_cpu": cpu_h["loss"],
                              "rel_gap": loss_gap, "seconds": [card_s, cpu_s]}

    want = np.load(OPENCV_FIXTURE)
    got = opencv_paths.run()
    gaps = {}
    for k, v in got.items():
        check(v.shape == want[k].shape, f"{k}: {v.shape} against the fixture's {want[k].shape}")
        d = float(np.abs(v.astype(np.float64) - want[k].astype(np.float64)).max())
        gaps[k] = d * 255 if v.dtype == np.float32 else d        # grey levels or pixels
    images = [k for k in gaps if want[k].dtype in (np.float32, np.uint8)]
    # the warp: OpenCV 4 samples at positions rounded to 1/32 px, 5 at the
    # exact ones; held to the numpy model of this machine's OpenCV, its gap
    # to the fixture's stated
    bits = 5 if cv2.__version__.startswith("4.") else None
    model = opencv_paths.warp_affine_reference
    img, _, _ = opencv_paths.inputs()
    M1, M2 = got["warp_matrices"]
    model_gap = 255 * float(np.abs(got["warped"] - model(model(img, M1, bits), M2, bits)).max())
    log(f"  OpenCV {cv2.__version__} against {want['opencv_version']} on the test CPU "
        f"(tools/opencv_paths.py): images max |Δ| in grey levels "
        f"{ {k: round(gaps[k], 4) for k in images} } (gate {OPENCV_LEVELS:g} but the warp's); "
        f"intrinsics, matrices and points in pixels "
        f"{ {k: gaps[k] for k in gaps if k not in images} } (gate {OPENCV_POINTS_TOL:g}); the "
        f"two warps against their numpy model at {'1/32 px' if bits else 'exact'} positions "
        f"{model_gap:.4g} levels (gate {OPENCV_LEVELS:g})")
    check(all(gaps[k] <= (OPENCV_LEVELS if k in images else OPENCV_POINTS_TOL)
              for k in gaps if k != "warped") and model_gap <= OPENCV_LEVELS,
          "the OpenCV paths are off the test CPU's")
    out["opencv_paths"] = dict(gaps, warped_against_model=model_gap)
    return out


def write_binary_stl(path, verts, faces):
    """A binary STL of a triangle mesh (zero normals)."""
    rec = np.zeros(len(faces), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["v"] = np.asarray(verts, np.float32)[np.asarray(faces)]
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + np.uint32(len(faces)).tobytes() + rec.tobytes())


def tools_authoring(toy, dev, card, work):
    """(b) read_fitter_stages on phase 9's registration; a model authored
    from it (entangled PCA, 5 components) loaded on the card, one forward
    and one exact soft_silhouette (K1, counted) held to the plain version;
    both measurement CSVs; betas_from_measurements; the PCA CSV through the
    native loader; prepare_meshes on phase 9's targets as STL."""
    import contextlib
    import csv
    import io

    from smilify_tpu_torch.cli import prepare_meshes, read_fitter_stages
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.render import rasterizer as R
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.utils import authoring, beta_calculator, smil_tools_native
    from smilify_tpu_torch.utils.export import load_obj

    reg = ROOT / "build" / "smoke_registration"
    npz = reg / "results" / "batch_0" / "default.npz"
    data = np.load(npz)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        read_fitter_stages.main(["--npz", str(npz), "--export-obj", str(work / "stages")])
    lines = buf.getvalue().splitlines()
    objs = sorted((work / "stages").glob("*.obj"))
    n = data["verts"].shape[0]
    check(len(lines) == 1 + 2 * n and len(objs) == n, f"read_fitter_stages: {len(lines)} lines, "
                                                      f"{len(objs)} OBJ files for {n} scans")
    v0, f0 = load_obj(str(work / "stages" / f"{data['labels'][0]}.obj"))
    check(np.abs(v0 - data["verts"][0]).max() <= 1e-6 and np.array_equal(f0, data["faces"]),
          "read_fitter_stages: an OBJ differs from the npz")
    log(f"  read_fitter_stages: {lines[0]}; {n} OBJ files")

    t0 = time.perf_counter()     # toy: the registration's template (phase 9)
    pkl = authoring.build_model_from_registration(str(npz), toy, 5, True, str(work / "authored.pkl"))
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)
    check(spec.n_betas == 5 and spec.scaledirs is not None and spec.n_faces == toy.n_faces,
          "build_model_from_registration: the authored model's shape space")
    cam = default_camera(device=dev)
    zero_counts()
    with torch.no_grad():
        verts = smil_forward(spec, spec.shape_mean_betas[None], torch.zeros(
            (1, spec.n_joints, 3), device=dev)).verts[0]
        pv = cam.world_to_view(verts)
        ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
        alpha = R.soft_silhouette(ndc, spec.faces, SIZE)
        torch.cuda.synchronize()
        counts = read_counts()
        tri = ndc[spec.faces.long()][None]
        valid = torch.any(tri[..., 2] > 0.0, dim=-1)
        S = R.exact_fwd_plain(R._pack_faces(tri[..., :2], valid),
                              R._tile_cull_mask(tri[..., :2], valid, *SIZE, R.SIGMA), *SIZE, R.SIGMA)
        plain = 1.0 - torch.exp(-R._tiles_to_image(S, *SIZE))[0]
    err = float((alpha - plain).abs().max())
    log(f"  build_model_from_registration ({n} scans, entangled PCA, 5 components) → "
        f"{Path(pkl).name}, loaded on the card in {time.perf_counter() - t0:.2f} s; its exact "
        f"silhouette at {SIZE[0]}² covers {float((alpha > 0.5).float().mean()):.4f}, against the "
        f"plain version max abs err {err:.3g} (gate {ALPHA_ATOL:g}); launches {counts}")
    check(counts["exact_fwd"] == 1 and sum(counts.values()) == 1,
          f"the authored model's silhouette: launches {counts}, expected one exact_fwd")
    check(err <= ALPHA_ATOL and float(alpha.max()) > 0.5, "the authored model's K1 alpha")

    csvs = {}
    for name in ("export_joint_distances_csv", "export_mesh_measurements_csv"):
        path = getattr(authoring, name)(spec, str(work / f"{name}.csv"), beta_range=2.0)
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        vals = np.asarray([[float(x) for x in r if x[:1] in "-.0123456789"] for r in rows[1:]])
        csvs[name] = len(rows) - 1
        check(np.isfinite(vals).all() and (vals > 0).all(), f"{name}: values not positive")
    J, B = spec.n_joints, spec.n_betas
    check(csvs["export_joint_distances_csv"] == J * (J - 1) // 2
          and csvs["export_mesh_measurements_csv"] == 2 * B + 1, f"measurement CSVs: {csvs}")

    rng = np.random.RandomState(0)
    sigma = np.sqrt(np.diag(spec.shape_cov.cpu().double().numpy()))
    gt = rng.randn(B) * BETAS_SPREAD * sigma
    vshaped = smil_forward(spec, torch.as_tensor(gt[None], dtype=torch.float32, device=dev),
                           torch.zeros((1, J, 3), device=dev)).v_shaped[0].cpu().numpy()
    measurements = {f"m{i}": (int(a), int(b)) for i, (a, b) in enumerate(
        rng.randint(0, spec.n_verts, (BETAS_PAIRS, 2)))}
    targets = beta_calculator.measure(vshaped, measurements)
    betas = beta_calculator.betas_from_measurements(spec, targets, measurements,
                                                    n_iters=BETAS_ITERS)
    v_host = spec.v_template.cpu().double().numpy()
    dirs = spec.shapedirs.cpu().double().numpy().T.reshape(spec.n_verts, 3, B)
    achieved = beta_calculator.measure(v_host + dirs @ betas, measurements)
    worst = max(abs(achieved[k] - targets[k]) for k in targets)
    start = beta_calculator.measure(v_host + dirs @ spec.shape_mean_betas.cpu().double().numpy(),
                                    measurements)
    before = max(abs(start[k] - targets[k]) for k in targets)
    beta_gap = float(np.abs(betas - gt).max() / sigma.max())
    log(f"  measurement CSVs: {csvs}; betas_from_measurements (known betas drawn at "
        f"{BETAS_SPREAD}σ of the registrations' spread, σ {np.round(sigma, 3).tolist()}): worst "
        f"|Δ| over {BETAS_PAIRS} distances {before:.3g} at the mean shape, {worst:.3g} after "
        f"{BETAS_ITERS} iterations; max |betas − known| / max σ {beta_gap:.3g}")
    check(worst < BETAS_TOL and worst < before and beta_gap < BETAS_TOL,
          f"betas_from_measurements: a measurement {worst} off its target (at the start "
          f"{before}), the betas {beta_gap} of the largest σ from the known ones")

    sd = spec.scaledirs.cpu().double().numpy().transpose(1, 2, 0)     # (J, 3, B)
    td = spec.transdirs.cpu().double().numpy().transpose(1, 2, 0)
    path = smil_tools_native.export_pca_csv(str(work / "pca.csv"), list(spec.joint_names), sd, td)
    t0 = time.perf_counter()
    morph = smil_tools_native.PCAMorphData(path)
    build_s = time.perf_counter() - t0
    w = smil_tools_native.generate_weights(morph.num_components, 1.0, seed=3)
    scale, trans = morph.apply_weights(w)
    gap = max(float(np.abs(scale - (1.0 + morph.scaledirs @ w)).max()),
              float(np.abs(trans - morph.transdirs @ w).max()))
    log(f"  PCAMorphData ({smil_tools_native.library_path().name}, built and loaded in "
        f"{build_s:.2f} s): {morph.num_bones} bones × {morph.num_components} components; "
        f"apply_weights against numpy max |Δ| {gap:.3g} (gate {APPLY_TOL:g})")
    check(morph.num_bones == J and morph.num_components == B and gap <= APPLY_TOL
          and np.abs(morph.scaledirs - sd).max() < 1e-6, "PCAMorphData")

    stl = work / "stl"
    stl.mkdir()
    for p in sorted((reg / "scans").glob("*.obj")):
        write_binary_stl(stl / (p.stem + ".stl"), *load_obj(str(p)))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        prepare_meshes.main([str(stl), str(work / "prepared"), "--max-vertices", "3000"])
    with open(work / "prepared" / "stats.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    log(f"  prepare_meshes: {len(rows)} STL scans in {time.perf_counter() - t0:.2f} s; the "
        f"first {dict((k, rows[0][k]) for k in ('n_vertices', 'n_faces', 'n_components', 'n_holes', 'out_vertices'))}")
    n_faces = len(load_obj(str(reg / "scans" / "scan0.obj"))[1])
    check(len(rows) == n and all(int(r["n_faces"]) == n_faces and int(r["n_components"]) == 1
                                 and 0 < int(r["out_vertices"]) <= 3000 for r in rows),
          f"prepare_meshes: the stats rows {rows[:1]}")
    return {"authored_alpha_err": err, "k1_launches": counts["exact_fwd"], "betas_worst": worst,
            "betas_gap": beta_gap, "pca_apply_gap": gap}


def numpy_glb_vertices(gltf, blob, frame):
    """World-space skinned vertices of a ``.glb`` at keyframe ``frame``,
    from the file alone: the nodes' TRS composed through the scene, glTF
    skinning (joint world matrix × inverse bind matrix, 4 influences) and
    morph targets (as tests/test_gltf_export.py evaluates the JAX package's
    files; that evaluator cannot be imported here)."""
    from smilify_tpu_torch.utils.gltf_export import read_accessor

    def quat(q):
        x, y, z, w = q
        return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])

    anim = gltf["animations"][0]
    animated, morph = {}, None
    for ch in anim["channels"]:
        samp = anim["samplers"][ch["sampler"]]
        n = read_accessor(gltf, blob, samp["input"]).shape[0]
        vals = read_accessor(gltf, blob, samp["output"]).reshape(n, -1)[frame]
        if ch["target"]["path"] == "weights":
            morph = vals
        else:
            animated.setdefault(ch["target"]["node"], {})[ch["target"]["path"]] = vals
    nodes, world = gltf["nodes"], {}

    def visit(nid, parent):
        props = {**nodes[nid], **animated.get(nid, {})}
        M = np.eye(4)
        M[:3, :3] = quat(np.asarray(props.get("rotation", (0, 0, 0, 1)), np.float64)) * \
            np.asarray(props.get("scale", (1, 1, 1)), np.float64)[None]
        M[:3, 3] = props.get("translation", (0, 0, 0))
        world[nid] = parent @ M
        for c in nodes[nid].get("children", []):
            visit(c, world[nid])

    for root in gltf["scenes"][gltf["scene"]]["nodes"]:
        visit(root, np.eye(4))
    mesh_node = next(i for i, nd in enumerate(nodes) if "mesh" in nd)
    mesh = gltf["meshes"][nodes[mesh_node]["mesh"]]
    prim = mesh["primitives"][0]
    pos = read_accessor(gltf, blob, prim["attributes"]["POSITION"]).astype(np.float64)
    for k, tgt in enumerate(prim.get("targets", [])):
        w = morph if morph is not None else mesh["weights"]
        pos = pos + w[k] * read_accessor(gltf, blob, tgt["POSITION"]).astype(np.float64)
    jid = read_accessor(gltf, blob, prim["attributes"]["JOINTS_0"]).astype(np.int64)
    jw = read_accessor(gltf, blob, prim["attributes"]["WEIGHTS_0"]).astype(np.float64)
    skin = gltf["skins"][nodes[mesh_node]["skin"]]
    ibm = read_accessor(gltf, blob, skin["inverseBindMatrices"]).astype(np.float64)
    ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)
    mats = np.stack([world[j] @ ibm[k] for k, j in enumerate(skin["joints"])])
    homo = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
    return sum(jw[:, k:k + 1] * np.einsum("vab,vb->va", mats[jid[:, k]][:, :3], homo)
               for k in range(4))


def tools_gltf(dev, work):
    """(c) export_gltf on phase 11's animation; each keyframe's skinned
    vertices, evaluated from the file, held to smil_forward on the card. The
    STICK-width spec skins each vertex to all 55 joints, which glTF (4
    influences a vertex) cannot carry: the export and the forward use its
    four-influence copy (each vertex's 4 heaviest weights, renormalized), as
    the JAX package's test uses models whose skins have at most 4."""
    import dataclasses
    import warnings

    from smilify_tpu_torch.cli import export_gltf
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.utils.animation_export import load_animation
    from smilify_tpu_torch.utils.gltf_export import load_glb

    serving = ROOT / "build" / "smoke_serving"
    dense = load_model_spec(str(serving / "stick_width.pkl"), align_symmetry=False, device=dev)
    w = dense.weights
    w = torch.where(w >= torch.topk(w, 4, dim=1).values[:, 3:], w, torch.zeros_like(w))
    pkl = write_model_pkl(str(work / "stick_width_4.pkl"), dataclasses.replace(
        dense, weights=w / w.sum(1, keepdim=True)))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = export_gltf.main(["--model", pkl, "--animation", str(serving / "anim.npz"),
                                "--out", str(work / "anim.glb"), "--device", dev.type])
    secs = time.perf_counter() - t0
    gltf, blob = load_glb(out)
    extras = gltf["extras"]["smilify_tpu"]
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)
    data, _ = load_animation(str(serving / "anim.npz"))
    F, J = data["poses"].shape[0], spec.n_joints
    theta = np.concatenate([data["poses"][:, :3].reshape(F, 1, 3),
                            data["poses"][:, 3:].reshape(F, J - 1, 3)], axis=1)
    betas = np.asarray(data["betas_per_frame"] if "betas_per_frame" in data else data["betas"][None],
                       np.float64).mean(axis=0)[:spec.n_betas]
    with torch.no_grad():
        want = smil_forward(
            spec, torch.as_tensor(np.tile(betas, (F, 1)), dtype=torch.float32, device=dev),
            torch.as_tensor(theta, dtype=torch.float32, device=dev),
            trans=torch.as_tensor(data["trans"], dtype=torch.float32, device=dev)).verts.cpu().numpy()
    gaps = [float(np.abs(numpy_glb_vertices(gltf, blob, f) - want[f]).max()) for f in range(F)]
    log(f"  export_gltf on phase 11's animation ({F} frames): {Path(out).stat().st_size} bytes, "
        f"mode {extras['mode']}, animate_shape {extras['animate_shape']}, in {secs:.2f} s; "
        f"warnings {[str(c.message)[:60] for c in caught]}; keyframes against smil_forward on the "
        f"card: max |Δ| {max(gaps):.3g} (gate {GLTF_TOL:g})")
    check(extras["num_frames"] == F == SERVE_FRAMES and max(gaps) <= GLTF_TOL,
          f"export_gltf: keyframes {max(gaps)} off the forward")
    return {"frames": F, "max_abs_err": max(gaps), "bytes": Path(out).stat().st_size}


def tools_monitoring(spec, dev, card, work):
    """(d) profile_trace around the authored forward; recommend_batch_size
    for resnet50 from the card's memory, then one config-4b train step (bf16,
    224²) at that batch and at TOOLS_SMALL_B: the peak memory and the MB a
    sample between the two, beside the table's estimate; show_latest_checkpoint
    on phase 8's runs."""
    import contextlib
    import io

    from smilify_tpu_torch.cli import show_latest_checkpoint
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.utils import monitoring

    with monitoring.profile_trace(str(work / "trace")):
        smil_forward(spec, torch.zeros((8, spec.n_betas), device=dev),
                     torch.zeros((8, spec.n_joints, 3), device=dev))
        torch.cuda.synchronize()
    traces = list((work / "trace").iterdir())
    check(len(traces) == 1 and traces[0].stat().st_size > 0, f"profile_trace: {traces}")
    log(f"  profile_trace: {traces[0].name}, {traces[0].stat().st_size} bytes; device memory "
        f"{ {k: round(v, 1) for k, v in monitoring.device_memory_stats().items()} } MB")

    rec = monitoring.recommend_batch_size("resnet50")
    B = rec["recommended_batch_size"]
    torch.cuda.empty_cache()
    _, model, step, make_batch = bench_all.singleview_train_setup(spec)
    rng = np.random.RandomState(0)
    peaks = {}
    for b in (TOOLS_SMALL_B, TOOLS_SMALL_B, B):     # the first step makes Adam's state
        batch = make_batch(b, rng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = step(batch)[0]
        check(math.isfinite(float(loss)), f"config 4b at B={b}: non-finite loss")
        peaks[b] = (torch.cuda.max_memory_allocated() - base) / 1e6
        del batch
    per_sample = (peaks[B] - peaks[TOOLS_SMALL_B]) / (B - TOOLS_SMALL_B)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    log(f"  recommend_batch_size('resnet50') from {rec['hbm_gb']:.1f} GB: B={B} (estimates: "
        f"{rec['per_sample_mb']:.0f} MB a sample, {rec['fixed_mb']} MB fixed); one config-4b step "
        f"(bf16, 224²) at B={B}: peak {peaks[B]:.0f} MB above the model and optimizer state "
        f"({100 * peaks[B] / 1e3 / total:.1f}% of the card), at B={TOOLS_SMALL_B} "
        f"{peaks[TOOLS_SMALL_B]:.0f} MB: measured {per_sample:.1f} MB a sample ({card})")
    del model, step
    torch.cuda.empty_cache()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        show_latest_checkpoint.main(["--root", str(ROOT / "build" / "smoke_cli")])
    lines = buf.getvalue().splitlines()
    check(lines[0].startswith(f"run: {ROOT / 'build' / 'smoke_cli' / 'corpus'} (4 frames)")
          and all(ln.endswith("st10_ep0.png") for ln in lines[1:]), f"show_latest_checkpoint: {lines}")
    log(f"  show_latest_checkpoint: {lines[0]}")
    return {"recommended_batch": B, "peak_mb": peaks[B], "peak_mb_small": peaks[TOOLS_SMALL_B],
            "measured_mb_per_sample": per_sample, "estimate_mb_per_sample": rec["per_sample_mb"]}


def tools_phase(toy, dev, card):
    """Phase 14: slice 6's tools on the card (see the module docstring)."""
    work = ROOT / "build" / "smoke_tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    for part, fn in (("video", lambda: tools_video(toy, dev, card, work)),
                     ("opencv", lambda: tools_opencv(toy, dev, card, work)),
                     ("authoring", lambda: tools_authoring(toy, dev, card, work)),
                     ("gltf", lambda: tools_gltf(dev, work)),
                     ("monitoring", lambda: tools_monitoring(toy, dev, card, work))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["phase_seconds"] = time.perf_counter() - t0
        log(f"  ({part}: {out[part]['phase_seconds']:.1f} s)")
    return out


def learning_phase(dev, card):
    """Phase 15: the learning proofs' ``memorize`` runs
    (``tools/prove_learning.py``: the JAX proof's settings, 600 epochs over
    12 samples of 2 views at 64² held in DeviceDataCache; K1 renders them)
    for the single- and multi-view regressors; each must meet the JAX gates
    (loss ratio ≥ 20, PCK@5 ≥ 0.7, PCK@10 ≥ 0.9 on the training rows). The
    trainers' per-epoch lines go to ``build/smoke_learning/{mode}.log``."""
    import contextlib

    from smilify_tpu_torch.tools import prove_learning

    work = ROOT / "build" / "smoke_learning"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    for mode in ("sv", "mv"):
        run = prove_learning.RUNS["memorize"]
        n_k1 = run["views"][mode] * math.ceil(run["samples"][mode] / DATA_CHUNK)
        zero_counts()
        t0 = time.perf_counter()
        with open(work / f"{mode}.log", "w") as f, contextlib.redirect_stdout(f):
            r = prove_learning.run(mode, "memorize", str(work), device=dev.type)
        torch.cuda.synchronize()
        r["wall_seconds"] = time.perf_counter() - t0
        r["launches"] = read_counts()
        log(f"  memorize {mode} ({card}): {r['epochs']} epochs, {r['steps']} steps in "
            f"{r['train_seconds']:.1f} s ({r['wall_seconds']:.1f} s with the data and the "
            f"benchmark); loss {r['loss_first']:.5g} -> {r['loss_last']:.5g} = "
            f"{r['loss_ratio']:.1f}x (gate {r['gates']['loss_ratio']:g}), PCK@5 "
            f"{r['pck@5px']:.4f} (gate {r['gates']['pck@5px']:g}), PCK@10 {r['pck@10px']:.4f} "
            f"(gate {r['gates']['pck@10px']:g}) over {r['scored_keypoints']} keypoints of the "
            f"training rows{', MPJPE ' + str(r['mpjpe']) if 'mpjpe' in r else ''}; launches "
            f"{r['launches']}")
        check(r["launches"]["exact_fwd"] == n_k1,
              f"memorize {mode}: K1 launched {r['launches']['exact_fwd']} times, expected {n_k1}")
        check(r["ok"], f"memorize {mode}: a JAX gate is missed: {r}")
        out[mode] = {k: v for k, v in r.items() if k != "history"}
    out["heldout_chunked"] = learning_chunked(dev, card, work)
    return out


def learning_chunked(dev, card, work):
    """Phase 15's chunked ``heldout`` at a toy size (``unet_micro`` at 32²,
    200 samples, 4 epochs): two calls of ``prove_learning.run``, the first
    ``until=2``, the second resuming from its ``epoch_1`` checkpoint. Each
    regenerates the samples (K1 renders them) and the second refuses a store
    whose SHA-256 differs from the first's, so the equal digests show that K1
    regenerates the data bitwise; the history must run 0..3 without a gap."""
    import contextlib

    from smilify_tpu_torch.tools import prove_learning

    toy = dict(epochs=4, samples=200, backbone="unet_micro", res=32, device=dev.type)
    n_k1 = prove_learning.RUNS["heldout"]["views"]["sv"] * math.ceil(toy["samples"] / DATA_CHUNK)
    calls = []
    zero_counts()
    t0 = time.perf_counter()
    with open(work / "heldout_chunked.log", "w") as f, contextlib.redirect_stdout(f):
        for until in (2, 4):
            calls.append(prove_learning.run("sv", "heldout", str(work), until=until, **toy))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    first, last = calls
    with open(work / "heldout_sv" / prove_learning.RECORD) as f:
        record = json.load(f)
    epochs = [h["epoch"] for h in record["history"]]
    log(f"  heldout, 2 calls ({card}): epochs 0-1 then 2-3 in {wall:.1f} s; store SHA-256 "
        f"{first['store_sha256'][:16]}... / {last['store_sha256'][:16]}...; history epochs "
        f"{epochs}; steps {last['steps']} (calls: "
        f"{[c['steps'] for c in last['chunks']]}); K1 {launches['exact_fwd']} launches; "
        f"held-out PCK@10 {last['pck@10px']:.4f} (a toy: no gate)")
    check(first.get("partial") and first["until"] == 2, f"heldout chunk 1: not a partial record: {first}")
    check(first["store_sha256"] == last["store_sha256"] == record["store_sha256"],
          "heldout chunks: K1 did not regenerate the samples bitwise (store digests differ)")
    check(epochs == list(range(4)) and [(c["from"], c["until"]) for c in last["chunks"]]
          == [(0, 2), (2, 4)], f"heldout chunks: the history is not continuous: {epochs}")
    check(last["steps"] == sum(c["steps"] for c in last["chunks"]) == 4 * last["steps_per_epoch"],
          f"heldout chunks: steps {last['steps']} do not count every epoch: {last['chunks']}")
    check(launches["exact_fwd"] == 2 * n_k1,
          f"heldout chunks: K1 launched {launches['exact_fwd']} times, expected {2 * n_k1}")
    return {"wall_seconds": wall, "store_sha256": last["store_sha256"], "epochs": epochs,
            "steps": last["steps"], "chunks": last["chunks"], "pck@10px": last["pck@10px"],
            "launches": launches}


# phase 16, the HDF5 stores on the card (slice 9): the committed fixtures
# through the port's codec; phase 10's store written again by
# generate_synthetic_multiview (K1 on the path); train_multiview and
# benchmark_model on it at phase 12's regressor widths, dataset_viewer; a
# single-view store from preprocess_replicant for train_regressor and
# run_inference; a codec-written SLEAP session through preprocess_sleap_multiview
HDF5_MV_B = 16                 # samples (of 4 views at 96²) a batch
HDF5_SLEAP_FRAMES, HDF5_SLEAP_CAMS, HDF5_SLEAP_SIZE, HDF5_SLEAP_RES = 24, 3, (128, 96), 96


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _regressor_set(res, batch, extra=()):
    """The trainer's --set list at phase 12's regressor widths (ResNet-50 +
    IEF head, bf16 autocast) through the host pipeline with thread workers."""
    return ["model.backbone_name=resnet50", f"model.input_resolution={res}",
            f"training.batch_size={batch}", "model.freeze_backbone=false",
            "dataset.dataset_fraction=1.0", "training.use_mixed_precision=true",
            "training.num_workers=2", "training.worker_mode=thread",
            "output.num_visualization_samples=2", *extra]


def _check_run(state, run, what, card, secs):
    files = sorted(p.name for p in run.glob("*.pt"))
    hist = [(h["epoch"], round(h["loss"], 5), round(h.get("val_loss", float("nan")), 5))
            for h in state.history]
    log(f"  {what} ({card}): 2 epochs, {secs:.2f} s; (epoch, loss, val_loss) {hist}; "
        f"checkpoints {files}; kernel launches {read_counts()}")
    check(len(state.history) == 2 and all(math.isfinite(h["loss"]) for h in state.history),
          f"{what}: losses {hist}")
    check({"best_model.pt", "final_model.pt"} <= set(files), f"{what}: checkpoints {files}")


def hdf5_synthetic(spec, dev, card, work, samples, phase10_path):
    """(b): phase 10's store written again, by ``generate_synthetic_multiview``
    on the card (one K1 launch a (view, chunk)): the file must be phase 10's
    bit for bit (the same samples, K1 bitwise reproducible, the same JPEG
    bytes), and reads back as phase 10's did."""
    from smilify_tpu_torch.data.synthetic import generate_synthetic_multiview

    path = str(work / "synthetic.h5")
    n_k1 = DATA_VIEWS * math.ceil(DATA_SAMPLES / DATA_CHUNK)
    zero_counts()
    t0 = time.perf_counter()
    generate_synthetic_multiview(spec, path, DATA_SAMPLES, n_views=DATA_VIEWS,
                                 resolution=DATA_RES, chunk_size=DATA_CHUNK, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    same = _sha256(path) == _sha256(phase10_path)
    log(f"  generate_synthetic_multiview ({card}): {DATA_SAMPLES} samples × {DATA_VIEWS} views at "
        f"{DATA_RES}² rendered and written in {secs:.2f} s; launches {counts}; the file is "
        f"phase 10's bit for bit: {same}")
    check(counts["exact_fwd"] == n_k1, f"generate_synthetic_multiview launched K1 "
                                       f"{counts['exact_fwd']} times, expected {n_k1}")
    check(all(n == 0 for k, n in counts.items() if k != "exact_fwd"),
          f"generate_synthetic_multiview launched another kernel than K1: {counts}")
    check(same, "generate_synthetic_multiview's store differs from phase 10's")
    back = hdf5_read_back(path, samples, "generate_synthetic_multiview's store")
    return {"seconds": secs, "launches": counts["exact_fwd"], "path": path, **back}


def hdf5_multiview(spec, pkl, dev, card, work, samples, store_path):
    """(c): train_multiview from the store for 2 epochs through the host
    pipeline; benchmark_model on its final_model from the file and from the
    same samples in memory (``multiview_store``: the same JPEG bytes), whose
    metrics must be equal bit for bit; dataset_viewer renders a sample."""
    from smilify_tpu_torch.cli import benchmark_model, dataset_viewer, train_multiview
    from smilify_tpu_torch.data.hdf5_dataset import multiview_store

    run = work / "train_multiview"
    zero_counts()
    t0 = time.perf_counter()
    state = train_multiview.main([
        "--model", pkl, "--data-path", store_path, "--epochs", "2", "--output-dir", str(run),
        "--device", dev.type, "--set",
        *_regressor_set(DATA_RES, HDF5_MV_B, [f"multiview.num_views_to_use={DATA_VIEWS}"])])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _check_run(state, run, "train_multiview from the store", card, train_s)

    ckpt = str(run / "final_model")
    metrics, bench_s = {}, {}
    store = multiview_store(samples, **synthetic_store_args(spec))
    for label, argv, source in (("file", ["--dataset-path", store_path], None),
                                ("memory", [], store)):
        t0 = time.perf_counter()
        acc = benchmark_model.main(["--checkpoint", ckpt, "--split", "test", "--device", dev.type,
                                    "--output-dir", str(work / f"benchmark_{label}"), *argv],
                                   source=source)
        bench_s[label] = time.perf_counter() - t0
        metrics[label] = {"pck": acc.pck_curve("input"), "mpjpe": acc.mpjpe_stats()}
    same = repr(metrics["file"]) == repr(metrics["memory"])
    pck = metrics["file"]["pck"]
    log(f"  benchmark_model on final_model ({card}): from the file {bench_s['file']:.2f} s, from "
        f"memory {bench_s['memory']:.2f} s; PCK@5 {pck.get(5)}, PCK@10 {pck.get(10)}, MPJPE "
        f"{metrics['file']['mpjpe']}; equal bit for bit: {same}")
    check(same, f"benchmark_model: the file's metrics differ from the in-memory store's: {metrics}")
    check(all(math.isfinite(v) for v in pck.values()), f"benchmark_model: PCK {pck}")

    out = work / "viewer"
    zero_counts()
    t0 = time.perf_counter()
    dataset_viewer.main(["--dataset", store_path, "--output", str(out), "--samples", "1",
                         "--model", pkl, "--render-smal", "--device", dev.type])
    torch.cuda.synchronize()
    pngs = sorted(p.name for p in out.glob("*.png"))
    log(f"  dataset_viewer ({card}): {pngs} in {time.perf_counter() - t0:.2f} s; launches "
        f"{read_counts()}")
    check(pngs and (out / "index.html").exists(), f"dataset_viewer wrote {pngs}")
    return {"train_seconds": train_s, "history": state.history, "benchmark_seconds": bench_s,
            "pck@5px": pck.get(5), "pck@10px": pck.get(10), "mpjpe": metrics["file"]["mpjpe"]}


def hdf5_singleview(toy, pkl, dev, card, work):
    """(d): preprocess_replicant on phase 12's replicAnt folder (the same
    CLI_FRAMES frames at 224², written again here) into a single-view store;
    train_regressor on the store for 2 epochs; run_inference on the store."""
    from smilify_tpu_torch.cli import preprocess_replicant, run_inference, train_regressor
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence

    folder, _ = write_replicant_sequence(str(work / "seq"), toy, CLI_FRAMES, SERVE_RES,
                                         layout="unreal")
    path = str(work / "singleview.h5")
    t0 = time.perf_counter()
    preprocess_replicant.main(["--input", folder, "--output", path, "--model", pkl,
                               "--resolution", str(SERVE_RES)])
    prep_s = time.perf_counter() - t0
    run = work / "train_regressor"
    zero_counts()
    t0 = time.perf_counter()
    state = train_regressor.main([
        "--model", pkl, "--data-path", path, "--epochs", "2", "--output-dir", str(run),
        "--device", dev.type, "--set",
        *_regressor_set(SERVE_RES, CLI_BATCH, ["dataset.train_ratio=0.5", "dataset.val_ratio=0.25",
                                               "dataset.test_ratio=0.25"])])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _check_run(state, run, "train_regressor from the single-view store", card, train_s)
    zero_counts()
    t0 = time.perf_counter()
    traj = run_inference.main(["--checkpoint", str(run / "final_model"), "--data-path", path,
                               "--device", dev.type])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    log(f"  preprocess_replicant: {CLI_FRAMES} frames at {SERVE_RES}² → {os.path.getsize(path)} "
        f"bytes in {prep_s:.2f} s; run_inference on the store ({card}): {infer_s:.2f} s, outputs "
        f"{sorted(traj)}; launches {read_counts()}")
    check(all(np.isfinite(np.asarray(v)).all() and len(v) == CLI_FRAMES for v in traj.values()),
          "run_inference on the single-view store: non-finite or missing predictions")
    return {"preprocess_seconds": prep_s, "train_seconds": train_s, "history": state.history,
            "run_inference_seconds": infer_s}


def hdf5_sleap(pkl, card, work):
    """(e): a SLEAP session written by the port (tools/synthetic_data.py::
    write_sleap_session: the codec's analysis .h5 and .slp, OpenCV's videos,
    a calibration) through preprocess_sleap_multiview; its store read back."""
    from smilify_tpu_torch.cli import preprocess_sleap_multiview
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.data.hdf5_dataset import MultiViewHDF5Dataset
    from smilify_tpu_torch.tools.synthetic_data import SLEAP_NODES, write_sleap_session

    cams = tuple(f"cam{c}" for c in range(HDF5_SLEAP_CAMS))
    sess = write_sleap_session(str(work / "sleap" / "sess"), HDF5_SLEAP_FRAMES, cams,
                               consistent=True, size=HDF5_SLEAP_SIZE)
    names = list(load_model_spec(pkl, align_symmetry=False, device="cpu").joint_names)
    lookup = work / "sleap" / "lookup.csv"
    lookup.write_text("sleap_name,model_name\n" + "".join(
        f"{n},{names[i + 1]}\n" for i, n in enumerate(SLEAP_NODES[:3])) + f"{SLEAP_NODES[3]},\n")
    path = str(work / "sleap.h5")
    t0 = time.perf_counter()
    preprocess_sleap_multiview.main([
        "--sessions", sess, "--output", path, "--model", pkl, "--joint-lookup", str(lookup),
        "--resolution", str(HDF5_SLEAP_RES), "--crop-mode", "centred", "--min-views", "2"])
    secs = time.perf_counter() - t0
    ds = MultiViewHDF5Dataset(path)
    s = ds[0]
    log(f"  preprocess_sleap_multiview: {HDF5_SLEAP_FRAMES} frames × {HDF5_SLEAP_CAMS} cameras "
        f"({HDF5_SLEAP_SIZE[0]}x{HDF5_SLEAP_SIZE[1]}) → {len(ds)} samples in {secs:.2f} s; "
        f"sample 0: {int(s['view_mask'].sum())} views, images {s['images'].shape}")
    check(len(ds) > 0 and s["images"].shape[1:] == (HDF5_SLEAP_RES, HDF5_SLEAP_RES, 3)
          and all(np.isfinite(ds[i]["keypoints_2d"]).all() for i in range(len(ds))),
          f"preprocess_sleap_multiview's store: {len(ds)} samples")
    ds.close()
    return {"seconds": secs, "samples": len(ds)}


def hdf5_phase(toy, dev, card, samples, phase10_path):
    """Phase 16: the HDF5 stores on the card (see the constants above). (a)
    every committed fixture read through the codec equals its expected
    contents (tools/hdf5_fixtures.py); (b)-(e) as their functions say."""
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.tools import hdf5_fixtures
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    work = ROOT / "build" / "smoke_hdf5"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    bad = hdf5_fixtures.check()
    log(f"  fixtures: {len(bad)} files read through the codec in {time.perf_counter() - t0:.2f} s; "
        f"keys that differ from expected.npz: {bad}")
    check(not any(bad.values()), f"HDF5 fixtures differ from their expected contents: {bad}")
    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)      # phase 10's: Morton faces
    out = {}
    for part, fn in (("synthetic", lambda: hdf5_synthetic(spec, dev, card, work, samples,
                                                          phase10_path)),
                     ("multiview", lambda: hdf5_multiview(spec, pkl, dev, card, work, samples,
                                                          out["synthetic"]["path"])),
                     ("singleview", lambda: hdf5_singleview(toy, pkl, dev, card, work)),
                     ("sleap", lambda: hdf5_sleap(pkl, card, work))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["phase_seconds"] = time.perf_counter() - t0
        log(f"  ({part}: {out[part]['phase_seconds']:.1f} s)")
    return out


# phase 17, slice 10 on the card: the registration CLI from a YAML file, the
# polygon masks and the plots, without PyYAML or matplotlib (the port imports
# neither; the card's machine has no matplotlib). optimise_3d runs phase 9's 8 scans in batches of 4,
# so that it merges two batches' npz files, as register() does in-process
REG_CLI_BATCH = 4
STAGE_YAML = """\
# two stages over phase 9's scans (read by smilify_tpu_torch/utils/yaml_io.py)
stages:
  init:                 # rigid and scale first
    scheme: init
    nits: 20
    lr: 0.01
    custom_lrs: {{global_rot: 0.02}}
  default:
    scheme: 'default'
    nits: 20
    lr: 5.0e-3          # a float: it has its dot
    loss_weights: {{w_chamfer: 1.0, w_edge: 0.5, w_laplacian: 0.1}}
    custom_lrs:
      joint_rot: 0.002
args: {{results_dir: "{results}"}}
"""
# the JAX package's files: (height, width) = int(figsize × dpi)
TRAIN_PLOTS = {"training_history.png": (480, 840), "lr_schedule.png": (360, 840),
               "loss_components.png": (480, 960), "ief_deltas.png": (480, 960)}
BENCH_PLOTS = {"pck_curve.png": (480, 720), "error_histogram.png": (480, 720)}


def _png_sizes(paths):
    from smilify_tpu_torch.utils.image_io import read_png

    return {Path(p).name: read_png(p).shape[:2] for p in paths}


def yaml_cli(toy, dev, card, work):
    """(a): optimise_3d from a YAML stage file, in a process of its own,
    against register() with the same stages here: the merged npz bitwise,
    both batches' loss plots at 640 × 480 and 800 × 300 a component."""
    from smilify_tpu_torch.cli.optimise_3d import load_stages_from_yaml, register
    from smilify_tpu_torch.core.spec import load_model_spec
    from smilify_tpu_torch.fitter.fitter3d import Stage
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    scans = ROOT / "build" / "smoke_registration" / "scans"
    paths = sorted(str(p) for p in scans.glob("*.obj"))
    check(len(paths) == 8, f"phase 17: phase 9's scans {paths}")
    pkl = write_model_pkl(str(work / "stick_width.pkl"), toy)
    cfg = work / "stages.yaml"
    cfg.write_text(STAGE_YAML.format(results=work / "cli"))
    stages = [Stage("init", "init", n_its=20, lr=0.01, custom_lrs={"global_rot": 0.02}),
              Stage("default", "default", n_its=20, lr=0.005,
                    loss_weights={"chamfer": 1.0, "edge": 0.5, "laplacian": 0.1},
                    custom_lrs={"joint_rot": 0.002})]
    fields = ("name", "scheme", "n_its", "lr", "loss_weights", "custom_lrs")
    parsed, yaml_args = load_stages_from_yaml(str(cfg))
    same_stages = [[getattr(st, f) for f in fields] for st in parsed] == [
        [getattr(st, f) for f in fields] for st in stages]
    log(f"  the stage file read by the port's YAML reader: {len(parsed)} stages, "
        f"{'the Stage objects built here' if same_stages else 'NOT the Stage objects built here'}; "
        f"args {yaml_args}")
    check(same_stages and yaml_args == {"results_dir": str(work / "cli")},
          f"load_stages_from_yaml: {[vars(st) for st in parsed]}, {yaml_args}")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "smilify_tpu_torch.cli.optimise_3d",
                          "--model", pkl, "--mesh_dir", str(scans), "--yaml_src", str(cfg),
                          "--batch_size", str(REG_CLI_BATCH), "--device", dev.type],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"optimise_3d exited {res.returncode}: {res.stderr[-3000:]}")
    spec = load_model_spec(pkl, align_symmetry=False, device=dev)        # the CLI's loading
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    managers = register(spec, paths, stages, str(work / "inproc"), batch_size=REG_CLI_BATCH,
                        num_samples=3000, chunk=10)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    cli_npz, ref_npz = (np.load(work / d / "default.npz") for d in ("cli", "inproc"))
    differ = sorted(set(cli_npz.files) ^ set(ref_npz.files)) + [
        k for k in ref_npz.files if k in cli_npz.files and not (
            cli_npz[k].dtype == ref_npz[k].dtype and np.array_equal(cli_npz[k], ref_npz[k]))]
    log(f"  optimise_3d (a process of its own: start, imports, 2 batches × 4 scans × 2 × 20 "
        f"steps, npz and plots) {cli_s:.2f} s; register() here on the same stages {reg_s:.2f} "
        f"s ({card}); merged npz arrays that differ: {differ or 'none'} of {len(ref_npz.files)}")
    check(not differ and ref_npz["verts"].shape == (8, toy.n_verts, 3),
          f"optimise_3d's merged npz differs from register()'s: {differ}")
    n_comp = len({k for st in managers[0].stages for h in st.loss_history for k in h})
    sizes = {}
    for b in range(2):
        got = _png_sizes(sorted((work / "cli" / f"batch_{b}").glob("*.png")))
        sizes[f"batch_{b}"] = got
        check(got == {"losses.png": (480, 640), "loss_components.png": (300 * n_comp, 800)},
              f"optimise_3d batch {b}: loss plots {got} ({n_comp} components)")
    log(f"  loss plots (height, width): {sizes}")
    return {"cli_seconds": cli_s, "register_seconds": reg_s, "npz_arrays_differ": differ,
            "components": n_comp, "merged": str(work / "cli" / "default.npz")}


def plot_sites(work, merged_npz, card):
    """(d): every plot site's files at the JAX package's sizes: the trainers'
    history and 3D-keypoint plots of phases 12 and 16, benchmark_model's
    plots of phase 16, utils.visualization's three plots on (a)'s
    registration, plot_pca_data on phase 14's CSV."""
    from smilify_tpu_torch.cli import plot_pca_data
    from smilify_tpu_torch.utils import visualization
    from smilify_tpu_torch.utils.export import load_obj
    from smilify_tpu_torch.utils.smil_tools_native import PCAMorphData

    build = ROOT / "build"
    runs = [build / "smoke_training" / "device_cache", build / "smoke_training" / "host_threads",
            build / "smoke_hdf5" / "train_multiview"]
    out = {}
    for run in runs:
        got = _png_sizes(sorted((run / "plots").glob("*.png")))
        kp3d = _png_sizes(sorted(run.glob("visualizations*/*_kp3d.png")))
        out[run.name] = {"plots": got, "kp3d": kp3d}
        check(got == TRAIN_PLOTS, f"{run}: history plots {got}")
        check(kp3d and set(kp3d.values()) == {(480, 480)}, f"{run}: 3D keypoint plots {kp3d}")
    bench = _png_sizes(sorted((build / "smoke_hdf5" / "benchmark_file").glob("*.png")))
    out["benchmark_model"] = bench
    check(bench == BENCH_PLOTS, f"benchmark_model's plots {bench}")

    reg = np.load(merged_npz)
    verts, faces = reg["verts"][0], reg["faces"]
    scan, _ = load_obj(str(build / "smoke_registration" / "scans" / "scan0.obj"))
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    vis = work / "visualization"
    vis.mkdir()
    t0 = time.perf_counter()
    visualization.plot_mesh(verts, faces, str(vis / "mesh.png"), title="registration 0")
    visualization.plot_pointclouds([verts, scan], str(vis / "clouds.png"), labels=["fit", "scan"])
    visualization.plot_mesh_heatmap(verts, faces, area, str(vis / "heatmap.png"), title="face area")
    vis_s = time.perf_counter() - t0
    got = _png_sizes(sorted(vis.glob("*.png")))
    out["visualization"] = got
    check(got == {n: (480, 480) for n in ("mesh.png", "clouds.png", "heatmap.png")},
          f"visualization plots {got}")

    csv = build / "smoke_tools" / "pca.csv"
    morph = PCAMorphData(str(csv))
    t0 = time.perf_counter()
    plot_pca_data.main(["--csv", str(csv), "--out", str(work / "pca")])
    pca_s = time.perf_counter() - t0
    got = _png_sizes(sorted((work / "pca").glob("*.png")))
    want = (720, int(max(8, morph.num_bones * 0.35) * 120))
    out["plot_pca_data"] = got
    check(len(got) == morph.num_components and set(got.values()) == {want},
          f"plot_pca_data: {got}, want {morph.num_components} of {want}")
    log(f"  plots (height, width), phases 12 and 16 and here: {json.dumps(out)}; the three "
        f"visualization plots on a {len(faces)}-face registration in {vis_s:.2f} s, "
        f"{morph.num_components} PCA plots in {pca_s:.2f} s ({card})")
    return out


def slice10_phase(toy, dev, card):
    """Phase 17: (a) the registration CLI from a YAML file (yaml_cli); (b)
    the YAML, mask, limit and projection fixtures; (c) polygon masks
    through load_smil_sequence; (d) the plot sites (plot_sites)."""
    import importlib.util

    from smilify_tpu_torch.data.loaders import load_smil_sequence
    from smilify_tpu_torch.tools import plot_fixtures

    work = ROOT / "build" / "smoke_slice10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    absent = [m for m in ("yaml", "matplotlib", "mpl_toolkits") if importlib.util.find_spec(m) is None]
    log(f"  not installed on this machine: {absent}")
    out = {"cli": yaml_cli(toy, dev, card, work)}

    t0 = time.perf_counter()
    bad = plot_fixtures.check()
    fixture_s = time.perf_counter() - t0
    want = plot_fixtures.load()
    log(f"  fixtures (tests/fixtures/plots): {len(want['yaml'])} YAML documents, "
        f"{sum(k.startswith('mask/') for k in want['arrays'])} polygon masks, "
        f"{sum(k.startswith('limits/') for k in want['arrays'])} 2D and "
        f"{sum(k.startswith('proj/') for k in want['arrays'])} 3D axes, the viridis table, "
        f"in {fixture_s:.2f} s; keys apart: {bad}")
    check(not any(bad.values()), f"plot fixtures: keys apart {bad}")

    coco, frames = plot_fixtures.write_polygon_coco(str(work / "polygons"))
    apart = {}
    for frame, case in frames.items():
        (_, sil, _, _), _ = load_smil_sequence(coco, frame, 32, ["a", "b"], alt_seg=False)
        apart[case] = int(((sil[0] > 0) != want["arrays"][f"mask/{case}"]).sum())
    log(f"  load_smil_sequence(alt_seg=False) on {len(frames)} polygon frames: pixels apart "
        f"from matplotlib's masks {apart}")
    check(not any(apart.values()), f"polygon masks through load_smil_sequence: {apart}")
    out["fixtures"] = {"keys_apart": bad, "seconds": fixture_s, "polygon_pixels_apart": apart}
    out["plots"] = plot_sites(work, out["cli"]["merged"], card)
    return out


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

    log("[1/17] build")
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

    log("[2/17] kernels against their plain versions at the driven paths' shapes")
    shape = source_constants(RASTER_CU.read_text(), FWD_SHAPE + BWD_SHAPE)
    log(f"  launch shapes (csrc/raster.cu): {shape}")
    raster = ("exact_fwd", "exact_bwd", "worklist_fwd", "worklist_bwd")
    records = kernel_phase(spec, 1, SIZE, dev, timed=raster)
    # frames a launch × image: the fitter's profile and bench_all's N=10
    # configs (every raster kernel timed there too); bench_corpus (8 clips
    # at 256²); the batched fitter and the progressive fit's coarse scales
    # (128²)
    shapes = ((4, SIZE), (10, SIZE), (8, (256, 256)), (4, (128, 128)))
    for n_frames, size in shapes:
        timed = raster if n_frames == 10 else ()
        for rec, at_n in zip(records, kernel_phase(spec, n_frames, size, dev, timed)):
            if "ms" in at_n:
                rec.update(ms_10_frames=at_n["ms"], ms_spread_10_frames=at_n["ms_spread"],
                           bound_ms_10_frames=at_n["bound_ms"])
    for n_frames, size in ((1, SIZE),) + shapes:
        kernel_phase(spec, n_frames, size, dev, saturating=True)
    records.append(peak_phase(dev))
    log("[3/17] main path: SmalFitter, 4 stages × 10 steps, 1 frame at 512²")
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

    log("[4/17] references")
    reference_phase(spec, dev)

    log("[5/17] where the time goes: 1 and 10 frames")
    data10 = synthetic_fit_data(spec, 10, SIZE)
    for frames, d in ((1, data), (10, data10)):
        for mode, (mode_cap, _) in modes.items():
            profile_phase(spec, d, dev, f"{mode}, {frames} frame(s),", mode_cap)

    log("[6/17] bench path: bench, bench_all configs 1, 3, 3b, 3c (short windows)")
    bench_counts = bench_phase(spec, spec_name, dev)
    records[4]["launches"] = bench_counts["fma_peak"]

    log("[7/17] batched and progressive fitters, bench_corpus")
    batched_phase(spec, spec_name, dev)

    log("[8/17] fitter CLIs: optimize_to_joints (capped, exact, texture), optimize_corpus at 512²; "
        "the JPEG fixtures; optimize_to_joints on a JPEG frame, card and CPU")
    t0 = time.perf_counter()
    cli = cli_phase(spec, dev, card)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s")
    log("cli " + json.dumps(cli))

    log("[9/17] 3D registration: 8 targets, 2 stages, twice (bitwise equal); bench_all config2")
    t0 = time.perf_counter()
    registration_phase(spec, dev, card)
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s")

    log("[10/17] data pipeline: synthesize_multiview (1,600 samples, 4 views at 96²), "
        "DeviceDataCache, HDF5")
    t0 = time.perf_counter()
    records[0]["data_pipeline"], data_samples, data_store = data_phase(spec, dev, card)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")

    log("[11/17] neural serving: configs 4/5a card vs CPU, run_inference, multi-view serving, "
        "bench_all configs 4/5a/5b, config 4's profile")
    t0 = time.perf_counter()
    serving = serving_phase(spec, dev, card)
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    records[0]["serving_data"] = serving["multiview_data"]["k1"]
    log("serving " + json.dumps(serving))

    log("[12/17] training: bench_all configs 4b/4c/5c and 4b's profile, one float32 step card "
        "vs CPU, a learning check from DeviceDataCache, train_regressor (cache and host "
        "pipeline) then run_inference, train_pointnet, the input-pipeline bench")
    t0 = time.perf_counter()
    training = training_phase(spec, dev, card)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    records[0]["training_data_launches"] = training["learning"]["k1_launches"]
    log("training " + json.dumps(training, default=float))

    log("[13/17] slice 5: serving export (configs 4/5a, a fresh process, B=1/8/128); the "
        "sharded fitters and config 4b's data-parallel step on 1 rank over NCCL and on 2 ranks "
        "of the card over gloo")
    t0 = time.perf_counter()
    export = serving_export_phase(spec, dev, card)
    log(f"  (serving export: {time.perf_counter() - t0:.1f} s)")
    scale = scaleout_phase(card)
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")
    for rec in records[:4]:
        mode = "exact" if rec["name"].startswith("exact") else "capped"
        rec["scaleout_launches"] = {
            f"{key.split('_')[0]}_rank{r['rank']}": r["sequence"][mode]["launches"][rec["name"]]
            for key, run in scale.items() for r in run["ranks"]}
    log("scaleout " + json.dumps({"export": export, "scaleout": scale}, default=float))

    log("[14/17] slice 6, the tools: generate_video and run_inference --video; the OpenCV paths "
        "(raw video, an augmented epoch, blur, warps, undistortion); authoring from "
        "phase 9's registration (K1 once on the authored model), the native PCA loader, "
        "prepare_meshes; export_gltf on phase 11's animation; monitoring")
    t0 = time.perf_counter()
    zero_counts()
    tools = tools_phase(spec, dev, card)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    records[0]["authoring_launches"] = tools["authoring"]["k1_launches"]
    log("tools " + json.dumps(tools, default=float))

    log("[15/17] the learning proofs: memorize, single- and multi-view, the JAX gates; a toy "
        "heldout in two resumed calls")
    t0 = time.perf_counter()
    learning = learning_phase(dev, card)
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")
    records[0]["learning_launches"] = {m: r["launches"]["exact_fwd"] for m, r in learning.items()}
    log("learning " + json.dumps(learning, default=float))

    log("[16/17] the HDF5 stores (the port's codec): the fixtures; phase 10's store by "
        "generate_synthetic_multiview (K1); train_multiview, benchmark_model and "
        "dataset_viewer on it; preprocess_replicant, train_regressor and run_inference on a "
        "single-view store; a SLEAP session through preprocess_sleap_multiview")
    t0 = time.perf_counter()
    hdf5 = hdf5_phase(spec, dev, card, data_samples, data_store)
    del data_samples
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    records[0]["hdf5_launches"] = hdf5["synthetic"]["launches"]
    log("hdf5 " + json.dumps(hdf5, default=float))

    log("[17/17] slice 10: optimise_3d from a YAML stage file (a process of its own) against "
        "register(); the YAML, polygon, limit and projection fixtures; polygon masks through "
        "load_smil_sequence; every plot site's files at the JAX sizes")
    t0 = time.perf_counter()
    slice10 = slice10_phase(spec, dev, card)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    log("slice10 " + json.dumps(slice10, default=float))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    from smilify_tpu_torch.utils import monitoring

    # recorded throughout: the kernels' launch counts are the recorder's counters
    with monitoring.recording():
        if sys.argv[1:2] == ["--scaleout-rank"]:
            scaleout_rank(sys.argv[2], sys.argv[3])     # one rank of phase 13 (b)/(c)
        else:
            main()
