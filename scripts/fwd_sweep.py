"""One-off measurement: the forward raster kernels K1 and K3
(``smilify_tpu_torch/csrc/raster.cu``) at each cluster shape tried, on one
NVIDIA GPU.

    python3 scripts/fwd_sweep.py [--cluster 1 2 4 8] [--lanes 1] [--threads 64 128 256]
        [--frames 1 10] [--baseline DIR] [--out build/fwd_sweep.json]

The launch shape is three constants of ``raster.cu``: ``kFwdCluster``
(blocks of the thread-block cluster that takes one tile), ``kFwdLanes``
(blocks of a cluster that split one slab of the tile's rows by faces; 1 is
the pure pixel split) and ``kFwdThreads`` (threads a block). For each of
``--cluster`` × ``--lanes`` × ``--threads`` that ``raster.cu``'s
static_asserts admit (whole slabs of rows, at least one pixel and at most
one batch entry a thread) this copies
``csrc/`` under ``build/fwd_sweep/`` with those constants rewritten and
builds it with the port's nvcc flags, every nvcc started at once (the
helpers of ``scripts/bwd_sweep.py``), and prints what ptxas reports for the
two kernels. ``--baseline DIR`` adds the kernels of another checkout at DIR,
unchanged (its ``smilify_tpu_torch/csrc``, with the same C interface).

For every frame count, scene (``chip_smoke.py``'s phase-2 workload at 512²:
the posed mesh, and the saturating scene, whose tiles partly stop early)
and variant it holds K1 and K3 to their plain versions (alpha atol 1e-5),
their ``work`` counts to the plain versions' tile by tile, and reports the
largest |ΔS| against the baseline's kernels (0 when every pixel's S is the
same sequence of float additions, as with one lane). Then it times each with CUDA events
(mean of 20 launches after 2), twice: the variants in order, then in
reverse. Prints the card's name and power limit, then one JSON line a
(frames, scene, kernel, variant), and writes them all to ``--out``. Exits
non-zero if any variant disagrees.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import bwd_sweep  # noqa: E402
import chip_smoke as smoke  # noqa: E402
from smilify_tpu_torch._device import card_line, resolve_device  # noqa: E402
from smilify_tpu_torch.render import _kernels  # noqa: E402
from smilify_tpu_torch.render import rasterizer as R  # noqa: E402
from smilify_tpu_torch.render import rasterizer_worklist as RW  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
LANES = (1,)
THREADS = (64, 128, 256)
BUILD = ROOT / "build" / "fwd_sweep"
ENTRIES = {"exact": "smil_exact_fwd", "worklist": "smil_worklist_fwd"}
SCENES = {"smoke": False, "saturating": True}   # name → chip_smoke's `saturating`


def launch(lib, kind, x, work):
    """One K1/K3 launch from ``lib``; returns the S tiles."""
    S = torch.empty((x.N, x.T, R.TILE_PIX), device=x.face.device)
    if kind == "exact":
        args = (x.face.data_ptr(), x.mask.data_ptr(), S.data_ptr(), work.data_ptr(), x.N, x.C,
                x.H, x.W)
    else:
        args = (x.flat.data_ptr(), x.idx.data_ptr(), x.cnt.data_ptr(), S.data_ptr(),
                work.data_ptr(), x.N, x.flat.shape[1], x.k_sub, x.H, x.W)
    err = getattr(lib, ENTRIES[kind])(*args, 1.0 / smoke.SIGMA, _kernels.stream())
    if err != 0:
        raise RuntimeError(f"{ENTRIES[kind]}: CUDA error {err}")
    return S


def admitted(cluster, lanes, threads):
    """Whether raster.cu's static_asserts admit this forward launch shape."""
    if cluster > 8 or cluster % lanes or R.TILE_H % (cluster // lanes):
        return False
    slab_pix = R.TILE_PIX // (cluster // lanes)
    return (threads % 32 == 0 and threads >= R.GROUPS_PER_CHUNK and slab_pix >= threads
            and slab_pix % threads == 0 and slab_pix % lanes == 0)


def run(spec, frames, clusters, lanes, threads, baseline, out):
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    shapes = {f"c{k}_l{m}_t{n}": {"kFwdCluster": k, "kFwdLanes": m, "kFwdThreads": n}
              for k in clusters for m in lanes for n in threads if admitted(k, m, n)}
    variants = {name: (_kernels.CSRC, bwd_sweep.shaped_source(s)) for name, s in shapes.items()}
    if baseline is not None:
        csrc = Path(baseline) / "smilify_tpu_torch" / "csrc"
        variants = {"baseline": (csrc, (csrc / "raster.cu").read_text()), **variants}
    libs = bwd_sweep.build_variants(variants, BUILD)
    for name in variants:
        for line in bwd_sweep.ptxas_lines(name, BUILD, "_fwd_kernel"):
            print(f"ptxas {name}: {line}", flush=True)
    results = []
    for n_frames in frames:
        for scene, saturating in SCENES.items():
            x = smoke.raster_inputs(spec, n_frames, (512, 512), dev, saturating)
            for kind in ENTRIES:
                plain = R.exact_fwd_plain if kind == "exact" else RW.worklist_fwd_plain
                args = (x.face, x.mask) if kind == "exact" else (x.flat, x.idx, x.cnt)
                expect = torch.empty(x.N * x.T, dtype=torch.int32, device=dev)
                ref = plain(*args, x.H, x.W, smoke.SIGMA, work=expect)
                stopped = int((expect < smoke.listed_work(kind, x)).sum())
                work = torch.empty_like(expect)
                times = {v: [] for v in libs}
                for order in (list(libs), list(reversed(libs))):
                    for v in order:
                        times[v].append(smoke.cuda_ms(lambda: launch(libs[v], kind, x, work),
                                                      reps=20))
                got = {}
                for v, lib in libs.items():
                    work.fill_(-1)
                    got[v] = launch(lib, kind, x, work)
                    torch.cuda.synchronize()
                    err = float((torch.exp(-got[v]) - torch.exp(-ref)).abs().max())
                    rec = {"frames": n_frames, "scene": scene, "kernel": f"{kind}_fwd",
                           "variant": v, "ms": times[v], "max_abs_err": err,
                           "close": err <= smoke.ALPHA_ATOL,
                           "work_equal": bool(torch.equal(work, expect)),
                           "tiles_stopped_early": stopped, "subgroups": int(expect.sum())}
                    if "baseline" in got:
                        dS = (got[v] - got["baseline"]).abs().max()
                        rec["max_abs_dS_vs_baseline"] = float(dS)
                    print(json.dumps(rec), flush=True)
                    results.append(rec)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card_line(), "results": results}, indent=1))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cluster", type=int, nargs="+", default=list(CLUSTERS))
    ap.add_argument("--lanes", type=int, nargs="+", default=list(LANES))
    ap.add_argument("--threads", type=int, nargs="+", default=list(THREADS))
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 10])
    ap.add_argument("--baseline", default=None, help="root of another checkout to time beside")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fwd_sweep.json")
    args = ap.parse_args(argv)
    from smilify_tpu_torch.bench import load_spec

    spec, _ = load_spec(device=resolve_device("cuda"))
    results = run(spec, args.frames, args.cluster, args.lanes, args.threads, args.baseline,
                  args.out)
    if not all(r["close"] and r["work_equal"] for r in results):
        sys.exit("fwd_sweep: a kernel disagrees with its plain version or its work count")


if __name__ == "__main__":
    main()
