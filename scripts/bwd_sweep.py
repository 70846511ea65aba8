"""One-off measurement: the backward raster kernels K2 and K4
(``smilify_tpu_torch/csrc/raster.cu``) at each launch shape tried, on one
NVIDIA GPU.

    python3 scripts/bwd_sweep.py [--frames 1 10] [--threads 128 256 512]
        [--slices 8:4 16:8 32:16 64:32] [--baseline DIR] [--out build/bwd_sweep.json]

The launch shape is three constants of ``raster.cu`` (``kBwdThreads``,
``kK2Slice``, ``kK4Span``: threads a block, cull bits a K2 block takes,
work-list entries a K4 block takes). For each of ``--threads`` ×
``--slices`` this copies ``csrc/`` under ``build/bwd_sweep/`` with those
constants rewritten and builds it with the port's nvcc flags, every nvcc
started at once, and prints what ptxas reports for the two kernels.
``--baseline DIR`` adds the kernels of another checkout at DIR, unchanged
(its ``smilify_tpu_torch/csrc``, with the same C interface).

For every variant and frame count it holds K2 and K4 to their plain versions
(atol 5e-3, rtol 1e-3) and their ``work`` counts to the subgroups the plain
versions evaluate, then times each with CUDA events (mean of 20 launches
after 2), twice: the variants in order, then in reverse. The workload is
``chip_smoke.py``'s phase 2 at 512². Prints the card's name and power limit,
then one JSON line a (variant, kernel, frames), and writes them all to
``--out``. Exits non-zero if any variant disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from smilify_tpu_torch._device import card_line, resolve_device  # noqa: E402
from smilify_tpu_torch.render import _kernels  # noqa: E402
from smilify_tpu_torch.render import rasterizer as R  # noqa: E402
from smilify_tpu_torch.render import rasterizer_worklist as RW  # noqa: E402

THREADS = (128, 256, 512)
SLICES = ((8, 4), (16, 8), (32, 16), (64, 32))   # (K2 subgroups, K4 entries) a block
BUILD = ROOT / "build" / "bwd_sweep"
ENTRIES = {"exact": "smil_exact_bwd", "worklist": "smil_worklist_bwd"}


def shaped_source(shape):
    """raster.cu with the launch-shape constants set to ``shape`` ({name: value})."""
    src = (_kernels.CSRC / "raster.cu").read_text()
    for k, v in shape.items():
        src, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", src)
        if n != 1:
            raise RuntimeError(f"raster.cu: no single definition of {k}")
    return src


def build_variants(variants):
    """Build every variant ({name: (csrc dir, raster.cu text)}), one nvcc
    each, all at once; returns {name: loaded library with its C entries typed}."""
    running = {}
    for name, (csrc, source) in variants.items():
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "raster.cuh", d / "raster.cuh")
        (d / "raster.cu").write_text(source)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(d / "libraster.so"),
               str(d / "raster.cu")]
        running[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    libs, failed = {}, []
    for name, (d, proc) in running.items():
        out, err = proc.communicate()
        (d / "nvcc.log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed:\n{err[-4000:]}")
            continue
        lib = ctypes.CDLL(str(d / "libraster.so"))
        for entry, (owner, argtypes) in _kernels._SIGNATURES.items():
            if owner == "raster":
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def ptxas_lines(name):
    """The -Xptxas -v lines of the backward kernels in a variant's build log."""
    lines, keep = [], False
    for line in (BUILD / name / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line:
            keep = "_bwd_kernel" in line
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def launch(lib, kind, x, work):
    """One K2/K4 launch from ``lib``; returns dface."""
    if kind == "exact":
        dface = torch.zeros_like(x.face)
        args = (x.face.data_ptr(), x.mask.data_ptr(), x.gS.data_ptr(), dface.data_ptr(),
                work.data_ptr(), x.N, x.C, x.H, x.W)
    else:
        dface = torch.zeros_like(x.flat)
        args = (x.flat.data_ptr(), x.idx.data_ptr(), x.cnt.data_ptr(), x.gS.data_ptr(),
                dface.data_ptr(), work.data_ptr(), x.N, x.flat.shape[1], x.k_sub, x.H, x.W)
    err = getattr(lib, ENTRIES[kind])(*args, 1.0 / smoke.SIGMA, _kernels.stream())
    if err != 0:
        raise RuntimeError(f"{ENTRIES[kind]}: CUDA error {err}")
    return dface


def run(spec, frames, threads, slices, baseline, out):
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    shapes = {f"t{n}_k2s{k2}_k4s{k4}": {"kBwdThreads": n, "kK2Slice": k2, "kK4Span": k4}
              for n in threads for k2, k4 in slices}
    variants = {name: (_kernels.CSRC, shaped_source(s)) for name, s in shapes.items()}
    if baseline is not None:
        csrc = Path(baseline) / "smilify_tpu_torch" / "csrc"
        variants = {"baseline": (csrc, (csrc / "raster.cu").read_text()), **variants}
    libs = build_variants(variants)
    for name in shapes:
        for line in ptxas_lines(name):
            print(f"ptxas {name}: {line}", flush=True)
    results = []
    for n_frames in frames:
        x = smoke.raster_inputs(spec, n_frames, (512, 512), dev)
        for kind in ENTRIES:
            plain = R.exact_bwd_plain if kind == "exact" else RW.worklist_bwd_plain
            args = (x.face, x.mask) if kind == "exact" else (x.flat, x.idx, x.cnt)
            ref = plain(*args, x.gS, x.H, x.W, smoke.SIGMA)
            expect = smoke.plain_work(kind, x)
            times = {v: [] for v in libs}
            for order in (list(libs), list(reversed(libs))):
                for v in order:
                    work = torch.zeros(x.N * x.T, dtype=torch.int32, device=dev)
                    times[v].append(smoke.cuda_ms(lambda: launch(libs[v], kind, x, work), reps=20))
            for v, lib in libs.items():
                work = torch.zeros(x.N * x.T, dtype=torch.int32, device=dev)
                got = launch(lib, kind, x, work)
                torch.cuda.synchronize()
                blocks = (x.T * x.N, None) if v == "baseline" else smoke.bwd_blocks(kind, x, shapes[v])
                rec = {"frames": n_frames, "kernel": f"{kind}_bwd", "variant": v,
                       "ms": times[v], "blocks": blocks[0], "blocks_with_work": blocks[1],
                       "max_abs_err": float((got - ref).abs().max()),
                       "close": bool(torch.isclose(got, ref, atol=smoke.GRAD_ATOL,
                                                   rtol=smoke.GRAD_RTOL).all()),
                       "work_equal": bool(torch.equal(work, expect))}
                print(json.dumps(rec), flush=True)
                results.append(rec)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card_line(), "results": results}, indent=1))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 10])
    ap.add_argument("--threads", type=int, nargs="+", default=list(THREADS))
    ap.add_argument("--slices", nargs="+", default=[f"{a}:{b}" for a, b in SLICES],
                    help="K2 subgroups:K4 entries a block, e.g. 16:8")
    ap.add_argument("--baseline", default=None, help="root of another checkout to time beside")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bwd_sweep.json")
    args = ap.parse_args(argv)
    from smilify_tpu_torch.bench import load_spec

    spec, _ = load_spec(device=resolve_device("cuda"))
    slices = [tuple(int(v) for v in s.split(":")) for s in args.slices]
    results = run(spec, args.frames, args.threads, slices, args.baseline, args.out)
    if not all(r["close"] and r["work_equal"] for r in results):
        sys.exit("bwd_sweep: a kernel disagrees with its plain version or its work count")


if __name__ == "__main__":
    main()
