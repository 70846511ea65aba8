"""Build, load and launch the port's hand-written CUDA kernels.

Each library in :data:`LIBRARIES` has a plain C interface: its sources in
``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the root of the checkout on first use (the file
name carries a hash of the sources and flags, so an edited source is
rebuilt), loaded with ``ctypes``, and its kernels launch on PyTorch's current
stream. :func:`build_all` starts one ``nvcc`` per library, all at once. Each
C entry returns ``cudaGetLastError()`` after its launch; :func:`launch`
raises when that is not 0. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# library → (sources, headers)
LIBRARIES = {
    "raster": (("raster.cu",), ("raster.cuh",)),   # K1-K4
    "peak": (("peak.cu",), ()),                    # K5
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# FP32 operations per (pixel, face) pair of the raster kernels, counted from
# csrc/raster.cuh (an FMA counts 2; exp and log1p count 1 each): the
# numerators of every raster roofline (chip_smoke.py, tools/bench_all.py)
FWD_OPS_PER_PAIR = 76    # fwd_term: 3 edges × 18, min/inside/sign 14, softplus 5, ×valid, +=
BWD_OPS_PER_PAIR = 93    # bwd_term: signed distance 68, sigmoid 4, weight 5, edge pick 5, 6 grads 11

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry → (library, argtypes); every pointer and the stream go as c_void_p:
# a plain int would be cut to 32 bits
_SIGNATURES = {
    # face_data, mask, S, work, N, C, H, W, inv_sigma, stream
    "smil_exact_fwd": ("raster", (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    # face_data, mask, gS, dface, work, N, C, H, W, inv_sigma, stream
    "smil_exact_bwd": ("raster", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    # face_flat, idx, count, S, work, N, F8, k_sub, H, W, inv_sigma, stream
    "smil_worklist_fwd": ("raster", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    # face_flat, idx, count, gS, dface, work, N, F8, k_sub, H, W, inv_sigma, stream
    "smil_worklist_bwd": ("raster", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    # x, out, n, stream
    "smil_fma_peak": ("peak", (_P, _P, _I, _P)),
}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the CUDA "
                           "kernels are compiled from csrc/ on first use")
    return found


def library_path(name: str = "raster") -> Path:
    """Where the built library ``name`` for the current sources and flags lives."""
    sources, headers = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libsmilify_{name}_{h.hexdigest()[:12]}.so"


def build_all(names=tuple(LIBRARIES)) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process each, all started together; returns {name: library path}. The
    nvcc command and its ``-Xptxas -v`` report (registers, shared memory,
    spills per kernel) go to a ``.log`` beside each library. Waits for every
    nvcc it started before it raises on a failed one."""
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in LIBRARIES[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (out, tmp, cmd, proc)
    failed = []
    for name, (out, tmp, cmd, proc) in running.items():
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed with code {proc.returncode}:\n{stderr[-6000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build(name: str = "raster") -> Path:
    """Compile library ``name`` unless this exact build exists; returns its path."""
    return build_all((name,))[name]


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    lib = ctypes.CDLL(str(build(name)))
    for entry, (owner, argtypes) in _SIGNATURES.items():
        if owner == name:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.smil_error_string.argtypes = (ctypes.c_int,)
    lib.smil_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry: str, *args) -> None:
    """Call C entry ``entry``; raise if the launch reported a CUDA error."""
    lib = library(_SIGNATURES[entry][0])
    err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(
            f"{entry}: CUDA error {err} ({lib.smil_error_string(err).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int | None:
    """Device pointer of an optional tensor (None → NULL)."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype, shape, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape (on ``device`` when given), aligned for 16-byte loads."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def check_work(work, n: int, device) -> None:
    if work is not None:
        check(work, "work", torch.int32, (n,), device)
