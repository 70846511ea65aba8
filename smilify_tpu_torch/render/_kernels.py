"""Build, load and launch the hand-written CUDA raster kernels.

``csrc/raster.cu`` has a plain C interface: it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of the
checkout on first use (the file name carries a hash of the sources and
flags, so an edited source is rebuilt), loaded with ``ctypes``, and its
kernels launch on PyTorch's current stream. Each C entry returns
``cudaGetLastError()`` after its launch; :func:`launch` raises when that is
not 0. Nothing here runs when the module is imported.
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
SOURCES = ("raster.cu",)
HEADERS = ("raster.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every pointer and the stream go as c_void_p: a plain int would be cut to 32 bits
_SIGNATURES = {
    # face_data, mask, S, work, N, C, H, W, inv_sigma, stream
    "smil_exact_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # face_data, mask, gS, dface, work, N, C, H, W, inv_sigma, stream
    "smil_exact_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # face_flat, idx, count, S, work, N, F8, k_sub, H, W, inv_sigma, stream
    "smil_worklist_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # face_flat, idx, count, gS, dface, work, N, F8, k_sub, H, W, inv_sigma, stream
    "smil_worklist_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the raster "
                           "kernels are compiled from csrc/ on first use")
    return found


def library_path() -> Path:
    """Where the built library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsmilify_raster_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. The nvcc command and its ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) go to a ``.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.smil_error_string.argtypes = (ctypes.c_int,)
    lib.smil_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry ``name``; raise if the launch reported a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.smil_error_string(err).decode()})")


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
