"""ctypes binding for the native smil_tools PCA loader
(``native/smil_tools.cpp``; port of ``smilify_tpu/utils/smil_tools_native.py``).

Mirrors the replicAnt UE plugin's Blueprint-facing API shape:
LoadPCADataFromCSV → :class:`PCAMorphData`; GeneratePCAWeights →
:func:`generate_weights`; weighted morph evaluation →
:meth:`PCAMorphData.apply_weights`.

The library is built on first use with ``g++ -O2 -std=c++17 -fPIC -shared``
into ``build/native/`` at the root of the checkout (git-ignored; the file
name carries a hash of the source and flags), never into ``native/``. A
build writes a file of its own and renames it into place, so concurrent
first uses do not race (as ``render/_kernels.py`` builds the CUDA
libraries). A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "smil_tools.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmil_tools_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/smil_tools.cpp`` unless this exact build exists;
    returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _get_lib():
    lib = ctypes.CDLL(str(build()))
    lib.smil_pca_load.restype = ctypes.c_void_p
    lib.smil_pca_load.argtypes = [ctypes.c_char_p]
    lib.smil_pca_error.restype = ctypes.c_char_p
    lib.smil_pca_error.argtypes = [ctypes.c_void_p]
    lib.smil_pca_num_bones.restype = ctypes.c_int
    lib.smil_pca_num_bones.argtypes = [ctypes.c_void_p]
    lib.smil_pca_num_components.restype = ctypes.c_int
    lib.smil_pca_num_components.argtypes = [ctypes.c_void_p]
    lib.smil_pca_bone_name.restype = ctypes.c_char_p
    lib.smil_pca_bone_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.smil_pca_raw.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.smil_pca_apply.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.smil_pca_generate_weights.argtypes = [
        ctypes.c_int, ctypes.c_float, ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)
    ]
    lib.smil_pca_free.argtypes = [ctypes.c_void_p]
    return lib


class PCAMorphData:
    """Loaded PCA morph data: bone_names, scaledirs/transdirs (J, 3, C)."""

    def __init__(self, path: str):
        lib = _get_lib()
        self._h = lib.smil_pca_load(path.encode())
        err = lib.smil_pca_error(self._h).decode()
        if err:
            lib.smil_pca_free(self._h)
            self._h = None
            raise ValueError(f"smil_tools: {err}")
        self.num_bones = lib.smil_pca_num_bones(self._h)
        self.num_components = lib.smil_pca_num_components(self._h)
        self.bone_names = [
            lib.smil_pca_bone_name(self._h, i).decode() for i in range(self.num_bones)
        ]
        raw = np.zeros(self.num_bones * self.num_components * 6, np.float32)
        lib.smil_pca_raw(self._h, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        raw = raw.reshape(self.num_bones, self.num_components, 6)
        self.scaledirs = np.transpose(raw[..., :3], (0, 2, 1))   # (J, 3, C)
        self.transdirs = np.transpose(raw[..., 3:], (0, 2, 1))   # (J, 3, C)

    def apply_weights(self, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """weights (C,) → (scale (J, 3) with base 1, translation (J, 3))."""
        lib = _get_lib()
        w = np.asarray(weights, np.float32)
        out = np.zeros(self.num_bones * 6, np.float32)
        lib.smil_pca_apply(
            self._h, w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        out = out.reshape(self.num_bones, 6)
        return out[:, :3].copy(), out[:, 3:].copy()

    def __del__(self):
        if getattr(self, "_h", None):
            _get_lib().smil_pca_free(self._h)


def generate_weights(num_components: int, stddev: float, seed: int = 0) -> np.ndarray:
    lib = _get_lib()
    out = np.zeros(num_components, np.float32)
    lib.smil_pca_generate_weights(
        num_components, stddev, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    return out


def export_pca_csv(path: str, bone_names: List[str], scaledirs: np.ndarray, transdirs: np.ndarray):
    """Write the plugin's CSV schema from (J, 3, C) dirs (the Blender addon's
    export side, so authored models round-trip into replicAnt)."""
    J, _, C = scaledirs.shape
    header = ["joint_name"]
    for c in range(1, C + 1):
        header += [f"PC_{c}_scale_{a}" for a in "xyz"]
        header += [f"PC_{c}_translation_{a}" for a in "xyz"]
    lines = [",".join(header)]
    for j, name in enumerate(bone_names):
        row = [name]
        for c in range(C):
            row += [f"{scaledirs[j, i, c]:.8f}" for i in range(3)]
            row += [f"{transdirs[j, i, c]:.8f}" for i in range(3)]
        lines.append(",".join(row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
