"""Loading of SMIL/SMAL ``.pkl`` model assets.

The public asset format (reference: ``smal_model/smal_torch.py:21-84`` and
``config.py:76-141``) is a single pickle dict that may contain legacy chumpy
(``chumpy.ch.Ch``) arrays and latin1-encoded python2 strings. We reproduce the
loading *behavior* — every chumpy array is materialized as a plain numpy array,
sparse ``J_regressor`` matrices are densified — without importing chumpy.

Keys (all optional unless noted):
  v_template (V,3)      required — template vertices
  f          (F,3)      required — triangle faces
  shapedirs  (V,3,B)              — shape blendshape basis
  posedirs   (V,3,P) or (0,)      — pose-corrective blendshape basis
  J_regressor (J,V)     required  — vertex→joint regressor (may be scipy sparse)
  J          (J,3)                — rest joint locations (static-joint models)
  kintree_table (2,J)   required  — row 0 = parent indices (root parent = -1/2^32-1)
  weights    (V,J)      required  — LBS skinning weights
  J_names    list[str]            — joint names
  sym_verts  (S,)                 — vertex ids on the symmetry plane
  shape_cov  (B,B), shape_mean_betas (B,) — shape prior
  scaledirs / transdirs (B,J,3)   — entangled PCA for per-joint scale/translation
  static_joint_locs bool          — use dd['J'] instead of regressing joints

A copy of ``smilify_tpu/core/io.py``: the port keeps its own copy of this
JAX-free module so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import pickle

import numpy as np


class _ChumpyShim:
    """Stand-in for ``chumpy.ch.Ch`` that keeps only the numeric payload."""

    def __init__(self, *args, **kwargs):
        self.data = np.asarray(args[0]) if args else np.empty(0)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.data = np.asarray(state.get("x", []))
        elif isinstance(state, (tuple, list)):
            self.data = np.asarray(state[0])
        else:
            self.data = np.asarray(state)
        return self

    def __array__(self, dtype=None):
        return self.data if dtype is None else self.data.astype(dtype)


class _CompatUnpickler(pickle.Unpickler):
    """latin1 unpickler that maps chumpy classes onto :class:`_ChumpyShim`."""

    def __init__(self, file):
        super().__init__(file, encoding="latin1")

    def find_class(self, module, name):
        if module.startswith("chumpy") and name == "Ch":
            return _ChumpyShim
        return super().find_class(module, name)


def _densify(value):
    """numpy-ify a loaded value: chumpy shims and scipy sparse → ndarray."""
    if isinstance(value, _ChumpyShim):
        return value.data
    if hasattr(value, "todense"):  # scipy sparse (J_regressor in legacy models)
        return np.asarray(value.todense())
    return value


def load_raw_model(path: str) -> dict:
    """Load a SMIL/SMAL model pickle into a dict of plain numpy values."""
    with open(path, "rb") as f:
        dd = _CompatUnpickler(f).load()
    return {k: _densify(v) for k, v in dd.items()}
