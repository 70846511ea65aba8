"""The committed HDF5 fixtures (``tests/fixtures/hdf5/``): small files that
h5py wrote, and ``expected.npz``, what each holds.

:func:`contents` flattens an open file (the port's ``utils/hdf5_io.File`` or
an ``h5py.File``: the same API and, the point of the codec, the same values)
into plain numpy arrays, so that the expected contents are an ``.npz``
without pickles: every dataset with its dtype and shape, variable-length
columns as their items' bytes and lengths, every attribute with its type as
h5py returns it. :func:`check` reads each fixture through the codec and
lists every key that differs from ``expected.npz``, bit for bit
(``tests/test_torch_hdf5.py`` on the CPU, ``chip_smoke.py`` phase 16 on
the card). The fixtures are written by h5py and the JAX package, so their
generator is in the test (``write_fixtures``), which checks that it still
writes what the ``.npz`` holds.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

FIXTURES = ("multiview18.h5", "singleview.h5", "analysis.h5", "session.slp", "points3d.h5",
            "latest.h5")
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures", "hdf5")


def _type_name(dtype: np.dtype) -> str:
    meta = dtype.metadata or {}
    if "vlen" in meta:
        vlen = meta["vlen"]
        return f"vlen {vlen.__name__ if isinstance(vlen, type) else np.dtype(vlen).str}"
    return f"{dtype.descr} {meta.get('h5py_encoding', '')}"


def _flat_value(out: Dict[str, np.ndarray], key: str, value, dtype: np.dtype):
    """``value`` under ``key``, its Python type and dtype under ``key|type``;
    a variable-length array as ``key|data`` (the items' bytes end to end)
    and ``key|lengths``."""
    out[key + "|type"] = np.asarray(f"{type(value).__name__} {_type_name(dtype)}")
    if isinstance(value, np.ndarray) and value.dtype.kind == "O":
        items = [x.encode() if isinstance(x, str) else
                 x if isinstance(x, bytes) else np.ascontiguousarray(x).tobytes()
                 for x in value.reshape(-1)]
        out[key + "|data"] = np.frombuffer(b"".join(items), np.uint8)
        out[key + "|lengths"] = np.asarray([len(x) for x in items], np.int64).reshape(value.shape)
    else:
        out[key] = np.asarray(value)


def contents(f) -> Dict[str, np.ndarray]:
    """An open HDF5 file → {key: array}: ``path`` for a dataset's values,
    ``path@name`` for an attribute's (the root's: ``@name``)."""
    out: Dict[str, np.ndarray] = {}

    def attrs(prefix, obj):
        for name, value in obj.attrs.items():
            dtype = getattr(value, "dtype", np.dtype(object))
            _flat_value(out, f"{prefix}@{name}", value, dtype)

    def visit(name, obj):
        if hasattr(obj, "shape"):
            _flat_value(out, name, obj[()], obj.dtype)
            out[name + "|shape"] = np.asarray(obj.shape, np.int64)
        attrs(name, obj)

    attrs("", f)
    f.visititems(visit)
    return out


def differences(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> List[str]:
    """The keys in which two flattened files differ: present in one only,
    or another dtype, shape or byte."""
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        g, w = got[k], want[k]
        if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
            bad.append(k)
    return bad


_META = ("|type", "|shape")


def save_expected(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Flattened contents as an ``.npz``: the values as arrays, the types and
    shapes (small, many) in one JSON string."""
    meta = {k: v.tolist() for k, v in flat.items() if k.endswith(_META)}
    np.savez_compressed(path, __meta__=np.asarray(json.dumps(meta)),
                        **{k: v for k, v in flat.items() if not k.endswith(_META)})


def load_expected(path: str) -> Dict[str, np.ndarray]:
    """What :func:`save_expected` wrote."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files if k != "__meta__"}
        meta = json.loads(str(npz["__meta__"]))
    flat.update({k: np.asarray(v, np.int64) if k.endswith("|shape") else np.asarray(v)
                 for k, v in meta.items()})
    return flat


def check(directory: str = FIXTURE_DIR) -> Dict[str, List[str]]:
    """Each fixture read through the port's codec against ``expected.npz``
    → {fixture: the keys that differ} (all empty when the codec reads them)."""
    from smilify_tpu_torch.utils import hdf5_io

    expected = load_expected(os.path.join(directory, "expected.npz"))
    out = {}
    for name in FIXTURES:
        with hdf5_io.File(os.path.join(directory, name), "r") as f:
            got = {f"{name}:{k}": v for k, v in contents(f).items()}
        want = {k: v for k, v in expected.items() if k.startswith(f"{name}:")}
        out[name] = differences(got, want)
    return out
