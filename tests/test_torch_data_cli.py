"""The port's data CLIs (smilify_tpu_torch.cli: preprocess_replicant,
preprocess_replicant_multiview, preprocess_sleap, preprocess_sleap_multiview,
sleap_tools, dataset_viewer) against the JAX package's on the CPU.

Each CLI pair runs on the same files, written by the test: a toy model
pickle, replicAnt frames, SLEAP sessions (MJPG videos, an analysis-HDF5
export and a native .slp table, a calibration), multi-view HDF5 sets. Their
outputs are compared file against file: every HDF5 array and attribute
equal, the JPEG bytes included, except the camera refinement, held as in
``test_torch_data.py``. The five preprocessing tools run on the host only
and take no device; the viewer renders on ``--device cpu``. The viewer's panels are PNG: equal pixels, apart from
the Phong overlay's silhouette rim (``test_torch_cli.py``'s tolerance for
the renderer).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os

import cv2
import h5py
import numpy as np
import pytest
import torch

from smilify_tpu.cli import dataset_viewer as jviewer
from smilify_tpu.cli import preprocess_replicant as jrep_cli
from smilify_tpu.cli import preprocess_replicant_multiview as jrepmv_cli
from smilify_tpu.cli import preprocess_sleap as jsleap_cli
from smilify_tpu.cli import preprocess_sleap_multiview as jsleapmv_cli
from smilify_tpu.cli import sleap_tools as jtools_cli
from smilify_tpu.core.spec import load_model_spec as jax_load_model_spec
from smilify_tpu.data import hdf5_dataset as jh5
from smilify_tpu.data import sleap as jsl
from smilify_tpu.data import synthetic as jsyn

from smilify_tpu_torch.cli import dataset_viewer as tviewer
from smilify_tpu_torch.cli import preprocess_replicant as trep_cli
from smilify_tpu_torch.cli import preprocess_replicant_multiview as trepmv_cli
from smilify_tpu_torch.cli import preprocess_sleap as tsleap_cli
from smilify_tpu_torch.cli import preprocess_sleap_multiview as tsleapmv_cli
from smilify_tpu_torch.cli import sleap_tools as ttools_cli
from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
from smilify_tpu_torch.utils.image_io import read_png
from tests.test_torch_data import NODES, _write_session, write_unreal_frames

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A toy model pickle and its joint names as the loaders read them."""
    path = write_model_pkl(str(tmp_path_factory.mktemp("model") / "toy.pkl"),
                           toy_model_spec(8, 6, 3, device="cpu"))
    return path, list(load_model_spec(path, align_symmetry=False, device="cpu").joint_names)


def _h5_type(dtype, shape):
    """A dataset's or attribute's type as h5py reports it: the numpy dtype,
    the shape, the string encoding and length, the variable-length base."""
    return dtype, shape, h5py.check_string_dtype(dtype), h5py.check_vlen_dtype(dtype)


def _read_h5(path):
    out = {}

    def visit(name, obj):
        types = {}
        if isinstance(obj, h5py.Dataset):
            data = obj[()]
            if obj.dtype.kind == "O" and obj.dtype != h5py.string_dtype():
                data = [np.asarray(x) for x in data]
            out[name] = data
            types[""] = _h5_type(obj.dtype, obj.shape)
        out[name + "@attrs"] = {k: np.asarray(v) for k, v in obj.attrs.items()}
        for k in obj.attrs:
            aid = obj.attrs.get_id(k)
            types[k] = _h5_type(aid.dtype, aid.shape)
        out[name + "@type"] = types

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def assert_same_h5(got_path, want_path):
    """Two HDF5 files hold the same groups, arrays (the JPEG bytes
    included) and attributes, each of the same type and shape as h5py
    reports them."""
    got, want = _read_h5(got_path), _read_h5(want_path)
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("@type"):
            assert g == w, k
        elif k.endswith("@attrs"):
            assert g.keys() == w.keys(), k
            for a in w:
                np.testing.assert_array_equal(g[a], w[a], err_msg=f"{k} {a}")
        elif isinstance(w, list) or np.asarray(w).dtype == object:   # variable-length columns
            assert len(g) == len(w), k
            for i, (gb, wb) in enumerate(zip(g, w)):
                np.testing.assert_array_equal(gb, wb, err_msg=f"{k}[{i}]")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


def test_preprocess_replicant_matches_jax(tmp_path, model):
    pkl, names = model
    frames = str(tmp_path / "replicAnt-x-SMIL")
    write_unreal_frames(frames, names, 3, size=(60, 80))
    # a frame without its JPG is skipped by both
    os.remove(os.path.join(frames, "replicAnt-x-SMIL_01.JPG"))
    outs = {}
    for name, cli, extra in (("jax", jrep_cli, []), ("torch", trep_cli, [])):
        outs[name] = str(tmp_path / f"{name}.h5")
        cli.main(["--input", frames, "--output", outs[name], "--model", pkl,
                  "--resolution", "48"] + extra)
    assert_same_h5(outs["torch"], outs["jax"])
    with h5py.File(outs["torch"]) as f:
        assert f["metadata"].attrs["num_samples"] == 2
        assert list(f["metadata"].attrs["skipped_frame_indices"]) == [1]


def test_preprocess_replicant_multiview_matches_jax(tmp_path, model):
    pkl, names = model
    trial = tmp_path / "trial"
    for c in range(3):
        write_unreal_frames(str(trial / f"cam{c}"), names, 3 - (c == 2), size=(64, 64), seed=c)
    outs = {}
    for name, cli, extra in (("jax", jrepmv_cli, []), ("torch", trepmv_cli, [])):
        for mode in ("default", "bbox_crop"):
            outs[name, mode] = str(tmp_path / f"{name}_{mode}.h5")
            cli.main(["--input", str(trial), "--output", outs[name, mode], "--model", pkl,
                      "--resolution", "32", "--crop-mode", mode] + extra)
    for mode in ("default", "bbox_crop"):
        assert_same_h5(outs["torch", mode], outs["jax", mode])


@pytest.fixture(scope="module")
def sleap_root(tmp_path_factory, model):
    """Two SLEAP sessions of two cameras and a joint lookup onto the model."""
    _, names = model
    root = tmp_path_factory.mktemp("sleap")
    for s in ("sessA", "sessB"):
        _write_session(str(root / "sessions" / s))
    lookup = root / "lookup.csv"
    lookup.write_text("sleap_name,model_name\n" + "".join(
        f"{n},{names[i + 1]}\n" for i, n in enumerate(NODES[:3])) + f"{NODES[3]},\n")
    return root, str(lookup)


@pytest.mark.parametrize("mode", ["default", "bbox_crop"])
def test_preprocess_sleap_matches_jax(tmp_path, model, sleap_root, mode):
    pkl, _ = model
    root, lookup = sleap_root
    outs = {}
    for name, cli, extra in (("jax", jsleap_cli, []), ("torch", tsleap_cli, [])):
        outs[name] = str(tmp_path / f"{name}.h5")
        cli.main([str(root / "sessions"), outs[name], "--model", pkl, "--joint-lookup", lookup,
                  "--target-resolution", "32", "--crop-mode", mode, "--validate"] + extra)
    assert_same_h5(outs["torch"], outs["jax"])
    meta = [json.loads(open(p + ".meta.json").read()) for p in (outs["torch"], outs["jax"])]
    assert meta[0] == meta[1] and meta[0]["stats"]["frames"] > 0


def test_preprocess_sleap_multiview_matches_jax(tmp_path, model, sleap_root):
    pkl, _ = model
    root, lookup = sleap_root
    sessions = [str(root / "sessions" / s) for s in ("sessA", "sessB")]
    outs = {}
    for name, cli, extra in (("jax", jsleapmv_cli, []), ("torch", tsleapmv_cli, [])):
        outs[name] = str(tmp_path / f"{name}.h5")
        cli.main(["--sessions", *sessions, "--output", outs[name], "--model", pkl,
                  "--joint-lookup", lookup, "--resolution", "32", "--crop-mode", "centred",
                  "--min-views", "1"] + extra)
    assert_same_h5(outs["torch"], outs["jax"])


def test_sleap_tools_match_jax(tmp_path):
    sess = _write_session(str(tmp_path / "sess"), consistent=True)
    for name, cli, pre in (("jax", jtools_cli, []), ("torch", ttools_cli, [])):
        d = tmp_path / name
        d.mkdir()
        cli.main(pre + ["triangulate", "--session", sess, "--output", str(d / "p3d.h5"),
                        "--min-confidence", "0.2"])
        cli.main(pre + ["refine-cameras", "--session", sess, "--output", str(d / "cal.toml"),
                        "--iters", "2", "--min-confidence", "0.2"])
        cli.main(pre + ["reproject", "--points3d", str(d / "p3d.h5"), "--calibration",
                        os.path.join(sess, "calibration.toml"), "--output", str(d / "rep.h5")])
    t, j = tmp_path / "torch", tmp_path / "jax"
    # the triangulation goes through the Rodrigues replacement: 1e-9 relative
    for f in ("p3d.h5", "rep.h5"):
        got, want = _read_h5(str(t / f)), _read_h5(str(j / f))
        assert got.keys() == want.keys()
        for k in want:
            if k.endswith("@attrs"):
                assert got[k].keys() == want[k].keys()
            elif k.endswith("@type"):
                assert got[k] == want[k], k
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)
    for a, b in zip(jsl.load_calibration_toml(str(t / "cal.toml")),
                    jsl.load_calibration_toml(str(j / "cal.toml"))):
        np.testing.assert_allclose(a.matrix, b.matrix, rtol=1e-4)
        np.testing.assert_allclose(a.rotation, b.rotation, rtol=1e-4, atol=1e-6)


def test_sleap_tools_dataset_commands_match_jax(tmp_path, model):
    pkl, _ = model
    spec = jax_load_model_spec(pkl, align_symmetry=False)
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    jsyn.generate_synthetic_multiview(spec, a, n_samples=3, n_views=2, resolution=32)
    jsyn.generate_synthetic_multiview(spec, b, n_samples=2, n_views=3, resolution=32, seed=1)
    for name, cli, pre in (("jax", jtools_cli, []), ("torch", ttools_cli, [])):
        d = tmp_path / name
        d.mkdir()
        cli.main(pre + ["merge", a, b, "--output", str(d / "m.h5"), "--scale-factors", "1,0.5"])
        cli.main(pre + ["filter", a, "--output", str(d / "f.h5"), "--min-visible-keypoints", "3",
                        "--min-views", "2"])
        cli.main(pre + ["match-scale", a, "--output", str(d / "s.h5"), "--reference-dataset", b])
    for f in ("m.h5", "f.h5", "s.h5"):
        assert_same_h5(str(tmp_path / "torch" / f), str(tmp_path / "jax" / f))


def test_dataset_viewer_matches_jax(tmp_path, model):
    pkl, _ = model
    spec = jax_load_model_spec(pkl, align_symmetry=False)
    mv = str(tmp_path / "mv.h5")
    jsyn.generate_synthetic_multiview(spec, mv, n_samples=2, n_views=2, resolution=48)
    sv = str(tmp_path / "sv.h5")
    rng = np.random.default_rng(0)
    jh5.write_singleview_hdf5(sv, [{
        "image": (rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8),
        "keypoints_2d": rng.uniform(size=(6, 2)).astype(np.float32),
        "keypoint_visibility": np.ones(6, np.float32)} for _ in range(2)], 32, 15, 3)
    for data, extra in ((mv, ["--model", pkl, "--render-smal"]), (sv, [])):
        for name, cli, dev in (("jax", jviewer, []), ("torch", tviewer, CPU)):
            cli.main(["--dataset", data, "--output", str(tmp_path / name / os.path.basename(data)),
                      "--samples", "2"] + extra + dev)
        t, j = (tmp_path / n / os.path.basename(data) for n in ("torch", "jax"))
        assert sorted(os.listdir(t)) == sorted(os.listdir(j))
        assert (t / "index.html").read_text() == (j / "index.html").read_text()
        for f in sorted(os.listdir(j)):
            if not f.endswith(".png"):
                continue
            got, want = read_png(str(t / f)).astype(int), read_png(str(j / f)).astype(int)
            assert got.shape == want.shape, f
            if f.endswith("_smal.png"):
                assert (np.abs(got - want).max(-1) <= 1).mean() >= 0.99, f
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)


def test_data_clis_default_to_cuda(model, monkeypatch, tmp_path):
    """The viewer renders on the card and raises without one; the five
    preprocessing tools compute on the host, take no device, and with the
    card hidden reach their own check of the (empty) input."""
    pkl, _ = model
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tviewer.main(["--dataset", "d.h5"])
    calls = [
        (trep_cli, ["--input", ".", "--output", "o.h5", "--model", pkl], "no frames loaded"),
        (trepmv_cli, ["--input", ".", "--output", "o.h5", "--model", pkl], "no camera subdir"),
        (tsleap_cli, [".", "o.h5", "--model", pkl], "no SLEAP sessions"),
        (tsleapmv_cli, ["--sessions", ".", "--output", "o.h5"], "no calibration.toml"),
    ]
    for cli, argv, message in calls:
        with pytest.raises(SystemExit, match=message):
            cli.main(argv)
    with pytest.raises(FileNotFoundError):
        ttools_cli.main(["filter", "in.h5", "--output", "o.h5"])
