"""The port's host tools held to the JAX package on the CPU: mesh prep and
``prepare_meshes``, ``read_fitter_stages``, ``show_latest_checkpoint``, the
native PCA loader and ``plot_pca_data``, and ``monitoring``.

Inputs are made by the test from a numpy seed. Tolerances: everything
exactly — the mesh statistics, components, holes and decimation, the STL
round trip (binary and ASCII), the files and CSV ``prepare_meshes`` writes,
the lines ``read_fitter_stages`` and ``show_latest_checkpoint`` print and the
OBJ files they write, ``PCAMorphData`` from the port's build
(``build/native/``) against the JAX binding's on one CSV (and
``apply_weights`` against the numpy product of the directions and the
weights within 1e-6, float32), ``recommend_batch_size`` given ``hbm_gb``.
Without a card ``device_memory_stats`` is ``{}`` and ``recommend_batch_size``
without ``hbm_gb`` raises.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import filecmp
import os
import pathlib
import struct

import numpy as np
import pytest
import torch

from smilify_tpu.utils import mesh_prep as jmesh
from smilify_tpu.utils import monitoring as jmon

from smilify_tpu_torch.utils import mesh_prep as tmesh
from smilify_tpu_torch.utils import monitoring as tmon
from tests._torch_no_plotlibs import block_plot_libraries

APPLY_TOL = 1e-6


def _sphere(n=12, offset=(0.0, 0.0, 0.0), scale=1.0, seed=0, holes=0):
    """A noisy UV sphere of n² vertices; ``holes`` faces removed apart."""
    rng = np.random.RandomState(seed)
    u, w = np.meshgrid(np.linspace(0.2, np.pi - 0.2, n), np.linspace(0, 2 * np.pi, n,
                                                                      endpoint=False))
    v = np.stack([np.sin(u) * np.cos(w), np.sin(u) * np.sin(w), np.cos(u)], -1).reshape(-1, 3)
    v = v * scale * (1 + 0.02 * rng.randn(len(v), 1)) + offset
    f = []
    for i in range(n):
        for j in range(n - 1):
            a, b = i * n + j, i * n + j + 1
            c, d = ((i + 1) % n) * n + j, ((i + 1) % n) * n + j + 1
            f += [[a, b, c], [b, d, c]]
    f = np.asarray(f, np.int32)
    if holes:
        f = np.delete(f, np.arange(holes) * (len(f) // holes // 2) * 2 + 7, axis=0)
    return v, f


def _scene():
    """Two components (a big sphere with 2 holes, a small one), 288 + 40 faces."""
    v1, f1 = _sphere(12, holes=2)
    v2, f2 = _sphere(5, offset=(4.0, 0, 0), scale=0.5, seed=1)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)]).astype(np.int32)


def _write_binary_stl(path, verts, faces, header=b"\0" * 80):
    tris = verts[faces].astype(np.float32)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0) + t.tobytes() + struct.pack("<H", 0))


def _write_ascii_stl(path, verts, faces):
    with open(path, "w") as f:
        f.write("solid scan\n")
        for t in verts[faces]:
            f.write("facet normal 0 0 0\nouter loop\n")
            for p in t:
                f.write(f"vertex {p[0]:.9e} {p[1]:.9e} {p[2]:.9e}\n")
            f.write("endloop\nendfacet\n")
        f.write("endsolid scan\n")


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["binary", "binary_solid_header", "ascii"])
def test_stl_round_trip_matches_jax(tmp_path, kind):
    v, f = _scene()
    path = str(tmp_path / "m.stl")
    if kind == "ascii":
        _write_ascii_stl(path, v, f)
    else:
        _write_binary_stl(path, v, f, b"solid but binary".ljust(80, b"\0") if "solid" in kind
                          else b"\0" * 80)
    got = tmesh.load_stl(path)
    _equal(got, jmesh.load_stl(path))
    assert got[0].shape == (len(v), 3) and got[1].shape == f.shape


def test_mesh_prep_matches_jax(tmp_path):
    v, f = _scene()
    _equal(tmesh.connected_components(f, len(v)), jmesh.connected_components(f, len(v)))
    _equal(tmesh.largest_component(v, f), jmesh.largest_component(v, f))
    stats = tmesh.mesh_stats(v, f)
    assert stats == jmesh.mesh_stats(v, f)
    assert stats["n_components"] == 2 and stats["n_holes"] == 2 + 4   # 2 cut + 4 pole rings
    for target in (500, 100, 30):
        _equal(tmesh.decimate_vertex_clustering(v, f, target),
               jmesh.decimate_vertex_clustering(v, f, target))
    names = ["ant_w1", "ant_q2", "ant_m3", "bee"]
    lookup = {"_w": "worker", "_q": "queen"}
    assert tmesh.separate_by_caste(names, lookup) == jmesh.separate_by_caste(names, lookup)
    tmesh.save_obj(str(tmp_path / "t.obj"), v, f)
    jmesh.save_obj(str(tmp_path / "j.obj"), v, f)
    assert filecmp.cmp(tmp_path / "t.obj", tmp_path / "j.obj", shallow=False)
    _equal(tmesh.export_mesh_npy(str(tmp_path / "t"), v, f)[0][-13:], "_vertices.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "t_faces.npy"), f)


def test_prepare_meshes_matches_jax(tmp_path, capsys):
    from smilify_tpu.cli.prepare_meshes import main as j_prepare
    from smilify_tpu_torch.cli.prepare_meshes import main as t_prepare
    from smilify_tpu_torch.utils.export import save_obj

    src = tmp_path / "in"
    src.mkdir()
    v, f = _scene()
    _write_binary_stl(str(src / "ant_w1.stl"), v, f)
    _write_ascii_stl(str(src / "ant_q2.STL"), *_sphere(9, seed=3))
    save_obj(str(src / "bee.obj"), *_sphere(20, seed=4))
    lookup = tmp_path / "castes.csv"
    lookup.write_text("_w,worker\n_q,queen\n")
    for main, out in ((j_prepare, "j"), (t_prepare, "t")):
        main([str(src), str(tmp_path / out), "--max-vertices", "150",
              "--caste-lookup", str(lookup)])
    printed = capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT").replace(
        str(tmp_path / "t"), "OUT").splitlines()
    half = len(printed) // 2
    assert printed[:half] == printed[half:] and half == 4
    j_files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    t_files = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert t_files == j_files and len(t_files) == 4
    for rel in t_files:
        assert filecmp.cmp(tmp_path / "t" / rel, tmp_path / "j" / rel, shallow=False), rel
    # unlike the JAX CLI, a mesh that fails stops the run
    (src / "broken.obj").write_text("v 0 0 0\nf 1 2 x\n")
    with pytest.raises(RuntimeError, match="broken.obj"):
        t_prepare([str(src), str(tmp_path / "t2")])


def _stage_npz(path, n=3, V=20, labels=True):
    rng = np.random.RandomState(9)
    data = {"verts": rng.randn(n, V, 3).astype(np.float32),
            "faces": np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], 1),
            "betas": rng.randn(n, 4).astype(np.float32), "trans": rng.randn(n, 3),
            "global_rot": rng.randn(n, 3), "deform_verts": rng.randn(n, V, 3) * 0.01}
    if labels:
        data["labels"] = np.asarray([f"scan{i}" for i in range(n)])
    np.savez(path, **data)
    return str(path)


@pytest.mark.parametrize("labels", [True, False])
def test_read_fitter_stages_matches_jax(tmp_path, capsys, labels):
    from smilify_tpu.cli.read_fitter_stages import main as j_read
    from smilify_tpu_torch.cli.read_fitter_stages import main as t_read

    npz = _stage_npz(tmp_path / "Stage2.npz", labels=labels)
    j_read(["--npz", npz, "--export-obj", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    t_read(["--npz", npz, "--export-obj", str(tmp_path / "t")])
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), "OUT") == jout.replace(str(tmp_path / "j"), "OUT")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert len(os.listdir(tmp_path / "t")) == 3
    for name in os.listdir(tmp_path / "t"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False)


def test_show_latest_checkpoint_matches_jax(tmp_path, capsys):
    from smilify_tpu.cli import show_latest_checkpoint as jshow
    from smilify_tpu_torch.cli import show_latest_checkpoint as tshow

    root = tmp_path / "checkpoints"
    for r, run in enumerate(("old", "new")):
        for frame in ("f0", "f1"):
            d = root / run / frame
            d.mkdir(parents=True)
            for st, ep in ((0, 0), (3, 1), (10, 0), (2, 9)):
                (d / f"st{st}_ep{ep}.png").write_bytes(b"png")
        os.utime(root / run, (1e9 + r, 1e9 + r))
    (root / "new" / "notes.txt").write_text("")
    assert tshow.latest_run(str(root)) == jshow.latest_run(str(root)) == str(root / "new")
    assert tshow.latest_exports(str(root / "new")) == jshow.latest_exports(str(root / "new"))
    jshow.main(["--root", str(root), "--copy-to", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    tshow.main(["--root", str(root), "--copy-to", str(tmp_path / "t")])
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), "OUT") == jout.replace(str(tmp_path / "j"), "OUT")
    assert sorted(os.listdir(tmp_path / "t")) == ["f0_st10_ep0.png", "f1_st10_ep0.png"]
    with pytest.raises(SystemExit):
        tshow.main(["--root", str(tmp_path / "none")])


def _pca_csv(tmp_path):
    from smilify_tpu_torch.utils.smil_tools_native import export_pca_csv

    rng = np.random.RandomState(2)
    J, C = 7, 3
    scaledirs, transdirs = rng.randn(J, 3, C) * 0.1, rng.randn(J, 3, C) * 0.01
    return export_pca_csv(str(tmp_path / "pca.csv"), [f"b_{j}" for j in range(J)], scaledirs,
                          transdirs), scaledirs, transdirs


def test_native_pca_loader_matches_jax(tmp_path):
    from smilify_tpu.utils import smil_tools_native as jnative
    from smilify_tpu_torch.utils import smil_tools_native as tnative

    path, scaledirs, transdirs = _pca_csv(tmp_path)
    j = jnative.export_pca_csv(str(tmp_path / "j.csv"), [f"b_{i}" for i in range(7)],
                               scaledirs, transdirs)
    assert filecmp.cmp(path, j, shallow=False)
    assert tnative.build().parent.name == "native" and tnative.build().parent.parent.name == "build"
    t, jd = tnative.PCAMorphData(path), jnative.PCAMorphData(path)
    assert (t.num_bones, t.num_components, t.bone_names) == (jd.num_bones, jd.num_components,
                                                             jd.bone_names)
    _equal((t.scaledirs, t.transdirs), (jd.scaledirs, jd.transdirs))
    np.testing.assert_allclose(t.scaledirs, scaledirs, atol=1e-8)
    w = tnative.generate_weights(t.num_components, 1.5, seed=7)
    _equal(w, jnative.generate_weights(jd.num_components, 1.5, seed=7))
    scale, trans = t.apply_weights(w)
    _equal((scale, trans), jd.apply_weights(w))
    np.testing.assert_allclose(scale, 1.0 + t.scaledirs @ w, atol=APPLY_TOL)
    np.testing.assert_allclose(trans, t.transdirs @ w, atol=APPLY_TOL)
    (tmp_path / "bad.csv").write_text("joint_name,PC_1_scale_x\nb0,1\n")
    with pytest.raises(ValueError, match="smil_tools"):
        tnative.PCAMorphData(str(tmp_path / "bad.csv"))


def test_native_build_is_safe_to_start_at_once(tmp_path):
    """Three processes that build the library into one empty directory at
    once all load it: each compiles to a file of its own and renames it into
    place."""
    import subprocess
    import sys

    code = ("import sys; from pathlib import Path; "
            "from smilify_tpu_torch.utils import smil_tools_native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); "
            "d = n.PCAMorphData(sys.argv[2]); print(d.num_bones, n.build().name)")
    path, _, _ = _pca_csv(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1])}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "lib"), path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o for o, _ in outs}) == 1 and outs[0][0].startswith("7 libsmil_tools_")
    assert [p.name for p in (tmp_path / "lib").iterdir()] == [outs[0][0].split()[1]]


def test_plot_pca_data_matches_jax(tmp_path, capsys, monkeypatch):
    """The JAX CLI's files at their sizes, and each figure's axes limits as
    the JAX CLI's matplotlib axes have them when saved (within 1e-12
    relative); the port's drawn without matplotlib."""
    pytest.importorskip("matplotlib")                # the JAX side draws with it
    from matplotlib.figure import Figure as MplFigure

    from smilify_tpu.cli.plot_pca_data import main as j_plot
    from smilify_tpu_torch.cli.plot_pca_data import main as t_plot
    from smilify_tpu_torch.utils import plotting
    from smilify_tpu_torch.utils.image_io import read_png

    limits = {"j": [], "t": []}

    def recording(side, savefig):
        def save(fig, *args, **kwargs):
            limits[side].append([(ax.get_xlim(), ax.get_ylim()) for ax in fig.axes])
            return savefig(fig, *args, **kwargs)
        return save

    path, _, _ = _pca_csv(tmp_path)
    monkeypatch.setattr(MplFigure, "savefig", recording("j", MplFigure.savefig))
    j_plot(["--csv", path, "--out", str(tmp_path / "j"), "--components", "2"])
    block_plot_libraries(monkeypatch)
    monkeypatch.setattr(plotting.Figure, "savefig", recording("t", plotting.Figure.savefig))
    t_plot(["--csv", path, "--out", str(tmp_path / "t"), "--components", "2"])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "pc_1.png", "pc_2.png"]
    for name in os.listdir(tmp_path / "t"):
        assert read_png(tmp_path / "t" / name).shape == read_png(tmp_path / "j" / name).shape == (
            720, 960, 4)
    assert len(limits["t"]) == len(limits["j"]) == 2
    np.testing.assert_allclose(limits["t"], limits["j"], rtol=1e-12, atol=0)


def test_monitoring_on_the_cpu(tmp_path, monkeypatch):
    assert tmon.device_memory_stats() == {} == jmon.device_memory_stats()
    for backbone in ("resnet50", "vit_large_patch16_224", "unet_small", "unknown"):
        for hbm, res, views in ((80.0, 224, 1), (16.0, 448, 4)):
            kw = dict(hbm_gb=hbm, input_resolution=res, n_views=views)
            assert tmon.recommend_batch_size(backbone, **kw) == jmon.recommend_batch_size(
                backbone, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass hbm_gb"):
        tmon.recommend_batch_size("resnet50")

    pm = tmon.PerformanceMonitor()
    with pm.section("a"):
        pass
    pm.start("b")
    pm.end("b")
    pm.end("never started")
    assert dict(pm.counts) == {"a": 1, "b": 1}
    report = pm.report().splitlines()
    assert report[0].split() == ["section", "total", "s", "count", "mean", "ms"]
    assert report[-1].startswith("host RSS:") and len(report) == 4
    mm = tmon.MemoryMonitor()
    snap = mm.snapshot("x")
    assert sorted(snap) == ["host_mb", "t", "tag"] and snap["host_mb"] > 0
    assert mm.peak_host_mb() == snap["host_mb"]

    with tmon.profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "trace").iterdir())
    assert len(traces) == 1 and traces[0].stat().st_size > 0
