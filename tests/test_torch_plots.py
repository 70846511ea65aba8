"""The port's plotter (``smilify_tpu_torch/utils/plotting.py``) and its
fixtures (``tools/plot_fixtures.py``, ``tests/fixtures/plots/``) against
matplotlib 3.10 and PyYAML 6, which the test CPU has and the port does not
import (the card's machine has no matplotlib). The port's side runs with
matplotlib, mpl_toolkits and yaml blocked in ``sys.modules``; matplotlib
runs only as the reference.

* Every plot site writes the JAX function's file names at its pixel sizes.
* 2D limits equal ``get_xlim()``/``get_ylim()`` within 1e-12 relative on
  linear, log and histogram axes, shared axes and ``axhline`` included;
  3D limits and projected points equal ``proj3d.proj_transform(...,
  ax.get_proj())`` within 1e-9.
* Each line series' colour lies on its mapped polyline; each scatter
  series' colour at its markers.
* The viridis table equals ``matplotlib.colormaps["viridis"]`` exactly.
* The committed fixtures are what PyYAML and matplotlib answer, and the
  port meets them (what ``chip_smoke.py`` phase 17 checks on the card).

Regenerate the fixtures (after a change of the cases, or of matplotlib or
PyYAML) with
``JAX_PLATFORMS=cpu python -c "import tests.test_torch_plots as t; t.regenerate()"``.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import importlib
import os
import types

import matplotlib
import numpy as np
import pytest
import yaml

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402

from smilify_tpu_torch.tools import plot_fixtures as pf  # noqa: E402
from smilify_tpu_torch.utils import plotting  # noqa: E402
from smilify_tpu_torch.utils.image_io import read_png  # noqa: E402
from tests._torch_no_plotlibs import block_plot_libraries, mpl_mask  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "plots")


@pytest.fixture
def no_matplotlib(monkeypatch):
    """Importing matplotlib, mpl_toolkits or yaml fails, as on a host without
    them (the port imports none of them)."""
    block_plot_libraries(monkeypatch)


def reference_answers():
    """matplotlib's and PyYAML's answers to every case of plot_fixtures."""
    try:
        ref = pf.answers(plt, proj3d.proj_transform, yaml.safe_load, mpl_mask)
    finally:
        plt.close("all")
    ref["arrays"]["viridis"] = matplotlib.colormaps["viridis"](np.arange(256))[:, :3]
    return ref


def regenerate(directory=FIXTURES):
    pf.save(directory, reference_answers())


def _sizes(directory):
    return {n: read_png(os.path.join(directory, n)).shape for n in sorted(os.listdir(directory))}


# -- the fixtures ----------------------------------------------------------------


def test_fixtures_are_what_matplotlib_and_pyyaml_answer():
    ref, committed = reference_answers(), pf.load(FIXTURES)
    assert committed["yaml"] == ref["yaml"]
    assert sorted(committed["arrays"]) == sorted(ref["arrays"])
    for k, v in ref["arrays"].items():
        np.testing.assert_array_equal(committed["arrays"][k], v, err_msg=k)
    size = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert size < 64 * 1024


def test_port_meets_the_fixtures(no_matplotlib):
    assert pf.check(FIXTURES) == {s: [] for s in ("yaml", "mask", "limits", "limits3d", "proj",
                                                  "projected", "viridis")}


def test_fixture_check_sees_a_difference(no_matplotlib, tmp_path):
    want = pf.load(FIXTURES)
    want["arrays"]["limits/history"] = want["arrays"]["limits/history"] * (1 + 1e-11)
    want["arrays"]["mask/float"] = ~want["arrays"]["mask/float"]
    want["yaml"]["traps"] = want["yaml"]["flow"]
    pf.save(str(tmp_path), want)
    got = pf.check(str(tmp_path))
    assert (got["limits"], got["mask"], got["yaml"]) == (["limits/history"], ["mask/float"],
                                                         ["traps"])


def test_viridis_is_matplotlibs():
    np.testing.assert_array_equal(plotting.VIRIDIS,
                                  matplotlib.colormaps["viridis"](np.arange(256))[:, :3])
    x = np.concatenate([np.linspace(0, 1, 1001), [0.0, 1.0, 255 / 256, 1 / 256]])
    np.testing.assert_array_equal(plotting.colormap("viridis")(x), matplotlib.colormaps["viridis"](x))


# -- limits and projections, live against matplotlib -----------------------------


@pytest.mark.parametrize("name", sorted(pf.axes_cases()))
def test_2d_limits_equal_matplotlibs(name):
    case = pf.axes_cases()[name]
    _, want = pf.apply_case(plt, case)
    want = [(ax.get_xlim(), ax.get_ylim()) for ax in want]
    plt.close("all")
    _, got = pf.apply_case(plotting, case)
    got = [(ax.get_xlim(), ax.get_ylim()) for ax in got]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", sorted(pf.projection_cases()))
def test_3d_projection_equals_matplotlibs(name):
    case = pf.projection_cases()[name]
    _, (ax,) = pf.apply_case(plt, case, three_d=True)
    want_lim = [ax.get_xlim(), ax.get_ylim(), ax.get_zlim()]
    want = np.asarray(proj3d.proj_transform(*case["points"].T, ax.get_proj()))
    plt.close("all")
    _, (tax,) = pf.apply_case(plotting, case, three_d=True)
    np.testing.assert_allclose([tax.get_xlim(), tax.get_ylim(), tax.get_zlim()], want_lim,
                               rtol=1e-12, atol=0)
    got = np.asarray(plotting.proj_transform(*case["points"].T, tax.get_proj()))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


# -- colours on the picture ------------------------------------------------------


def _near_segment(p, a, b, tol):
    d = b - a
    t = np.clip(((p - a) @ d) / max(float(d @ d), 1e-12), 0, 1)
    return np.linalg.norm(p - (a + t * d)) <= tol


def _has_colour(img, p, rgb):
    x, y = int(round(p[0])), int(round(p[1]))
    win = img[max(0, y - 1):y + 2, max(0, x - 1):x + 2].reshape(-1, 3)
    return (win == np.asarray(plotting._rgb8(rgb))).all(axis=1).any()


@pytest.mark.parametrize("name", ["history", "components_log", "pck_curve", "semilogy_stages",
                                  "loss_components_rows", "pca_zero_inside"])
def test_series_colours_lie_on_their_mapped_data(name, no_matplotlib):
    fig, axes = pf.apply_case(plotting, pf.axes_cases()[name])
    img = fig.render(100)
    for ax in axes:
        lines = [a for a in ax._lines if a["kind"] == "line"]
        for k, line in enumerate(lines):
            pts = ax.to_pixels(line["x"], line["y"])
            segs = [(pts[i], pts[i + 1]) for i in range(len(pts) - 1)
                    if np.isfinite(pts[i:i + 2]).all()]
            later = [(q[i], q[i + 1]) for other in lines[k + 1:]
                     for q in [ax.to_pixels(other["x"], other["y"])] for i in range(len(q) - 1)]
            checked = 0
            for a, b in segs:
                for t in (0.25, 0.5, 0.75):
                    p = a + t * (b - a)
                    lx0, ly0, lx1, ly1 = ax.legend_box or (0, 0, -1, -1)
                    if (lx0 - 3 <= p[0] <= lx1 + 3 and ly0 - 3 <= p[1] <= ly1 + 3) or any(
                            _near_segment(p, c, d, 4) for c, d in later):
                        continue
                    assert _has_colour(img, p, line["color"]), (name, k, p)
                    checked += 1
            assert checked >= 3, (name, k)
        for k, sc in enumerate(ax._scatters):
            later = np.concatenate([ax.to_pixels(o["x"], o["y"]) for o in ax._scatters[k + 1:]]
                                   + [np.zeros((0, 2))])
            lx0, ly0, lx1, ly1 = ax.legend_box or (0, 0, -1, -1)
            free = [p for p in ax.to_pixels(sc["x"], sc["y"])
                    if not (np.abs(later - p).max(axis=1, initial=0) < 8).any()
                    and not (lx0 - 8 <= p[0] <= lx1 + 8 and ly0 - 8 <= p[1] <= ly1 + 8)]
            assert free and all(_has_colour(img, p, sc["color"]) for p in free), (name, k)
    assert img.shape[:2] == (480, 640)


# -- the plot sites: the JAX function's files, at its sizes -----------------------


def _history():
    return [{"epoch": i, "loss": 1.0 / (i + 1), "lr": 1e-3 * 0.9 ** i, "loss_kp": 0.5 / (i + 1),
             "loss_sil": 0.2, "ief_delta_0": 0.1 * i} for i in range(5)]


def _stages():
    rng = np.random.RandomState(1)
    return types.SimpleNamespace(stages=[
        types.SimpleNamespace(name=n, loss_history=[{"chamfer": float(rng.rand()),
                                                     "edge": float(rng.rand()) * 0.1}
                                                    for _ in range(8)]) for n in ("init", "default")])


def _mesh():
    from smilify_tpu_torch.core.spec import toy_model_spec

    spec = toy_model_spec(device="cpu")
    return spec.v_template.numpy().astype(np.float64), spec.faces.numpy()


def _site(site, out, package):
    """The plot site ``site`` of ``package`` ("smilify_tpu" or
    "smilify_tpu_torch") on fixed inputs, its files written into ``out``."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    rng = np.random.RandomState(2)
    if site == "trainer":
        mod("train.trainer").plot_training_history(_history(), out)
    elif site == "benchmark":
        acc = mod("train.benchmark").BenchmarkAccumulator()
        acc.add_2d(rng.rand(4, 6, 2), rng.rand(4, 6, 2), np.ones((4, 6)), 224)
        acc._plot(out)
    elif site == "train_viz":
        mod("train.train_viz").plot_3d_keypoints(rng.randn(10, 3), rng.randn(10, 3),
                                                 os.path.join(out, "kp3d.png"))
    elif site == "fitter3d":
        manager = mod("fitter.fitter3d").StageManager
        manager.plot_losses(_stages(), out)
        manager.plot_loss_components(_stages(), out)
    elif site == "visualization":
        vis = mod("utils.visualization")
        v, f = _mesh()
        vis.plot_mesh(v, f, os.path.join(out, "mesh.png"), title="mesh")
        vis.plot_pointclouds([v, v + 0.1], os.path.join(out, "clouds.png"), title="clouds")
        vis.plot_mesh_heatmap(v, f, np.arange(len(f)), os.path.join(out, "heat.png"))
    plt.close("all")


@pytest.mark.parametrize("site,sizes", [
    ("trainer", {"training_history.png": (480, 840, 4), "lr_schedule.png": (360, 840, 4),
                 "loss_components.png": (480, 960, 4), "ief_deltas.png": (480, 960, 4)}),
    ("benchmark", {"pck_curve.png": (480, 720, 4), "error_histogram.png": (480, 720, 4)}),
    ("train_viz", {"kp3d.png": (480, 480, 4)}),
    ("fitter3d", {"losses.png": (480, 640, 4), "loss_components.png": (600, 800, 4)}),
    ("visualization", {"mesh.png": (480, 480, 4), "clouds.png": (480, 480, 4),
                       "heat.png": (480, 480, 4)}),
])
def test_plot_sites_write_the_jax_files_at_their_sizes(site, sizes, tmp_path, monkeypatch):
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    _site(site, str(tmp_path / "jax"), "smilify_tpu")
    block_plot_libraries(monkeypatch)
    _site(site, str(tmp_path / "port"), "smilify_tpu_torch")
    assert _sizes(tmp_path / "port") == _sizes(tmp_path / "jax") == sizes
