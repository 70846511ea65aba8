"""The port's polygon masks (``data/loaders.py::polygon_mask``) against
matplotlib's ``Path.contains_points``, bit for bit, and the port's
``load_smil_sequence(alt_seg=False)`` against the JAX package's, which draws
its masks with matplotlib. The port's side runs with matplotlib blocked in
``sys.modules``, as on the card.

Cases: integer, half-integer and random float vertices; edges and vertices
through pixel centres (with integer vertices such pixels are everywhere);
self-intersecting, closed and unclosed polygons; several polygons in one
annotation; fewer than three vertices; polygons off the image.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import numpy as np
import pytest

from smilify_tpu_torch.data.loaders import polygon_mask
from smilify_tpu_torch.tools.plot_fixtures import polygon_cases, write_polygon_coco
from tests._torch_no_plotlibs import block_plot_libraries, mpl_mask


@pytest.mark.parametrize("name", sorted(polygon_cases()))
def test_fixture_cases_equal_matplotlib(name):
    case = polygon_cases()[name]
    want = mpl_mask(case["polygons"], case["height"], case["width"])
    got = polygon_mask(case["polygons"], case["height"], case["width"])
    np.testing.assert_array_equal(got, want)
    # a collinear triangle still holds the pixel centres on its line, as in matplotlib
    assert got.dtype == bool and (name == "outside") == (not got.any())


@pytest.mark.parametrize("kind", ["integer", "half_integer", "float", "on_centres", "closed"])
def test_random_polygons_equal_matplotlib(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    h, w = 37, 53
    for _ in range(60):
        n = rng.randint(3, 14)
        if kind == "integer":
            v = rng.randint(-6, 60, (n, 2)).astype(np.float64)
        elif kind == "half_integer":
            v = rng.randint(-12, 120, (n, 2)) / 2.0
        elif kind == "float":
            v = rng.uniform(-4.0, 58.0, (n, 2))
        elif kind == "on_centres":                 # a coarse lattice: many edges on centres
            v = rng.randint(0, 7, (n, 2)) * 8.0
        else:
            v = rng.uniform(-4.0, 58.0, (n, 2))
            v = np.concatenate([v, v[:1]])
        np.testing.assert_array_equal(polygon_mask([v.ravel().tolist()], h, w),
                                      mpl_mask([v.ravel()], h, w))


def test_polygon_mask_refuses_non_finite_vertices():
    with pytest.raises(ValueError, match="non-finite"):
        polygon_mask([[0, 0, 10, np.nan, 5, 5]], 8, 8)


def test_load_smil_sequence_polygons_match_jax(tmp_path, monkeypatch):
    from smilify_tpu.data import loaders as jload
    from smilify_tpu_torch.data import loaders as tload

    coco, frames = write_polygon_coco(str(tmp_path))
    cases = polygon_cases()
    want = {f: jload.load_smil_sequence(coco, f, 32, ["a", "b"], alt_seg=False) for f in frames}
    masks = {f: mpl_mask(cases[c]["polygons"], cases[c]["height"], cases[c]["width"])
             for f, c in frames.items()}
    block_plot_libraries(monkeypatch)
    for frame in frames:
        (got, got_names) = tload.load_smil_sequence(coco, frame, 32, ["a", "b"], alt_seg=False)
        (ref, ref_names) = want[frame]
        assert got_names == ref_names
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got[1][0] > 0, masks[frame])
