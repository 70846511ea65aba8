"""Model authoring in the port, held to the JAX package on the CPU.

The same inputs, made from a numpy seed, go through both packages'
``utils/authoring.py`` and ``utils/beta_calculator.py``; the specs are the
toy (8, 6, 3) spec on both sides (the port's carried across with
``spec_from_numpy``).

Tolerances: the PCA shape spaces, the entangled PCA, ``j_regressor_from_weights``,
``pose_corrective_offsets``, ``make_symmetrical``, area and volume within
1e-10 (float64 numpy on both sides); ``build_model_from_registration``'s
pickle arrays equal, and the pickle loads in both packages to the same spec;
the measurement CSVs with the same rows and headers and values within 1e-5
(2B+1 float32 forwards in JAX, one batched float32 forward in the port);
``betas_from_measurements`` within 1e-8 and its report equal.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import csv

import numpy as np
import pytest
import torch

from smilify_tpu.core.spec import load_model_spec as jax_load_model_spec
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec
from smilify_tpu.utils import authoring as jauth
from smilify_tpu.utils import beta_calculator as jbeta

from smilify_tpu_torch.core import spec as tspec
from smilify_tpu_torch.utils import authoring as tauth
from smilify_tpu_torch.utils import beta_calculator as tbeta

EXACT = 1e-10
CSV_TOL = 1e-5
BETA_TOL = 1e-8


def carry(js):
    """The JAX spec ``js`` as the port's spec on the CPU."""
    arrays = {f: (None if getattr(js, f) is None else np.asarray(getattr(js, f)))
              for f in tspec.ARRAY_FIELDS + ("parents",)}
    meta = {k: getattr(js, k) for k in (
        "joint_names", "n_verts", "n_faces", "n_joints", "n_betas", "static_joint_locations",
        "has_shape_prior", "legacy_dog_keypoints", "root_joint", "torso_joints", "ignore_joints",
        "left_inds", "right_inds", "center_inds", "source_path")}
    return tspec.spec_from_numpy(arrays, device="cpu", **meta)


@pytest.fixture(scope="module")
def specs():
    js = jax_toy_spec(8, 6, 3)
    return js, carry(js)


def _close(a, b, tol=EXACT, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=what)


def _spaces_equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        _close(t[k], j[k], what=k)


@pytest.mark.parametrize("n_components", [1, 3, 8])
def test_pca_shape_space_matches_jax(n_components):
    rng = np.random.RandomState(n_components)
    meshes = rng.randn(12, 40, 3)
    _spaces_equal(tauth.compute_pca_shape_space(meshes, n_components),
                  jauth.compute_pca_shape_space(meshes, n_components))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (10.0, 0.5)])
def test_entangled_pca_matches_jax(weights):
    rng = np.random.RandomState(1)
    verts, scales, trans = rng.randn(16, 30, 3), rng.randn(16, 8, 3) * 0.1, rng.randn(16, 8, 3) * 0.05
    args = (verts, scales, trans, 4) + weights
    _spaces_equal(tauth.compute_entangled_pca(*args), jauth.compute_entangled_pca(*args))


@pytest.mark.parametrize("top_k,power", [(None, 2.0), (8, 2.0), (3, 1.0)])
def test_j_regressor_from_weights_matches_jax(top_k, power):
    w = np.random.RandomState(2).rand(40, 5)
    _close(tauth.j_regressor_from_weights(w, top_k, power),
           jauth.j_regressor_from_weights(w, top_k, power))


def test_pose_correctives_symmetry_and_measures_match_jax():
    rng = np.random.RandomState(3)
    V, J = 20, 5
    posedirs = rng.randn(V, 3, 9 * (J - 1))
    aa = rng.randn(J - 1, 3) * 0.3
    want = jauth.pose_corrective_offsets(posedirs, aa)
    _close(tauth.pose_corrective_offsets(posedirs, aa), want)
    # the spec's (P, 3V) layout, as a tensor
    spec_layout = torch.from_numpy(posedirs.reshape(3 * V, -1).T.copy())
    _close(tauth.pose_corrective_offsets(spec_layout, aa),
           jauth.pose_corrective_offsets(spec_layout.numpy(), aa))

    right = rng.rand(20, 3) + [0, 0.2, 0]
    left = right * [1, -1, 1] + rng.randn(20, 3) * 0.004
    verts = np.concatenate([right, left, rng.rand(4, 3) * [1, 0.001, 1]])
    for axis in ("y", "x"):
        _close(tauth.make_symmetrical(verts, axis), jauth.make_symmetrical(verts, axis), what=axis)

    faces = np.asarray(jax_toy_spec(8, 6, 3).faces)
    v = np.asarray(jax_toy_spec(8, 6, 3).v_template, np.float64) + rng.randn(64, 3) * 0.01
    assert abs(tauth.mesh_surface_area(v, faces) - jauth.mesh_surface_area(v, faces)) <= EXACT
    assert abs(tauth.mesh_volume(v, faces) - jauth.mesh_volume(v, faces)) <= EXACT
    names = [f"j{i}" for i in range(J)]
    joints = rng.randn(J, 3)
    assert tauth.joint_distances(joints, names) == jauth.joint_distances(joints, names)


def _registration_npz(path, spec, n=8, seed=4):
    """What the registration writes: fitted vertices and the joints' log
    scales and translations, from a seed."""
    rng = np.random.RandomState(seed)
    v = np.asarray(spec.v_template, np.float64)
    np.savez(path, verts=(v[None] + rng.randn(n, *v.shape) * 0.02).astype(np.float32),
             log_beta_scales=(rng.randn(n, spec.n_joints, 3) * 0.1).astype(np.float32),
             betas_trans=(rng.randn(n, spec.n_joints, 3) * 0.01).astype(np.float32),
             faces=np.asarray(spec.faces))
    return str(path)


@pytest.mark.parametrize("entangled", [True, False])
def test_build_model_from_registration_matches_jax(tmp_path, specs, entangled):
    from smilify_tpu_torch.core.io import load_raw_model

    js, ts = specs
    npz = _registration_npz(tmp_path / "default.npz", js)
    jpath = jauth.build_model_from_registration(npz, js, 3, entangled, str(tmp_path / "j.pkl"))
    tpath = tauth.build_model_from_registration(npz, ts, 3, entangled, str(tmp_path / "t.pkl"))
    jd, td = load_raw_model(jpath), load_raw_model(tpath)
    assert sorted(td) == sorted(jd)
    assert ("scaledirs" in td) == entangled
    for k in jd:
        if isinstance(jd[k], np.ndarray):
            assert td[k].dtype == jd[k].dtype, k
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        else:
            assert td[k] == jd[k], k
    # the pickle loads in both packages, to the same arrays
    jl = jax_load_model_spec(tpath, align_symmetry=False)
    tl = tspec.load_model_spec(tpath, align_symmetry=False, device="cpu")
    assert tl.n_betas == jl.n_betas == 3 and tl.joint_names == jl.joint_names
    for name in tspec.ARRAY_FIELDS:
        a = getattr(jl, name)
        if a is None:
            assert getattr(tl, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(a), err_msg=name)
    assert tl.parents == tuple(int(p) for p in np.asarray(jl.parents))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("export", ["export_joint_distances_csv", "export_mesh_measurements_csv"])
def test_measurement_csvs_match_jax(tmp_path, specs, export):
    js, ts = specs
    jrows = _rows(getattr(jauth, export)(js, str(tmp_path / "j.csv"), beta_range=1.5))
    trows = _rows(getattr(tauth, export)(ts, str(tmp_path / "t.csv"), beta_range=1.5))
    assert len(trows) == len(jrows) > 2 and trows[0] == jrows[0]
    n_text = 2 if export == "export_joint_distances_csv" else 1
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:n_text] == j[:n_text]
        _close([float(x) for x in t[n_text:]], [float(x) for x in j[n_text:]], CSV_TOL, t[0])


def test_betas_from_measurements_matches_jax(specs):
    js, ts = specs
    rng = np.random.RandomState(0)
    v0 = np.asarray(js.v_template, np.float64)
    dirs = np.asarray(js.shapedirs, np.float64).T.reshape(v0.shape[0], 3, js.n_betas)
    gt = rng.randn(js.n_betas) * 0.5
    measurements = {f"m{i}": (int(a), int(b)) for i, (a, b) in
                    enumerate(rng.randint(0, js.n_verts, (12, 2)))}
    targets = jbeta.measure(v0 + dirs @ gt, measurements)
    assert tbeta.measure(v0 + dirs @ gt, measurements) == targets
    want = jbeta.betas_from_measurements(js, targets, measurements, n_iters=5)
    got = tbeta.betas_from_measurements(ts, targets, measurements, n_iters=5)
    _close(got, want, BETA_TOL)
    assert tbeta.report(ts, got, targets, measurements) == jbeta.report(js, want, targets,
                                                                         measurements)
    # and the known betas are recovered
    achieved = tbeta.measure(v0 + dirs @ got, measurements)
    assert max(abs(achieved[k] - targets[k]) for k in targets) < 0.01
