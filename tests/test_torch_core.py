"""Parity of the port's core (smilify_tpu_torch.core, render.cameras) with the
JAX package on the CPU.

Inputs are made with a seeded numpy generator and handed to both sides as
numpy arrays. Rodrigues and the forward kinematics are also held to the
reference fixtures (tests/fixtures/smal_forward_*.npz, no model pickle
needed) at the tolerances of tests/test_lbs_parity.py.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

from smilify_tpu.core import lbs as jlbs
from smilify_tpu.core import rotations as jrot
from smilify_tpu.core import spec as jspec
from smilify_tpu.render import cameras as jcam
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from smilify_tpu_torch.core import lbs as tlbs
from smilify_tpu_torch.core import rotations as trot
from smilify_tpu_torch.core import spec as tspec
from smilify_tpu_torch.render import cameras as tcam

FIX_ATOL = 2e-4   # tests/test_lbs_parity.py: f32 against the reference's f32
FIX_RTOL = 1e-4
JAX_ATOL = 1e-5   # f32 against f32 on the same CPU, other reduction orders


def _t(a):
    return torch.from_numpy(np.array(a))


def _fixture(name):
    path = FIXTURES / f"smal_forward_{name}.npz"
    if not path.exists():
        pytest.skip(f"fixture {path} missing (run tools/gen_reference_fixtures.py)")
    return np.load(path)


@pytest.fixture(scope="module")
def toy_pair():
    """The same toy spec (V_side=7, J=6, B=3) on both sides."""
    return jax_toy_spec(7, 6, 3), tspec.toy_model_spec(7, 6, 3, device="cpu")


@pytest.mark.parametrize("name", ["stick", "mouse"])
def test_rodrigues_matches_fixture(name):
    fx = _fixture(name)
    theta = fx["theta"].reshape(-1, 3)
    Rs = tlbs.batch_rodrigues(_t(theta)).numpy().reshape(fx["rodrigues_Rs"].shape)
    np.testing.assert_allclose(Rs, fx["rodrigues_Rs"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["stick", "mouse"])
def test_fk_matches_fixture(name):
    fx = _fixture(name)
    parents = tuple(int(p) for p in fx["parents"])
    newJ, A = tlbs.global_rigid_transformation(
        _t(fx["rodrigues_Rs"]), _t(fx["fk_Js"]), parents, log_scales=_t(fx["log_scales"]))
    np.testing.assert_allclose(newJ.numpy(), fx["fk_newJ"], atol=FIX_ATOL, rtol=FIX_RTOL)
    np.testing.assert_allclose(A.numpy(), fx["fk_A"], atol=FIX_ATOL, rtol=FIX_RTOL)


@pytest.mark.parametrize("propagate", [False, True])
def test_fk_matches_jax_both_scale_modes(propagate):
    rng = np.random.RandomState(1)
    N, J = 3, 9
    parents = np.asarray([0, 0, 1, 2, 1, 4, 0, 6, 7], np.int32)
    Rs = np.asarray(jrot.rodrigues(jnp.asarray(rng.uniform(-0.5, 0.5, (N, J, 3)), jnp.float32)))
    Js = rng.uniform(-0.5, 0.5, (N, J, 3)).astype(np.float32)
    ls = rng.uniform(-0.2, 0.2, (N, J, 3)).astype(np.float32)
    offs = rng.uniform(-0.05, 0.05, (N, J, 3)).astype(np.float32)
    jJ, jA = jax.vmap(lambda r, j, s, o: jlbs.global_rigid_transformation(
        r, j, jnp.asarray(parents), s, o, propagate))(
            jnp.asarray(Rs), jnp.asarray(Js), jnp.asarray(ls), jnp.asarray(offs))
    tJ, tA = tlbs.global_rigid_transformation(
        _t(Rs), _t(Js), tuple(parents), _t(ls), _t(offs), propagate)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=JAX_ATOL)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=JAX_ATOL)


def test_jump_schedule_rejects_cyclic_kintree():
    with pytest.raises(ValueError, match="cyclic"):
        tlbs._jump_schedule((0, 2, 1))


def test_toy_spec_arrays_match_jax(toy_pair):
    js, ts = toy_pair
    for name in tspec.ARRAY_FIELDS:
        a, b = getattr(js, name), getattr(ts, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(a), err_msg=name)
    assert ts.parents == tuple(int(p) for p in np.asarray(js.parents))
    for name in ("n_verts", "n_faces", "n_joints", "n_betas", "torso_joints", "joint_names"):
        assert getattr(ts, name) == getattr(js, name), name


def test_spec_from_numpy_carries_a_jax_spec(toy_pair):
    js, _ = toy_pair
    arrays = {f: (None if getattr(js, f) is None else np.asarray(getattr(js, f)))
              for f in tspec.ARRAY_FIELDS + ("parents",)}
    ts = tspec.spec_from_numpy(arrays, device="cpu", joint_names=js.joint_names,
                               torso_joints=js.torso_joints, has_shape_prior=True)
    assert (ts.n_verts, ts.n_faces, ts.n_joints, ts.n_betas) == (
        js.n_verts, js.n_faces, js.n_joints, js.n_betas)
    assert ts.faces.dtype == torch.int64 and ts.v_template.dtype == torch.float32
    np.testing.assert_array_equal(ts.faces.numpy(), np.asarray(js.faces))


def test_morton_order_identical():
    rng = np.random.RandomState(2)
    c = rng.uniform(-1, 1, (500, 3)) * np.asarray([2.0, 0.5, 1.0])
    np.testing.assert_array_equal(tspec._morton_order(c), jspec._morton_order(c))


@pytest.mark.parametrize("static", [False, True])
def test_smil_forward_matches_jax(toy_pair, static):
    """Scales and per-joint translations on; ``static`` checks the quirk that
    the static-joint path returns FK joints without ``trans``."""
    js, ts = toy_pair
    js = js.replace(static_joint_locations=static)
    ts = dataclasses.replace(ts, static_joint_locations=static)
    rng = np.random.RandomState(3)
    N, J, B = 2, js.n_joints, js.n_betas
    beta = rng.uniform(-1, 1, (N, B)).astype(np.float32)
    theta = rng.uniform(-0.4, 0.4, (N, J, 3)).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    ls = rng.uniform(-0.2, 0.2, (N, J, 3)).astype(np.float32)
    jt = rng.uniform(-0.05, 0.05, (N, J, 3)).astype(np.float32)
    jo = jlbs.smil_forward(js, jnp.asarray(beta), jnp.asarray(theta), jnp.asarray(trans),
                           log_scales=jnp.asarray(ls), joint_trans=jnp.asarray(jt))
    to = tlbs.smil_forward(ts, _t(beta), _t(theta), _t(trans), log_scales=_t(ls),
                           joint_trans=_t(jt))
    for field in ("verts", "joints", "Rs", "v_shaped", "j_transformed"):
        np.testing.assert_allclose(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                                   atol=JAX_ATOL, err_msg=field)
    if static:
        np.testing.assert_allclose(to.joints.numpy(), to.j_transformed.numpy())


def test_smil_forward_zero_betas_matches_jax(toy_pair):
    js, ts = toy_pair
    theta = np.random.RandomState(4).uniform(-0.4, 0.4, (1, js.n_joints, 3)).astype(np.float32)
    jo = jlbs.smil_forward(js, jnp.zeros((1, 0)), jnp.asarray(theta))
    to = tlbs.smil_forward(ts, torch.zeros((1, 0)), _t(theta))
    np.testing.assert_allclose(to.verts.numpy(), np.asarray(jo.verts), atol=JAX_ATOL)


def test_euler_init_rotation_matches_jax():
    e = np.array([-np.pi / 2, 0.0, -np.pi / 2])
    np.testing.assert_allclose(trot.euler_zyx_to_axis_angle(e), jrot.euler_zyx_to_axis_angle(e),
                               atol=1e-6)


def test_camera_projection_matches_jax():
    rng = np.random.RandomState(5)
    pts = rng.uniform(-0.5, 0.5, (3, 40, 3)).astype(np.float32)
    fov = rng.uniform(40.0, 80.0, (3,)).astype(np.float32)
    size = (96, 128)
    jyx = jax.vmap(lambda f, p: jcam.default_camera().replace(fov=f).project_points_yx(p, size))(
        jnp.asarray(fov), jnp.asarray(pts))
    jndc = jax.vmap(lambda f, p: jcam.default_camera().replace(fov=f).transform_points_ndc(p))(
        jnp.asarray(fov), jnp.asarray(pts))
    cam = tcam.default_camera(device="cpu").replace(fov=_t(fov)[:, None])
    np.testing.assert_allclose(cam.project_points_yx(_t(pts), size).numpy(), np.asarray(jyx),
                               atol=1e-4)
    np.testing.assert_allclose(cam.transform_points_ndc(_t(pts)).numpy(), np.asarray(jndc),
                               atol=1e-5, rtol=1e-5)
    assert tcam.DEFAULT_R == jcam.DEFAULT_R and tcam.DEFAULT_T == jcam.DEFAULT_T
