"""Parity of the rest of the port's camera module (projection matrices,
``camera_from_opencv``, ``triangulate_dlt``) with the JAX package on the CPU.

The same numpy inputs from a seed go through both packages (JAX geometry at
``Precision.HIGHEST``, the port in float32 with full-precision matmuls).
Tolerances: the matrices and the converted camera's fields within 1e-6;
triangulated points and their gradients with respect to the 2D points and
the projection matrices within 1e-5 relative (a 3×3 solve in float32; the
absolute floor is 1e-5 of the array's largest entry, for entries near 0),
with a 1-D view mask and with a (V, K) one.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.render import cameras as jcam

from smilify_tpu_torch.data.synthetic import ring_cameras_opencv
from smilify_tpu_torch.render import cameras as tcam

MAT_TOL = 1e-6
TRI_RTOL, TRI_ATOL = 1e-5, 1e-5
SIZES = ((96, 96), (480, 640))


def _opencv_camera(rng, size):
    """A random OpenCV camera (R, t, K) looking roughly at the origin."""
    H, W = size
    R, t, _ = ring_cameras_opencv(5, radius=2.0 + rng.uniform(), height=rng.uniform(-1, 1))[
        int(rng.integers(5))]
    fx, fy = rng.uniform(200, 900, 2)
    K = np.array([[fx, 0, W / 2 + rng.uniform(-5, 5)], [0, fy, H / 2 + rng.uniform(-5, 5)],
                  [0, 0, 1.0]])
    return R.astype(np.float32), t.astype(np.float32), K.astype(np.float32)


@pytest.mark.parametrize("size", SIZES)
def test_camera_from_opencv_and_matrices(size):
    rng = np.random.default_rng(sum(size))
    for _ in range(4):
        R, t, K = _opencv_camera(rng, size)
        j = jcam.camera_from_opencv(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), size)
        c = tcam.camera_from_opencv(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(K),
                                    size)
        for field in ("R", "T", "fov", "aspect_ratio"):
            np.testing.assert_allclose(getattr(c, field).numpy(), np.asarray(getattr(j, field)),
                                       atol=MAT_TOL, rtol=MAT_TOL, err_msg=field)
        assert (c.znear, c.zfar) == (j.znear, j.zfar)
        for fn in ("projection_matrix", "full_projection_matrix", "camera_center"):
            np.testing.assert_allclose(getattr(c, fn)().numpy(), np.asarray(getattr(j, fn)()),
                                       atol=MAT_TOL, rtol=MAT_TOL, err_msg=fn)


def test_default_camera_matrices():
    j, c = jcam.default_camera(fov=45.0), tcam.default_camera(fov=45.0, device="cpu")
    for fn in ("projection_matrix", "full_projection_matrix", "camera_center"):
        np.testing.assert_allclose(getattr(c, fn)().numpy(), np.asarray(getattr(j, fn)()),
                                   atol=MAT_TOL, rtol=MAT_TOL, err_msg=fn)


def _dlt_inputs(seed, n_views=4, n_joints=7, mask_2d=False):
    """NDC observations of random points through a camera ring (with noise),
    the views' world→clip matrices and a view mask (a few views dropped)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.4, 0.4, (n_joints, 3)).astype(np.float32)
    P, ndc = [], []
    for R, t, K in ring_cameras_opencv(n_views, resolution=96):
        cam = jcam.camera_from_opencv(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32),
                                      jnp.asarray(K, jnp.float32), (96, 96))
        P.append(np.asarray(cam.full_projection_matrix()))
        ndc.append(np.asarray(cam.transform_points_ndc(jnp.asarray(X)))[:, :2])
    ndc = np.stack(ndc) + rng.normal(0, 1e-3, (n_views, n_joints, 2)).astype(np.float32)
    if mask_2d:
        mask = rng.uniform(size=(n_views, n_joints)) > 0.25
        mask[:2] = True                      # every joint keeps two views
    else:
        mask = np.array([True, False, True, True][:n_views])
    return ndc.astype(np.float32), np.stack(P).astype(np.float32), mask


def _jax_dlt(ndc, P, mask, cot):
    def f(n, p):
        return jnp.sum(jcam.triangulate_dlt(n, p, jnp.asarray(mask)) * cot)

    X = jcam.triangulate_dlt(jnp.asarray(ndc), jnp.asarray(P), jnp.asarray(mask))
    gn, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(ndc), jnp.asarray(P))
    return np.asarray(X), np.asarray(gn), np.asarray(gp)


def _torch_dlt(ndc, P, mask, cot):
    n = torch.from_numpy(ndc).requires_grad_(True)
    p = torch.from_numpy(P).requires_grad_(True)
    X = tcam.triangulate_dlt(n, p, torch.from_numpy(mask))
    (X * torch.from_numpy(cot)).sum().backward()
    return X.detach().numpy(), n.grad.numpy(), p.grad.numpy()


@pytest.mark.parametrize("mask_2d", [False, True], ids=["mask_views", "mask_views_joints"])
def test_triangulate_dlt_and_gradients(mask_2d):
    ndc, P, mask = _dlt_inputs(11 + mask_2d, mask_2d=mask_2d)
    cot = np.random.default_rng(5).normal(size=(ndc.shape[1], 3)).astype(np.float32)
    got, want = _torch_dlt(ndc, P, mask, cot), _jax_dlt(ndc, P, mask, cot)
    for name, g, w in zip(("points", "d/d points_2d", "d/d proj_matrices"), got, want):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=TRI_RTOL, atol=TRI_ATOL * np.abs(w).max(),
                                   err_msg=name)


def test_triangulate_dlt_recovers_points():
    """Noise-free observations of every view: the DLT returns the points."""
    rng = np.random.default_rng(2)
    X = rng.uniform(-0.4, 0.4, (5, 3)).astype(np.float32)
    P, ndc = [], []
    for R, t, K in ring_cameras_opencv(3, resolution=96):
        cam = tcam.camera_from_opencv(*(torch.tensor(a, dtype=torch.float32) for a in (R, t, K)),
                                      (96, 96))
        P.append(cam.full_projection_matrix())
        ndc.append(cam.transform_points_ndc(torch.from_numpy(X))[:, :2])
    out = tcam.triangulate_dlt(torch.stack(ndc), torch.stack(P), torch.ones(3, dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), X, atol=1e-3)


@pytest.mark.parametrize("mask_2d", [False, True], ids=["mask_views", "mask_views_joints"])
def test_triangulate_dlt_batched_equals_jax_vmap(mask_2d):
    """A leading batch axis in one call, against ``jax.vmap`` of the JAX
    function over the same three samples (values and gradients, the
    tolerances above)."""
    samples = [_dlt_inputs(21 + 3 * i + mask_2d, mask_2d=mask_2d) for i in range(3)]
    ndc, P, mask = (np.stack(a) for a in zip(*samples))
    cot = np.random.default_rng(6).normal(size=(3, ndc.shape[2], 3)).astype(np.float32)

    def f(n, p):
        return jnp.sum(jax.vmap(jcam.triangulate_dlt)(n, p, jnp.asarray(mask)) * cot)

    want = (np.asarray(jax.vmap(jcam.triangulate_dlt)(jnp.asarray(ndc), jnp.asarray(P),
                                                      jnp.asarray(mask))),
            *map(np.asarray, jax.grad(f, argnums=(0, 1))(jnp.asarray(ndc), jnp.asarray(P))))
    got = _torch_dlt(ndc, P, mask, cot)
    for name, g, w in zip(("points", "d/d points_2d", "d/d proj_matrices"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TRI_RTOL, atol=TRI_ATOL * np.abs(w).max(),
                                   err_msg=name)
