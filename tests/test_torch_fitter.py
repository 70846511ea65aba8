"""Parity of the port's fitter (smilify_tpu_torch.fitter) with the JAX package
on the CPU.

Both sides fit the same toy spec against one target: the silhouette and
joints that the JAX package's ``synthetic_fit_data`` renders, handed to both
as numpy (thresholded once, by JAX). The JAX fitter renders with its
all-faces oracle on the CPU; the port with the plain versions of its exact
raster kernels, which drop only faces beyond the blur margin (alpha within
~1e-6), so the loss terms agree to rtol 1e-4.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.fitter import fitter as jfit
from smilify_tpu.fitter import priors as jpri
from smilify_tpu.fitter.stages import OPT_WEIGHTS as JAX_OPT_WEIGHTS
from smilify_tpu.fitter.stages import test_schedule as jax_test_schedule
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter as tfit
from smilify_tpu_torch.fitter import priors as tpri
from smilify_tpu_torch.fitter import stages as tstages
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS

SIZE = (64, 64)
N_FRAMES = 2
FIELDS = tfit.FitParams.fields()


@pytest.fixture(scope="module")
def setup():
    jspec = jax_toy_spec(10, 6, 3)
    tspec = toy_model_spec(10, 6, 3, device="cpu")
    jdata = jfit.synthetic_fit_data(jspec, N_FRAMES, SIZE, use_pallas=False)
    arrays = {k: np.asarray(getattr(jdata, k)) for k in ("sil", "joints", "visibility")}
    assert 0.01 < arrays["sil"].mean() < 0.5
    tdata = tfit.FitData(rgb=None, **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    return jspec, tspec, jdata, tdata


def _random_params(spec, seed=11):
    """Parameters near the init (as numpy), so every loss term is non-trivial."""
    rng = np.random.RandomState(seed)
    J, B = spec.n_joints, spec.n_betas
    g0 = jfit._default_global_rotation()
    return {
        "global_rot": (g0 + rng.uniform(-0.1, 0.1, (N_FRAMES, 3))).astype(np.float32),
        "joint_rot": rng.uniform(-0.05, 0.05, (N_FRAMES, J - 1, 3)).astype(np.float32),
        "betas": rng.uniform(-0.3, 0.3, (B,)).astype(np.float32),
        "trans": rng.uniform(-0.03, 0.03, (N_FRAMES, 3)).astype(np.float32),
        "fov": rng.uniform(55.0, 65.0, (N_FRAMES,)).astype(np.float32),
        "log_beta_scales": rng.uniform(-0.1, 0.1, (J, 3)).astype(np.float32),
        "joint_trans": rng.uniform(-0.02, 0.02, (J, 3)).astype(np.float32),
    }


def _jax_loss(jspec, jdata, params, weights, vis):
    total, objs = jfit.forward_losses(
        jspec, params, jdata, weights, jpri.default_pose_prior(jspec),
        jpri.default_limit_prior(jspec), jpri.shape_prior_from_spec(jspec), SIZE,
        visibility_override=vis, use_pallas=False)
    tj, tg, tt = jfit.temporal_losses(params, weights.w_temp)
    return total + tj + tg + tt, dict(objs, temporal_joint=tj, temporal_global=tg,
                                      temporal_trans=tt)


def _port_loss(tspec, tdata, params, weights, vis):
    total, objs = tfit.forward_losses(
        tspec, params, tdata, weights, tpri.default_pose_prior(tspec),
        tpri.default_limit_prior(tspec), tpri.shape_prior_from_spec(tspec), SIZE,
        visibility_override=vis)
    tj, tg, tt = tfit.temporal_losses(params, weights.w_temp)
    return total + tj + tg + tt, dict(objs, temporal_joint=tj, temporal_global=tg,
                                      temporal_trans=tt)


def _visibility(spec):
    vis = np.ones((N_FRAMES, spec.n_joints), np.float32)
    vis[0, 2] = vis[1, 4] = 0.0  # the 2D-joint MSE still divides by every element
    return vis


@pytest.mark.parametrize("stage", [0, 1])
def test_loss_terms_match_jax(setup, stage):
    jspec, tspec, jdata, tdata = setup
    p = _random_params(tspec)
    vis = _visibility(tspec)
    jtotal, jobjs = _jax_loss(jspec, jdata, jfit.FitParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                              JAX_OPT_WEIGHTS[stage], jnp.asarray(vis))
    ttotal, tobjs = _port_loss(tspec, tdata, tfit.params_from_numpy(p, device="cpu"),
                               OPT_WEIGHTS[stage], torch.from_numpy(vis))
    assert set(tobjs) == set(jobjs)
    if stage == 1:
        assert float(jobjs["sil_reproj"]) > 0
    for k in jobjs:
        np.testing.assert_allclose(float(tobjs[k]), float(jobjs[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)


def test_step_gradients_match_jax(setup):
    """One step's gradients, all terms on (stage 1 weights)."""
    jspec, tspec, jdata, tdata = setup
    p = _random_params(tspec, seed=12)
    vis = _visibility(tspec)
    weights = OPT_WEIGHTS[1]
    jgrad = jax.grad(lambda q: _jax_loss(jspec, jdata, q, JAX_OPT_WEIGHTS[1], jnp.asarray(vis))[0])(
        jfit.FitParams(**{k: jnp.asarray(v) for k, v in p.items()}))
    tp = tfit.params_from_numpy(p, device="cpu")
    leaves = {k: getattr(tp, k).requires_grad_(True) for k in FIELDS}
    _port_loss(tspec, tdata, tfit.FitParams(**leaves), weights, torch.from_numpy(vis))[0].backward()
    for k in FIELDS:
        g_j = np.asarray(getattr(jgrad, k))
        g_t = leaves[k].grad.numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-5 * np.abs(g_j).max(), err_msg=k)


def test_two_stages_match_jax(setup):
    """Parameters after 3 steps of stage 0 (no raster, torso joints, fov at
    lr 1) and 3 steps of stage 1 (every term). Adam's first steps move each
    parameter by about lr times the sign of its gradient, whatever its size,
    so the tolerance is set by the stage's lr (fov: 1): a tenth of it. A
    near-zero gradient of opposite sign on the two sides would move them
    apart by 2·lr a step and fail it."""
    jspec, tspec, jdata, tdata = setup
    jfitter = jfit.SmalFitter(jspec, jdata, SIZE, use_pallas=False)
    tfitter = tfit.SmalFitter(tspec, tdata, SIZE, device="cpu")
    jsched, tsched = jax_test_schedule(3, max_stages=2), tstages.test_schedule(3, max_stages=2)
    assert [w._asdict() for w in jsched] == [w._asdict() for w in tsched]
    seen = []
    for stage, (jw, tw) in enumerate(zip(jsched, tsched)):
        jloss = jfitter.run_stage(stage, jw)
        tloss = tfitter.run_stage(stage, tw, chunk=2,
                                  callback=lambda s, it, loss, objs: seen.append((s, it)))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        for k in FIELDS:
            atol = 0.1 * (1.0 if k == "fov" else tw.lr)
            np.testing.assert_allclose(getattr(tfitter.params, k).numpy(),
                                       np.asarray(getattr(jfitter.params, k)),
                                       atol=atol, err_msg=f"stage {stage} {k}")
    assert seen == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    # frozen fields stay put: joint_trans always, joint_rot / betas in stage 0
    np.testing.assert_array_equal(tfitter.params.joint_trans.numpy(), 0.0)


def test_stage0_freezes_pose_and_shape(setup):
    _, tspec, _, tdata = setup
    f = tfit.SmalFitter(tspec, tdata, SIZE, device="cpu")
    before = dataclasses.asdict(f.params)
    f.run_stage(0, tstages.test_schedule(2)[0])
    for k in ("joint_rot", "betas", "log_beta_scales", "joint_trans"):
        torch.testing.assert_close(getattr(f.params, k), before[k], rtol=0, atol=0)
    assert not torch.equal(f.params.global_rot, before["global_rot"])


@pytest.mark.parametrize("cap", [None, 40])
def test_fitter_losses_fall(setup, cap):
    """Both raster modes drive a falling loss on the port (plain versions)."""
    _, tspec, _, tdata = setup
    f = tfit.SmalFitter(tspec, tdata, SIZE, approx_max_faces=cap, device="cpu")
    losses = []
    w = tstages.test_schedule(6)[1]
    f.run_stage(1, w, callback=lambda s, it, loss, objs: losses.append(float(loss)))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    verts, joints = f.forward_frames()
    assert verts.shape == (N_FRAMES, tspec.n_verts, 3) and joints.shape == (N_FRAMES, 6, 3)


def test_render_frame_matches_jax(setup):
    jspec, tspec, _, _ = setup
    from smilify_tpu.core.lbs import smil_forward as jax_smil_forward
    from smilify_tpu.render.cameras import default_camera as jax_camera

    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.render.cameras import default_camera

    theta = np.random.RandomState(13).uniform(-0.2, 0.2, (1, tspec.n_joints, 3)).astype(np.float32)
    theta[0, 0] += jfit._default_global_rotation()
    jo = jax_smil_forward(jspec, jnp.zeros((1, 3)), jnp.asarray(theta))
    jsil, jyx = jfit.render_frame(jspec, jax_camera(), jo.verts[0], jo.joints[0], SIZE,
                                  use_pallas=False)
    to = smil_forward(tspec, torch.zeros((1, 3)), torch.from_numpy(theta))
    tsil, tyx = tfit.render_frame(tspec, default_camera(device="cpu"), to.verts[0], to.joints[0],
                                  SIZE)
    assert float(jsil.max()) > 0.99
    np.testing.assert_allclose(tsil.numpy(), np.asarray(jsil), atol=1e-4)
    np.testing.assert_allclose(tyx.numpy(), np.asarray(jyx), atol=1e-4)
