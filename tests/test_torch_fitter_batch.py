"""Parity of the port's sequence-batched fitter
(smilify_tpu_torch.fitter.fitter_batch) with the JAX package on the CPU.

Targets: the silhouettes and joints that the JAX package's
``synthetic_fit_data`` renders for S·N frames, regrouped into S clips of N
frames and handed to both packages as numpy. The JAX side renders with its
all-faces oracle, the port with the plain versions of its exact raster
kernels (alpha within ~1e-6), so the loss terms agree to rtol 1e-4 as in
``test_torch_fitter.py``; Adam trajectories to a tenth of each stage's lr
(Adam's first steps move a parameter by about lr whatever its gradient).
Batched against independent port fits: ``tests/test_fitter_batch.py``'s
tolerance (rtol 2e-4, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.fitter import fitter as jfit
from smilify_tpu.fitter import fitter_batch as jbatch
from smilify_tpu.fitter import priors as jpri
from smilify_tpu.fitter.stages import OPT_WEIGHTS as JAX_OPT_WEIGHTS
from smilify_tpu.fitter.stages import test_schedule as jax_test_schedule
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter as tfit
from smilify_tpu_torch.fitter import fitter_batch as tbatch
from smilify_tpu_torch.fitter import priors as tpri
from smilify_tpu_torch.fitter import stages as tstages
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS, StageWeights

SIZE = (64, 64)
S, N = 2, 2
FIELDS = tfit.FitParams.fields()


@pytest.fixture(scope="module")
def setup():
    jspec = jax_toy_spec(10, 6, 3)
    tspec = toy_model_spec(10, 6, 3, device="cpu")
    jflat = jfit.synthetic_fit_data(jspec, S * N, SIZE, use_pallas=False)
    arrays = {k: np.asarray(getattr(jflat, k)).reshape((S, N) + np.shape(getattr(jflat, k))[1:])
              for k in ("sil", "joints", "visibility")}
    assert 0.01 < arrays["sil"].mean() < 0.5
    jdata = jfit.FitData(rgb=None, **{k: jnp.asarray(v) for k, v in arrays.items()})
    tdata = tfit.FitData(rgb=None, **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    return jspec, tspec, jdata, tdata


def _random_params(spec, seed=21):
    """Batched parameters near the init (as numpy), every loss term non-trivial."""
    rng = np.random.RandomState(seed)
    J, B = spec.n_joints, spec.n_betas
    g0 = jfit._default_global_rotation()
    return {
        "global_rot": (g0 + rng.uniform(-0.1, 0.1, (S, N, 3))).astype(np.float32),
        "joint_rot": rng.uniform(-0.05, 0.05, (S, N, J - 1, 3)).astype(np.float32),
        "betas": rng.uniform(-0.3, 0.3, (S, B)).astype(np.float32),
        "trans": rng.uniform(-0.03, 0.03, (S, N, 3)).astype(np.float32),
        "fov": rng.uniform(55.0, 65.0, (S, N)).astype(np.float32),
        "log_beta_scales": rng.uniform(-0.1, 0.1, (S, J, 3)).astype(np.float32),
        "joint_trans": rng.uniform(-0.02, 0.02, (S, J, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("stage", [0, 1])
def test_forward_losses_many_match_jax(setup, stage):
    jspec, tspec, jdata, tdata = setup
    p = _random_params(tspec)
    vis = np.ones((S, N, tspec.n_joints), np.float32)
    vis[0, 1, 2] = vis[1, 0, 4] = 0.0
    jtotal, jobjs = jbatch.forward_losses_many(
        jspec, jfit.FitParams(**{k: jnp.asarray(v) for k, v in p.items()}), jdata,
        JAX_OPT_WEIGHTS[stage], jpri.default_pose_prior(jspec), jpri.default_limit_prior(jspec),
        jpri.shape_prior_from_spec(jspec), SIZE, visibility_override=jnp.asarray(vis),
        use_pallas=False)
    ttotal, tobjs = tbatch.forward_losses_many(
        tspec, tfit.params_from_numpy(p, device="cpu"), tdata, OPT_WEIGHTS[stage],
        tpri.default_pose_prior(tspec), tpri.default_limit_prior(tspec),
        tpri.shape_prior_from_spec(tspec), SIZE, visibility_override=torch.from_numpy(vis))
    assert set(tobjs) == set(jobjs)
    if stage == 1:
        assert float(jobjs["sil_reproj"]) > 0
    for k in jobjs:
        np.testing.assert_allclose(float(tobjs[k]), float(jobjs[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)


def test_two_stages_match_jax(setup):
    jspec, tspec, jdata, tdata = setup
    jfitter = jbatch.BatchedFitter(jspec, jdata, SIZE, use_pallas=False)
    tfitter = tbatch.BatchedFitter(tspec, tdata, SIZE, device="cpu")
    assert (tfitter.n_seqs, tfitter.n_frames) == (S, N)
    jsched, tsched = jax_test_schedule(3, max_stages=2), tstages.test_schedule(3, max_stages=2)
    for stage, (jw, tw) in enumerate(zip(jsched, tsched)):
        jloss = jfitter.run_stage(stage, jw)
        tloss = tfitter.run_stage(stage, tw, chunk=2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        for k in FIELDS:
            atol = 0.1 * (1.0 if k == "fov" else tw.lr)
            np.testing.assert_allclose(getattr(tfitter.params, k).numpy(),
                                       np.asarray(getattr(jfitter.params, k)),
                                       atol=atol, err_msg=f"stage {stage} {k}")
    verts, joints = tfitter.forward_frames()
    assert verts.shape == (S, N, tspec.n_verts, 3) and joints.shape == (S, N, tspec.n_joints, 3)


def _seq_data(spec, seed):
    rng = np.random.RandomState(seed)
    H, W = SIZE
    return tfit.FitData(
        rgb=None,
        sil=torch.from_numpy((rng.rand(N, H, W) > 0.8).astype(np.float32)),
        joints=torch.from_numpy(rng.rand(N, spec.n_joints, 2).astype(np.float32) * H),
        visibility=torch.from_numpy((rng.rand(N, spec.n_joints) > 0.2).astype(np.float32)),
    )


def _stack(datas):
    return tfit.FitData(rgb=None, **{k: torch.stack([getattr(d, k) for d in datas])
                                     for k in ("sil", "joints", "visibility")})


def _schedule():
    # stage 0 takes the torso-only freeze path, stage 1 the full loss
    return [
        StageWeights(num_iters=3, lr=1e-2, w_j2d=1.0, w_reproj=0.0, w_betas=0.0,
                     w_pose=0.0, w_limit=0.0, w_splay=0.0, w_temp=0.0),
        StageWeights(num_iters=4, lr=1e-2, w_j2d=1.0, w_reproj=0.5, w_betas=0.1,
                     w_pose=0.01, w_limit=0.01, w_splay=0.01, w_temp=0.1),
    ]


def test_batched_matches_independent_fits(setup):
    _, tspec, _, _ = setup
    datas = [_seq_data(tspec, seed) for seed in (0, 1)]
    batched = tbatch.BatchedFitter(tspec, _stack(datas), SIZE, device="cpu")
    batched.fit(schedule=_schedule())
    for s, data in enumerate(datas):
        single = tfit.SmalFitter(tspec, data, SIZE, device="cpu")
        single.fit(schedule=_schedule())
        got = batched.sequence_params(s)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(got, k).numpy(), getattr(single.params, k).numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=f"clip {s} {k}")


def test_batched_chunked_matches_single_steps(setup):
    """chunk 3 over 4 steps (3 back to back, then 1) against chunk 1."""
    _, tspec, _, _ = setup
    data = _stack([_seq_data(tspec, seed) for seed in (5, 6)])
    results = {}
    for chunk in (1, 3):
        fitter = tbatch.BatchedFitter(tspec, data, SIZE, device="cpu")
        fitter.run_stage(1, _schedule()[1], chunk=chunk)
        results[chunk] = fitter.params
    for k in FIELDS:
        np.testing.assert_allclose(getattr(results[1], k).numpy(), getattr(results[3], k).numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
