"""Parity of the port's coarse-to-fine fitter (smilify_tpu_torch.fitter.progressive)
with the JAX package on the CPU.

The pyramid's data transforms are exact (area averages of binary
silhouettes, joints divided by a power of two), so they match JAX exactly;
an all-ones scale list is the plain fitter, step for step; a (1, 2) pyramid
follows the JAX one to a tenth of each stage's lr, the tolerance of
``test_torch_fitter.py`` for Adam trajectories.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.fitter import fitter as jfit
from smilify_tpu.fitter import progressive as jprog
from smilify_tpu.fitter.stages import StageWeights as JaxStageWeights
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter as tfit
from smilify_tpu_torch.fitter import progressive as tprog
from smilify_tpu_torch.fitter.stages import StageWeights

SIZE = (64, 64)
N_FRAMES = 2
FIELDS = tfit.FitParams.fields()
# stage 0 (no raster, lr 9e-2) then a full-loss stage (lr 5e-3)
SCHEDULE = [(25.0, 0.0, 0.0, 0.0, 0.0, 0.0, 500.0, 4, 9e-2),
            (10.0, 500.0, 1.0, 1.0, 100.0, 0.1, 100.0, 4, 5e-3)]


@pytest.fixture(scope="module")
def setup():
    jspec = jax_toy_spec(10, 6, 3)
    tspec = toy_model_spec(10, 6, 3, device="cpu")
    jdata = jfit.synthetic_fit_data(jspec, N_FRAMES, SIZE, use_pallas=False)
    arrays = {k: np.asarray(getattr(jdata, k)) for k in ("sil", "joints", "visibility")}
    tdata = tfit.FitData(rgb=None, **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    return jspec, tspec, jdata, tdata


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_downsample_matches_jax_exactly(setup, scale):
    _, _, jdata, tdata = setup
    jd = jprog.downsample_fit_data(jdata, scale)
    td = tprog.downsample_fit_data(tdata, scale)
    assert td.sil.shape == (N_FRAMES, SIZE[0] // scale, SIZE[1] // scale)
    for k in ("sil", "joints", "visibility"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), err_msg=k)


def test_downsample_rejects_non_divisible(setup):
    with pytest.raises(ValueError, match="not divisible"):
        tprog.downsample_fit_data(setup[3], 3)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_scaled_weights_match_jax_exactly(scale):
    for row in SCHEDULE:
        assert tprog.scaled_weights(StageWeights(*row), scale)._asdict() == \
            jprog.scaled_weights(JaxStageWeights(*row), scale)._asdict()


def test_all_ones_scales_match_plain_fitter_exactly(setup):
    _, tspec, _, tdata = setup
    sched = [StageWeights(*row) for row in SCHEDULE]
    plain = tfit.SmalFitter(tspec, tdata, SIZE, device="cpu")
    plain_losses = plain.fit(sched, chunk=2)
    prog = tprog.ProgressiveFitter(tspec, tdata, SIZE, scales=(1, 1), device="cpu")
    prog_losses = prog.fit(sched, chunk=2)
    for a, b in zip(plain_losses, prog_losses):
        assert float(a) == float(b)
    for k in FIELDS:
        torch.testing.assert_close(getattr(prog.params, k), getattr(plain.params, k),
                                   rtol=0, atol=0)


def test_pyramid_matches_jax(setup):
    jspec, tspec, jdata, tdata = setup
    jfitter = jprog.ProgressiveFitter(jspec, jdata, SIZE, scales=(1, 2), use_pallas=False)
    tfitter = tprog.ProgressiveFitter(tspec, tdata, SIZE, scales=(1, 2), device="cpu")
    for stage, row in enumerate(SCHEDULE):
        jloss = jfitter.run_stage(stage, JaxStageWeights(*row))
        tloss = tfitter.run_stage(stage, StageWeights(*row), chunk=2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        for k in FIELDS:
            atol = 0.1 * (1.0 if k == "fov" else row[-1])
            np.testing.assert_allclose(getattr(tfitter.params, k).numpy(),
                                       np.asarray(getattr(jfitter.params, k)),
                                       atol=atol, err_msg=f"stage {stage} {k}")
    # stage 1 ran at 32², and the full-resolution fitter holds the result
    assert set(tfitter._fitters) == {1, 2}
    verts, _ = tfitter.forward_frames()
    assert verts.shape == (N_FRAMES, tspec.n_verts, 3) and bool(torch.isfinite(verts).all())
