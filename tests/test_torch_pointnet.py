"""PointNet in the port held to the JAX package on the CPU.

* farthest-point sampling's indices and ``radius_group``'s groups and masks
  exactly (groups within 1e-6: the same float32 subtraction);
* the forward pass of both architectures with weights carried from Flax
  (``state_dict_from_flax``) within 2e-5 × max(1, max |JAX|)
  (tests/test_torch_models.py's model tolerance);
* ``pointnet_loss``'s parameter and joint terms within 1e-5 relative, and
  its chamfer term on the same point sets within 1e-5 relative (the JAX
  loss samples the predicted surface with its PRNG, the port with a
  ``torch.Generator``: the draws differ, so the term is compared on given
  points);
* ``train_pointnet``: its mean loss falls from the first epoch to the last
  at the STICK model's width, and its checkpoint carries the model.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.models.weight_port import state_dict_from_flax
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
from smilify_tpu_torch.train import trainer as ttrainer
from tests.test_torch_models import MODEL_TOL, assert_close, random_variables

LOSS_RTOL = 1e-5


def test_pointnet_sampling_and_grouping_match_jax():
    from smilify_tpu.models import pointnet as jpn
    from smilify_tpu_torch.models import pointnet as tpn

    rng = np.random.default_rng(0)
    clouds = (rng.random((2, 300, 3), dtype=np.float32) - 0.5)
    tidx = tpn.farthest_point_sampling(torch.from_numpy(clouds), 40).numpy()
    for b in range(2):
        pts = jnp.asarray(clouds[b])
        np.testing.assert_array_equal(tidx[b], np.asarray(jpn.farthest_point_sampling(pts, 40)))
        centers = pts[np.asarray(tidx[b])]
        for radius, k in ((0.1, 8), (0.25, 16)):
            jg, jm = jpn.radius_group(pts, centers, radius, k)
            tg, tm = tpn.radius_group(torch.from_numpy(clouds[b:b + 1]),
                                      torch.from_numpy(np.asarray(centers))[None], radius, k)
            np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
            assert_close(tg[0], np.asarray(jg), 1e-6, f"groups r={radius}")
            assert 0 < float(jm.sum()) < jm.size      # some groups are padded


@pytest.mark.parametrize("arch", ["pointnet", "pointnet2"])
def test_pointnet_forward_matches_jax(arch):
    from smilify_tpu.models import pointnet as jpn
    from smilify_tpu_torch.models import pointnet as tpn

    kw = dict(arch=arch, n_pose=5, n_betas=3, n_joints=6, head_hidden=16)
    clouds = np.random.default_rng(1).random((2, 300, 3), dtype=np.float32) - 0.5
    v = random_variables(jpn.SMILPointNet(jpn.PointNetConfig(**kw)), jnp.zeros((2, 300, 3)), seed=2)
    want = jpn.SMILPointNet(jpn.PointNetConfig(**kw)).apply(v, jnp.asarray(clouds))
    model = tpn.SMILPointNet(tpn.PointNetConfig(**kw))
    model.load_state_dict(state_dict_from_flax(v, model))
    got = model(torch.from_numpy(clouds))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], np.asarray(want[k]), MODEL_TOL, k)


def test_pointnet_loss_matches_jax():
    from smilify_tpu.models import pointnet as jpn
    from smilify_tpu.train.multidevice import toy_model_spec as j_toy
    from smilify_tpu_torch.models import pointnet as tpn

    rng = np.random.default_rng(3)
    jspec, tspec = j_toy(8, 6, 3), toy_model_spec(8, 6, 3, device="cpu")
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    gt = {"global_rot": 0.3 * f(2, 3), "joint_rot": 0.1 * f(2, 5, 3), "betas": 0.4 * f(2, 3),
          "trans": np.zeros((2, 3), np.float32)}
    raw = {"global_rot": f(2, 6), "joint_rot": f(2, 30), "betas": 0.3 * f(2, 3), "trans": 0.1 * f(2, 3),
           "scale_weights": 0.1 * f(2, 3), "trans_weights": 0.1 * f(2, 3)}
    joints, clouds = f(2, 6, 3), f(2, 64, 3)
    for predict_scales in (False, True):
        kw = dict(n_pose=5, n_betas=3, n_joints=6, predict_scales=predict_scales)
        r = raw if predict_scales else {k: raw[k] for k in ("global_rot", "joint_rot", "betas", "trans")}
        jt, jo = jpn.pointnet_loss(
            jspec, jpn.PointNetConfig(**kw), {k: jnp.asarray(v) for k, v in r.items()},
            {k: jnp.asarray(v) for k, v in gt.items()}, jnp.asarray(joints), jnp.asarray(clouds))
        tt, to = tpn.pointnet_loss(
            tspec, tpn.PointNetConfig(**kw), {k: torch.from_numpy(v) for k, v in r.items()},
            {k: torch.from_numpy(v) for k, v in gt.items()}, torch.from_numpy(joints),
            torch.from_numpy(clouds))
        assert sorted(to) == sorted(jo) == ["joint", "param"]
        for k in jo:
            assert abs(float(to[k]) - float(jo[k])) <= LOSS_RTOL * abs(float(jo[k])), k
    # the chamfer term on the same point sets: the JAX loss's per-cloud formula
    from smilify_tpu.ops.knn import knn_points as j_knn

    a, b = f(2, 50, 3), f(2, 40, 3)
    want = [float(jnp.mean(j_knn(jnp.asarray(x), jnp.asarray(y), K=1).dists)
                  + jnp.mean(j_knn(jnp.asarray(y), jnp.asarray(x), K=1).dists)) for x, y in zip(a, b)]
    got = tpn.chamfer(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_train_pointnet_loss_falls(tmp_path):
    """At the STICK model's width (the procedural spec of smilify_tpu_torch.bench)."""
    from smilify_tpu_torch.bench import load_spec
    from smilify_tpu_torch.cli.train_pointnet import main

    pkl = write_model_pkl(str(tmp_path / "stick_width.pkl"), load_spec(None, torch.device("cpu"))[0])
    state = main(["--model", pkl, "--epochs", "3", "--steps-per-epoch", "20", "--batch", "4",
                  "--points", "256", "--output-dir", str(tmp_path), "--device", "cpu"])
    losses = [h["loss"] for h in state.history]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    payload, meta = ttrainer.load_checkpoint(str(tmp_path / "final_model"))
    assert meta["epoch"] == 2 and "encoder_batched.encoder.Dense_0.weight" in payload["model"]
