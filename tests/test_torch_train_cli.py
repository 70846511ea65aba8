"""The port's trainer CLIs, their helpers and PointNet held to the JAX
package on the CPU.

* ``train_regressor``: the JAX CLI trains a seeded ``unet_micro`` regressor
  for 1 epoch on a 12-frame replicAnt folder (dropout and augmentation off,
  no workers); its orbax checkpoint is converted to the port's format
  (``state_dict_from_flax``); both CLIs then ``--resume`` it for a second
  epoch. Both rebuild Adam at that epoch (fresh moments), see the same
  batches (the same seeded index order) and take one step, so their epoch
  loss, validation loss and every loss component agree within 1e-5
  relative (or 1e-7 of the epoch loss, for components far below it), and
  the IEF health metrics of the epoch's visualization within
  1e-4 relative (the decoder's estimate deltas, differences of float32
  values of ~1).
* ``train_viz``: ``ief_delta_norms`` and ``_quick_pck`` on the same decoded
  predictions within 1e-6 relative and exactly.

``train_multiview`` and ``multiview_setup`` are held to the JAX package in
tests/test_torch_train_multiview_cli.py, PointNet in tests/test_torch_pointnet.py
(each file within ~90 s on one worker).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.models.weight_port import state_dict_from_flax
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
from smilify_tpu_torch.train import config as tconfig
from smilify_tpu_torch.train import trainer as ttrainer

LOSS_RTOL, IEF_RTOL = 1e-5, 1e-4
RES = 32
TINY = ["model.backbone_name=unet_micro", f"model.input_resolution={RES}", "training.batch_size=4",
        "model.transformer_depth=1", "model.transformer_heads=2", "model.transformer_dim_head=8",
        "model.transformer_mlp_dim=16", "model.freeze_backbone=false", "training.num_workers=0",
        "training.use_mixed_precision=false", "dataset.dataset_fraction=1.0",
        "augmentation.enabled=false", "model.transformer_dropout=0.0",
        "output.num_visualization_samples=2"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    spec = toy_model_spec(8, 6, 3, device="cpu")
    return spec, write_model_pkl(str(root / "toy.pkl"), spec)


def convert_checkpoint(jdir, tdir, name, img_size):
    """The JAX package's orbax checkpoint ``jdir/name`` as the port's ``tdir/name``."""
    import orbax.checkpoint as ocp

    restored = ocp.PyTreeCheckpointer().restore(os.path.abspath(os.path.join(jdir, name)))
    with open(os.path.join(jdir, f"{name}.meta.json")) as f:
        meta = json.load(f)
    cfg = tconfig.config_from_dict(meta["config"])
    rcfg = cfg.regressor_config(tconfig.resolve_model_spec(cfg, device="cpu"))
    sd = state_dict_from_flax({"params": restored["params"], "batch_stats": restored["batch_stats"]},
                              rcfg, img_size=img_size)
    ttrainer.save_checkpoint(str(tdir), ttrainer.TrainState(sd, epoch=meta["epoch"], step=meta["step"],
                                                            history=meta["history"]), cfg, name)


def assert_same_epoch(t, j):
    """One history entry of each trainer: the losses within LOSS_RTOL, the
    IEF metrics within IEF_RTOL; a loss component far below the epoch's
    loss (the camera terms of cameras started at the ground truth, ~1e-8)
    also within 1e-7 of the epoch loss, below float32's resolution of it."""
    assert t["epoch"] == j["epoch"] and sorted(t) == sorted(j)
    for k, v in j.items():
        tol = IEF_RTOL if k.startswith("ief_") else LOSS_RTOL
        assert abs(t[k] - v) <= tol * abs(v) + 1e-7 * abs(j["loss"]), (k, t[k], v)


def test_train_regressor_resumes_as_jax(tmp_path, toy):
    from smilify_tpu.cli.train_regressor import main as j_train
    from smilify_tpu_torch.cli.train_regressor import main as t_train

    spec, pkl = toy
    folder, _ = write_replicant_sequence(str(tmp_path / "seq"), spec, 12, RES, layout="unreal")
    common = ["--model", pkl, "--data-path", folder, "--set", *TINY, "dataset.train_ratio=0.5",
              "dataset.val_ratio=0.35", "dataset.test_ratio=0.15"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_train(["--epochs", "1", "--output-dir", str(jdir)] + common)
    convert_checkpoint(jdir, tdir, "final_model", RES)
    resume = ["--epochs", "2", "--resume", "final_model"]
    jstate = j_train(resume + ["--output-dir", str(jdir)] + common)
    tstate = t_train(resume + ["--output-dir", str(tdir), "--device", "cpu"] + common)
    assert len(tstate.history) == len(jstate.history) == 2
    assert "val_loss" in jstate.history[-1] and "ief_val_pck5" in jstate.history[-1]
    assert_same_epoch(tstate.history[-1], jstate.history[-1])
    names = {p.name.removesuffix(".pt") for p in tdir.glob("*.pt")}
    assert names == {"best_model", "epoch_1", "final_model"}
    payload, meta = ttrainer.load_checkpoint(str(tdir / "final_model"))
    assert meta["epoch"] == 1 and payload["opt_state"]["inner"]["state"]
    assert sorted(p.name for p in (tdir / "visualizations_train").glob("*.png"))[:2] == [
        "epoch0001_kp3d.png", "epoch0001_sample0.png"]


# ---------------------------------------------------------------------------
# train_viz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multiview", [False, True])
def test_train_viz_metrics_match_jax(multiview):
    from smilify_tpu.train import train_viz as jviz
    from smilify_tpu.train.multidevice import toy_model_spec as j_toy
    from smilify_tpu_torch.train import train_viz as tviz

    rng = np.random.default_rng(4)
    n, J, V = 3, 6, 2
    jspec, tspec = j_toy(8, J, 3), toy_model_spec(8, J, 3, device="cpu")
    rot = np.linalg.qr(rng.standard_normal((n, V, 3, 3)))[0].astype(np.float32)
    preds = {"global_rot": 0.3 * rng.standard_normal((n, 3)),
             "joint_rot": 0.2 * rng.standard_normal((n, J - 1, 3)),
             "betas": 0.3 * rng.standard_normal((n, 3)), "trans": 0.05 * rng.standard_normal((n, 3))}
    if multiview:
        preds.update(view_cam_rot=rot, view_cam_trans=np.tile([0.0, 0.0, 2.7], (n, V, 1)),
                     view_fov=np.full((n, V), 55.0))
        batch = {"view_mask": np.array([[True, True], [False, True], [False, False]]),
                 "keypoints_2d": rng.random((n, V, J, 2)) * RES,
                 "keypoint_visibility": (rng.random((n, V, J)) > 0.3).astype(np.float32)}
    else:
        preds.update(cam_rot=rot[:, 0], cam_trans=np.tile([0.0, 0.0, 2.7], (n, 1)),
                     fov=np.full((n,), 55.0))
        batch = {"keypoints_2d": rng.random((n, J, 2)),      # normalized (y, x)
                 "keypoint_visibility": (rng.random((n, J)) > 0.3).astype(np.float32)}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    # place the GT near the projection so that some joints fall within 5 px
    jp = jviz._quick_pck(jspec, {k: jnp.asarray(v) for k, v in preds.items()}, batch, (RES, RES),
                         multiview)
    tp = tviz._quick_pck(tspec, {k: torch.from_numpy(v) for k, v in preds.items()}, batch,
                         (RES, RES), multiview)
    assert tp == jp
    hist = [{"a": rng.standard_normal((n, 4)), "b": rng.standard_normal((n, 2))} for _ in range(3)]
    flat = [rng.standard_normal((n, 6)).astype(np.float32) for _ in range(3)]
    for h in (hist, flat):
        want = jviz.ief_delta_norms(h)
        got = tviz.ief_delta_norms([{k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in x.items()}
                                    if isinstance(x, dict) else torch.from_numpy(x) for x in h])
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * want[k], k
