"""The multi-view trainer in the port held to the JAX package on the CPU.

* ``multiview_setup``: ``batch_to_view_cams`` and ``gt_camera_init`` on
  seeded OpenCV cameras within 2e-6 × max(1, max |JAX|) (float32 atan2 and
  6D rotations); ``make_multiview_loss_fn`` with ignored joints and joint
  importance on the same predictions: the total and every component within
  1e-5 relative. ``make_multiview_apply_fn`` runs in the CLI test below,
  the camera head in delta mode (the batch's cameras initialize it).
* ``train_multiview``: the JAX CLI trains 1 epoch on a 10-sample 2-view
  HDF5 store (``data/synthetic.py::generate_synthetic_multiview``), the
  camera head in delta mode; its checkpoint is converted to the port's
  format and both CLIs ``--resume`` it for a second epoch (fresh Adam
  moments in both): the epoch loss, validation loss and components within
  1e-5 relative, the IEF metrics within 1e-4 relative. The DLT term is off
  there: the store's ring cameras (300 px focal length at 32 px) are nearly
  orthographic, which leaves the triangulated depth ill-conditioned.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.data.synthetic import generate_synthetic_multiview
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
from tests.test_torch_models import assert_close
from tests.test_torch_train_cli import TINY, assert_same_epoch, convert_checkpoint

CAM_TOL, LOSS_RTOL = 2e-6, 1e-5
RES, V, J = 32, 3, 6
MV = ["multiview.num_views_to_use=2", "multiview.cross_attention_heads=2",
      "multiview.cross_attention_layers=1",
      # the toy store's ring cameras have a 300 px focal length at 32 px: nearly
      # orthographic, so the DLT's depth is ill-conditioned (the term is held
      # to JAX at well-posed cameras in tests/test_torch_models.py)
      'scale_trans_beta.entangled_loss_weights={"log_beta_scales": 0.0, "betas_trans": 0.0, '
      '"triangulation_consistency": 0.0}']


def _mv_batch(rng, n=2):
    from smilify_tpu_torch.data.synthetic import ring_cameras_opencv

    Rs, ts, Ks = zip(*ring_cameras_opencv(V, focal=30.0, resolution=RES))   # ~56° fov
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"images": rng.random((n, V, RES, RES, 3), dtype=np.float32),
            "view_mask": np.array([[True, True, False], [True, True, True]])[:n],
            "camera_indices": np.tile(np.arange(V), (n, 1)).astype(np.int32),
            "camera_extrinsics_R": np.tile(np.asarray(Rs, np.float32), (n, 1, 1, 1)),
            "camera_extrinsics_t": np.tile(np.asarray(ts, np.float32), (n, 1, 1)),
            "camera_intrinsics": np.tile(np.asarray(Ks, np.float32), (n, 1, 1, 1)),
            "global_rot": 0.3 * f(n, 3), "joint_rot": 0.2 * f(n, J - 1, 3), "betas": 0.3 * f(n, 5),
            "trans": 0.05 * f(n, 3), "keypoints_3d": f(n, J, 3),
            "keypoints_2d": rng.random((n, V, J, 2), dtype=np.float32) * RES,
            "keypoint_visibility": (rng.random((n, V, J)) > 0.2).astype(np.float32)}


def test_multiview_setup_matches_jax():
    from smilify_tpu.train import multiview_setup as jms
    from smilify_tpu.train.multidevice import toy_model_spec as j_toy
    from smilify_tpu_torch.train import multiview_setup as tms

    batch = _mv_batch(np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jc, tc = jms.batch_to_view_cams(jb, (RES, RES)), tms.batch_to_view_cams(tb, (RES, RES))
    for k in jc:
        assert_close(tc[k], np.asarray(jc[k]), CAM_TOL, k)
    jg, tg = jms.gt_camera_init(jb, (RES, RES)), tms.gt_camera_init(tb, (RES, RES))
    for k in jg:
        assert_close(tg[k], np.asarray(jg[k]), CAM_TOL, k)

    from smilify_tpu.models.multiview import MultiViewConfig as JConfig
    from smilify_tpu_torch.models.multiview import MultiViewConfig as TConfig

    jspec, tspec = j_toy(8, J, 5), toy_model_spec(8, J, 5, device="cpu")
    jrcfg, trcfg = (c(n_pose=J - 1, n_betas=5, n_joints=J, max_views=V) for c in (JConfig, TConfig))
    # decoded predictions with the batch's cameras (the DLT's rays then meet
    # at a well-posed angle)
    rng = np.random.default_rng(1)
    preds = {"global_rot": 0.3 * rng.standard_normal((2, 3)),
             "joint_rot": 0.2 * rng.standard_normal((2, J - 1, 3)),
             "betas": 0.3 * rng.standard_normal((2, 5)), "trans": 0.05 * rng.standard_normal((2, 3))}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    preds.update({k: np.asarray(v) for k, v in jc.items()})
    jpreds = {k: jnp.asarray(v) for k, v in preds.items()}
    tpreds = {k: torch.from_numpy(v) for k, v in preds.items()}
    kw = dict(joint_importance=np.linspace(0.5, 1.5, J).astype(np.float32), ignored_joint_indices=[1, 3])
    jt, jo = jms.make_multiview_loss_fn(jspec, jrcfg, {"keypoint_2d": 1.0, "keypoint_3d": 0.5}, (RES, RES),
                                        joint_importance=jnp.asarray(kw["joint_importance"]),
                                        ignored_joint_indices=kw["ignored_joint_indices"])(jpreds, jb)
    tt, to = tms.make_multiview_loss_fn(tspec, trcfg, {"keypoint_2d": 1.0, "keypoint_3d": 0.5}, (RES, RES),
                                        joint_importance=torch.from_numpy(kw["joint_importance"]),
                                        ignored_joint_indices=kw["ignored_joint_indices"])(tpreds, tb)
    assert sorted(to) == sorted(jo) and "keypoint_2d" in jo
    for k in jo:
        assert abs(float(to[k]) - float(jo[k])) <= LOSS_RTOL * abs(float(jo[k])) + 1e-12, k
    assert abs(float(tt) - float(jt)) <= LOSS_RTOL * abs(float(jt))


def test_train_multiview_resumes_as_jax(tmp_path):
    pytest.importorskip("h5py")
    from smilify_tpu.cli.train_multiview import main as j_train
    from smilify_tpu_torch.cli.train_multiview import main as t_train

    spec = toy_model_spec(8, J, 3, device="cpu")
    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), spec)
    store = generate_synthetic_multiview(spec, str(tmp_path / "mv.h5"), n_samples=10, n_views=2,
                                         resolution=RES, device="cpu")
    tiny = [s for s in TINY if not s.startswith(("model.input_resolution", "training.batch_size"))]
    common = ["--model", pkl, "--data-path", store, "--set", *tiny, *MV, "training.batch_size=4",
              "dataset.train_ratio=0.5", "dataset.val_ratio=0.4", "dataset.test_ratio=0.1"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_train(["--epochs", "1", "--output-dir", str(jdir)] + common)
    convert_checkpoint(jdir, tdir, "final_model", RES)
    resume = ["--epochs", "2", "--resume", "final_model"]
    jstate = j_train(resume + ["--output-dir", str(jdir)] + common)
    tstate = t_train(resume + ["--output-dir", str(tdir), "--device", "cpu"] + common)
    assert len(tstate.history) == len(jstate.history) == 2 and "val_loss" in jstate.history[-1]
    assert_same_epoch(tstate.history[-1], jstate.history[-1])
    names = {p.name.removesuffix(".pt") for p in tdir.glob("*.pt")}
    improved = jstate.history[-1]["val_loss"] < jstate.history[0]["val_loss"]
    assert names == {"epoch_1", "final_model"} | ({"best_model"} if improved else set())
