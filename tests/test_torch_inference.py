"""The regressors' serving path in the port, held to the JAX package on the CPU.

* the training config's round trip and its regressor configs;
* checkpoints (``<name>.pt`` beside the JAX package's ``<name>.meta.json``)
  and ``discover_checkpoint``'s order (as tests/test_checkpoint_conventions.py);
* ``StagingCollator``'s ring, its fallback and its device copy;
* the dataset splits: the same indices as the JAX package's;
* ``BenchmarkAccumulator``: the same PCK curve, MPJPE statistics, report
  and error arrays as the JAX package's;
* ``PredictionSmoother`` and ``AnimationRecorder`` against the JAX package's;
* the slice as a whole: the JAX ``cli/run_inference.py`` on an orbax
  checkpoint of seeded ``unet_micro`` variables against the port's
  ``run_inference`` on the converted checkpoint, on the same replicAnt
  folder (single-view) and HDF5 store (multi-view): ``predictions.npz``,
  the smoothed trajectory and the animation file within 2e-5 ×
  max(1, max |JAX|) (tests/test_torch_models.py's model tolerance: both
  compute in float32); ``benchmark_model --split test`` gives the same
  PCK curve within 1e-6 and the same MPJPE statistics within 2e-4 relative
  (millimetres from float32 joints).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.train import benchmark as jbench
from smilify_tpu.train import config as jconfig
from smilify_tpu.train import trainer as jtrainer
from smilify_tpu.utils import animation_export as janim

from smilify_tpu_torch import serve
from smilify_tpu_torch.cli import benchmark_model as t_benchmark_model
from smilify_tpu_torch.cli import run_inference as t_run_inference
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.data.synthetic import generate_synthetic_multiview
from smilify_tpu_torch.models.weight_port import state_dict_from_flax
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
from smilify_tpu_torch.train import benchmark as tbench
from smilify_tpu_torch.train import config as tconfig
from smilify_tpu_torch.train import trainer as ttrainer
from smilify_tpu_torch.utils import animation_export as tanim
from tests.test_torch_models import MODEL_TOL, assert_close, random_variables

PCK_TOL, MPJPE_RTOL = 1e-6, 2e-4
RES = 32


# ---------------------------------------------------------------------------
# config and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["single_view", "multi_view"])
@pytest.mark.parametrize("mixed", [False, True])
def test_config_round_trip_and_regressor_config(mode, mixed, tmp_path):
    over = {"model.backbone_name": "unet_micro", "training.use_mixed_precision": mixed,
            "scale_trans_beta.mode": "separate", "optimizer.lr_schedule": {"5": 1e-5}}
    t = tconfig.load_config(None, overrides=over, mode=mode)
    j = jconfig.load_config(None, overrides=over, mode=mode)
    assert t.to_dict() == j.to_dict()
    t.save(str(tmp_path / "c.json"))
    back = tconfig.load_config(str(tmp_path / "c.json"), mode=mode)
    assert back.to_dict() == jconfig.load_config(str(tmp_path / "c.json"), mode=mode).to_dict()
    assert back.model.backbone_name == "unet_micro" and back.optimizer.lr_schedule == {5: 1e-5}
    spec = toy_model_spec(device="cpu")
    trc, jrc = t.regressor_config(spec), j.regressor_config(spec)
    assert type(trc).__name__ == type(jrc).__name__
    tf, jf = vars(trc), vars(jrc)
    assert tf.pop("compute_dtype") == (torch.bfloat16 if mixed else torch.float32)
    assert jf.pop("compute_dtype") == (jnp.bfloat16 if mixed else jnp.float32)
    assert tf == jf
    assert t.get_loss_weights_for_epoch(7) == j.get_loss_weights_for_epoch(7)
    assert t.get_learning_rate_for_epoch(7) == j.get_learning_rate_for_epoch(7)


def test_checkpoint_round_trip_and_meta(tmp_path):
    cfg = tconfig.load_config(None, overrides={"model.backbone_name": "unet_micro"})
    sd = {"w": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    state = ttrainer.TrainState(sd, epoch=4, step=40, history=[{"epoch": i} for i in range(60)])
    path = ttrainer.save_checkpoint(str(tmp_path), state, cfg, name="best_model")
    assert path == str(tmp_path / "best_model")
    payload, meta = ttrainer.load_checkpoint(path)
    assert torch.equal(payload["model"]["w"], sd["w"]) and payload["opt_state"] is None
    assert meta["epoch"] == 4 and meta["step"] == 40 and len(meta["history"]) == 50
    assert meta["config"] == json.loads(json.dumps(cfg.to_dict(), default=str))
    assert tconfig.config_from_dict(meta["config"]).model == cfg.model
    assert serve.discover_checkpoint(str(tmp_path)) == path


def test_checkpoint_discovery_order(tmp_path):
    """As tests/test_checkpoint_conventions.py::test_checkpoint_discovery_order."""
    discover = serve.discover_checkpoint
    run = tmp_path / "run"
    run.mkdir()

    def mk(name):
        (run / f"{name}.pt").write_bytes(b"")
        (run / f"{name}.meta.json").write_text("{}")

    mk("epoch_3")
    mk("epoch_10")
    assert discover(str(run)) == str(run / "epoch_10")
    mk("final_model")
    assert discover(str(run)) == str(run / "final_model")
    mk("best_model")
    assert discover(str(run)) == str(run / "best_model")
    assert discover(str(run / "epoch_3")) == str(run / "epoch_3")
    nested = tmp_path / "nested" / "checkpoints"
    nested.mkdir(parents=True)
    (nested / "final_model.meta.json").write_text("{}")
    assert discover(str(tmp_path / "nested")) == str(nested / "final_model")


# ---------------------------------------------------------------------------
# staging, splits, benchmark accumulator, smoothing, animation
# ---------------------------------------------------------------------------


def _samples(rng, n, shape=(4, 4, 3)):
    return [{"image": rng.random(shape, dtype=np.float32), "idx": np.int64(i),
             "mask": rng.random(2) > 0.5} for i in range(n)]


def test_staging_collator_ring_and_fallback():
    rng = np.random.default_rng(0)
    staging = ttrainer.StagingCollator(depth=2)
    batches = [_samples(rng, 3) for _ in range(3)]
    out = [staging(b) for b in batches]
    for b, o in zip(batches[1:], out[1:]):
        np.testing.assert_array_equal(o["image"].numpy(), np.stack([s["image"] for s in b]))
        np.testing.assert_array_equal(o["mask"].numpy(), np.stack([s["mask"] for s in b]))
        assert o["idx"].dtype == torch.int64 and o["mask"].dtype == torch.bool
    assert out[0] is out[2] and out[0] is not out[1]          # a ring of two slots
    ragged = staging(_samples(rng, 2))                         # a short last batch: fresh tensors
    assert ragged["image"].shape == (2, 4, 4, 3) and ragged is not out[1]
    dev = staging.to_device(out[1], "cpu")
    assert torch.equal(dev["image"], out[1]["image"])


@pytest.mark.parametrize("n,seed", [(10, 0), (101, 1234), (7, 5)])
def test_splits_match_jax(n, seed):
    ratios = (0.7, 0.2, 0.1)
    for a, b in zip(ttrainer.split_dataset(n, ratios, seed), jtrainer.split_dataset(n, ratios, seed)):
        np.testing.assert_array_equal(a, b)
    groups = np.random.default_rng(seed).integers(0, 4, n)
    for fn in ("split_dataset_grouped", "split_dataset_per_group"):
        for a, b in zip(getattr(ttrainer, fn)(groups, ratios, seed),
                        getattr(jtrainer, fn)(groups, ratios, seed)):
            np.testing.assert_array_equal(a, b)
    sub = ttrainer.SubsetDataset(list(range(100, 100 + n)), [2, 0])
    assert len(sub) == 2 and sub[0] == 102 and sub.epoch is None


def test_benchmark_accumulator_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    t, j = tbench.BenchmarkAccumulator(), jbench.BenchmarkAccumulator()
    for _ in range(3):
        pred, gt = rng.random((4, 3, 7, 2)), rng.random((4, 3, 7, 2))
        vis = (rng.random((4, 3, 7)) > 0.3).astype(np.float32)
        native = rng.integers(100, 400, (4, 3, 2))
        p3, g3, valid = rng.random((4, 7, 3)), rng.random((4, 7, 3)), rng.random((4, 7)) > 0.2
        for acc in (t, j):
            acc.add_2d(pred, gt, vis, 64, native)
            acc.add_3d(p3, g3, valid)
    for which in ("input", "native"):
        assert t.pck_curve(which) == j.pck_curve(which)
    assert t.mpjpe_stats() == j.mpjpe_stats()
    rt = t.write_report(str(tmp_path / "t"), "bench")
    rj = j.write_report(str(tmp_path / "j"), "bench")
    assert rt == rj
    for f in ("pixel_errors_input.npy", "pixel_errors_native.npy", "mpjpe_mm.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f))
    assert tbench.detect_model_type_from_params({"view_embeddings.weight": 0}) == "multi_view"
    assert tbench.detect_model_type_from_params({"head.init_estimate": 0}) == "single_view"


def test_smoother_and_animation_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    n, P = 9, 4
    mats = np.asarray(torch.linalg.matrix_exp(torch.as_tensor(
        np.einsum("nk,kij->nij", rng.standard_normal((n, 3)) * 0.3,
                  np.float64([[[0, 0, 0], [0, 0, -1], [0, 1, 0]], [[0, 0, 1], [0, 0, 0], [-1, 0, 0]],
                              [[0, -1, 0], [1, 0, 0], [0, 0, 0]]])))), np.float32)
    traj = {"global_rot": (rng.standard_normal((n, 3)) * 0.5).astype(np.float32),
            "joint_rot": (rng.standard_normal((n, P, 3)) * 0.3).astype(np.float32),
            "trans": rng.standard_normal((n, 3)).astype(np.float32),
            "betas": rng.standard_normal((n, 3)).astype(np.float32),
            "cam_rot": mats, "fov": (60 + rng.standard_normal(n)).astype(np.float32)}
    keys = ["global_rot", "joint_rot", "trans", "cam_rot", "fov"]
    ts, js = tanim.PredictionSmoother(3).smooth_params(traj, keys), \
        janim.PredictionSmoother(3).smooth_params(traj, keys)
    for k in traj:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-6, err_msg=k)
    for mod, name in ((tanim, "t"), (janim, "j")):
        rec = mod.AnimationRecorder(model_name="toy", fps=15.0)
        for i in range(n):
            rot = traj["joint_rot"][i] if i % 3 else traj["cam_rot"][i][None].repeat(P, 0)
            rec.add_frame(traj["global_rot"][i], rot, traj["trans"][i], betas=traj["betas"][i])
        rec.export(str(tmp_path / name))
    (td, tside), (jd, jside) = tanim.load_animation(str(tmp_path / "t.npz")), \
        janim.load_animation(str(tmp_path / "j.npz"))
    assert sorted(td) == sorted(jd)
    for k in jd:
        if jd[k].dtype.kind == "f":
            np.testing.assert_allclose(td[k], jd[k], atol=2e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(td[k], jd[k])
    tside.pop("exported"), jside.pop("exported")
    assert tside == jside


# ---------------------------------------------------------------------------
# the slice: the JAX CLIs on orbax checkpoints against the port's on converted ones
# ---------------------------------------------------------------------------


def _overrides(pkl, mode):
    return {"smal_model.smal_file": pkl, "model.backbone_name": "unet_micro",
            "model.input_resolution": RES, "model.transformer_depth": 1,
            "model.transformer_heads": 2, "model.transformer_dim_head": 8,
            "model.transformer_mlp_dim": 16, "multiview.num_views_to_use": 3,
            "multiview.cross_attention_heads": 2, "multiview.cross_attention_layers": 1,
            "training.use_mixed_precision": False}


def _checkpoints(tmp_path, pkl, mode):
    """An orbax checkpoint of seeded JAX variables and the port's checkpoint
    converted from it, in ``tmp_path/jax`` and ``tmp_path/port``."""
    from smilify_tpu.models.multiview import MultiViewSMILRegressor
    from smilify_tpu.models.regressor import SMILRegressor

    cfg = jconfig.load_config(None, overrides=_overrides(pkl, mode), mode=mode)
    jspec = jconfig.resolve_model_spec(cfg)
    rcfg = cfg.regressor_config(jspec)
    if mode == "multi_view":
        V = rcfg.max_views
        v = random_variables(MultiViewSMILRegressor(rcfg), jnp.zeros((1, V, RES, RES, 3)),
                             jnp.ones((1, V), bool), jnp.zeros((1, V), jnp.int32), seed=3)
    else:
        v = random_variables(SMILRegressor(rcfg), jnp.zeros((1, RES, RES, 3)), seed=3)
    state = jtrainer.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                opt_state={"m": np.zeros(2, np.float32)}, epoch=1)
    jtrainer.save_checkpoint(str(tmp_path / "jax"), state, cfg, name="final_model")
    with open(tmp_path / "jax" / "final_model.meta.json") as f:
        tcfg = tconfig.config_from_dict(json.load(f)["config"])
    tspec = tconfig.resolve_model_spec(tcfg, device="cpu")
    sd = state_dict_from_flax(v, tcfg.regressor_config(tspec), img_size=RES)
    ttrainer.save_checkpoint(str(tmp_path / "port"), ttrainer.TrainState(sd, epoch=1), tcfg,
                             name="final_model")


def _compare_npz(a, b):
    za, zb = dict(np.load(a)), dict(np.load(b))
    assert sorted(za) == sorted(zb)
    for k in zb:
        if zb[k].dtype.kind == "f":
            assert_close(za[k], zb[k], MODEL_TOL, k)
        else:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    spec = toy_model_spec(8, 6, 3, device="cpu")
    return spec, write_model_pkl(str(root / "toy.pkl"), spec)


def test_singleview_run_inference_matches_jax(tmp_path, toy):
    from smilify_tpu.cli.run_inference import main as j_run_inference

    spec, pkl = toy
    folder, names = write_replicant_sequence(str(tmp_path / "seq"), spec, 5, RES, layout="unreal")
    _checkpoints(tmp_path, pkl, "single_view")
    common = ["--data-path", folder, "--smooth-window", "3", "--batch-size", "2"]
    jtraj = j_run_inference(["--checkpoint", str(tmp_path / "jax" / "final_model"),
                             "--export-animation", str(tmp_path / "j_anim")] + common)
    ttraj = t_run_inference.main(["--checkpoint", str(tmp_path / "port" / "final_model"),
                                  "--export-animation", str(tmp_path / "t_anim"),
                                  "--render-dir", str(tmp_path / "frames"), "--device", "cpu"] + common)
    assert sorted(ttraj) == sorted(jtraj) and len(ttraj["global_rot"]) == 5
    for k in jtraj:
        assert_close(ttraj[k], jtraj[k], MODEL_TOL, f"smoothed {k}")
    _compare_npz(tmp_path / "port" / "predictions.npz", tmp_path / "jax" / "predictions.npz")
    _compare_npz(tmp_path / "t_anim.npz", tmp_path / "j_anim.npz")
    assert sorted(os.listdir(tmp_path / "frames")) == [f"frame_{i:05d}.png" for i in range(5)]


def test_multiview_run_inference_and_benchmark_match_jax(tmp_path, toy):
    pytest.importorskip("h5py")
    from smilify_tpu.cli.benchmark_model import main as j_benchmark_model
    from smilify_tpu.cli.run_inference import main as j_run_inference

    spec, pkl = toy
    store = generate_synthetic_multiview(spec, str(tmp_path / "mv.h5"), n_samples=10, n_views=3,
                                         resolution=RES, device="cpu")
    _checkpoints(tmp_path, pkl, "multi_view")
    j_run_inference(["--checkpoint", str(tmp_path / "jax" / "final_model"), "--data-path", store])
    t_run_inference.main(["--checkpoint", str(tmp_path / "port" / "final_model"), "--data-path", store,
                          "--render-dir", str(tmp_path / "frames"), "--device", "cpu"])
    _compare_npz(tmp_path / "port" / "predictions.npz", tmp_path / "jax" / "predictions.npz")
    assert len(os.listdir(tmp_path / "frames")) == 10
    split = ["--dataset-path", store, "--split", "test", "--split-ratios", "0.5,0.2,0.3"]
    jacc = j_benchmark_model(["--checkpoint", str(tmp_path / "jax" / "final_model"),
                              "--output-dir", str(tmp_path / "jb")] + split)
    tacc = t_benchmark_model.main(["--checkpoint", str(tmp_path / "port" / "final_model"),
                                   "--output-dir", str(tmp_path / "tb"), "--device", "cpu"] + split)
    jcurve, tcurve = jacc.pck_curve("input"), tacc.pck_curve("input")
    assert sorted(tcurve) == sorted(jcurve) and jcurve
    np.testing.assert_allclose([tcurve[k] for k in sorted(tcurve)],
                               [jcurve[k] for k in sorted(jcurve)], atol=PCK_TOL)
    js, ts = jacc.mpjpe_stats(), tacc.mpjpe_stats()
    assert ts["n"] == js["n"] > 0
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=MPJPE_RTOL, err_msg=k)


def test_singleview_benchmark_on_a_multiview_store(tmp_path, toy):
    """The single-view-from-multiview path: a single-view checkpoint on a
    multi-view store reads every view as an item, split by sample."""
    pytest.importorskip("h5py")
    from smilify_tpu.cli.benchmark_model import main as j_benchmark_model

    spec, pkl = toy
    store = generate_synthetic_multiview(spec, str(tmp_path / "mv.h5"), n_samples=6, n_views=2,
                                         resolution=RES, device="cpu")
    _checkpoints(tmp_path, pkl, "single_view")
    split = ["--dataset-path", store, "--split", "train"]
    jacc = j_benchmark_model(["--checkpoint", str(tmp_path / "jax" / "final_model"),
                              "--output-dir", str(tmp_path / "jb")] + split)
    tacc = t_benchmark_model.main(["--checkpoint", str(tmp_path / "port" / "final_model"),
                                   "--output-dir", str(tmp_path / "tb"), "--device", "cpu"] + split)
    for a, b in zip(tacc.pixel_errors_input, jacc.pixel_errors_input):
        assert_close(a, b, MODEL_TOL, "pixel errors")
    assert len(tacc.pixel_errors_input) == len(jacc.pixel_errors_input) > 0
