"""Rules of the PyTorch port that hold without a card.

* No module of ``smilify_tpu_torch``, no script of ``scripts/`` and not
  ``chip_smoke.py`` imports JAX, Flax, Optax or anything of the JAX package
  ``smilify_tpu`` (importing any of its modules runs its ``__init__``,
  which imports JAX).
* At module level they import only what the card's machine has: the
  standard library, numpy, scipy, torch and the port itself (imageio, cv2,
  matplotlib and yaml only inside the functions that the card never calls).
* An entry point given no device runs on ``cuda`` or raises; it never falls
  back to the CPU on its own.
* Every module of the port imports.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import ast
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smilify_tpu")
# what the card's machine has, besides the standard library
CARD_PACKAGES = {"numpy", "scipy", "torch", "smilify_tpu_torch"}


def _port_files():
    files = (sorted((REPO / "smilify_tpu_torch").rglob("*.py"))
             + sorted((REPO / "scripts").glob("*.py")) + [REPO / "chip_smoke.py"])
    return [f for f in files if f.exists()]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def _module_level_roots(path):
    """Roots of the imports that run when ``path`` is imported: those outside
    any function body (class bodies and ``if``/``try`` blocks included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        stack.extend(ast.iter_child_nodes(node))


def _card_allowed(files):
    local = {f.stem for f in files}          # chip_smoke, the scripts importing each other
    return set(sys.stdlib_module_names) | CARD_PACKAGES | local | {"__future__"}


def test_scans_cover_every_port_module():
    files = [f.relative_to(REPO).with_suffix("") for f in _port_files()]
    modules = [".".join(f.parts) for f in files if f.parts[0] == "smilify_tpu_torch"]
    assert "smilify_tpu_torch.train.trainer" in modules and "smilify_tpu_torch.cli.sleap_tools" in modules
    for m in modules:
        importlib.import_module(m.removesuffix(".__init__"))


def test_port_imports_only_the_cards_packages_at_module_level():
    files = _port_files()
    allowed = _card_allowed(files)
    bad = [(f.relative_to(REPO).as_posix(), root) for f in files
           for root in _module_level_roots(f) if root not in allowed]
    assert bad == []


def test_module_level_scan_sees_a_stray_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nimport numpy as np\nimport cv2\n"
                 "try:\n    from yaml import safe_load\nexcept ImportError:\n    pass\n"
                 "class A:\n    import imageio\n"
                 "def f():\n    import matplotlib\n")
    roots = set(_module_level_roots(p))
    assert roots == {"os", "numpy", "cv2", "yaml", "imageio"}
    assert roots - _card_allowed([p]) == {"cv2", "yaml", "imageio"}


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10 and files[-1].name == "chip_smoke.py"
    bad = [(f.relative_to(REPO).as_posix(), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom smilify_tpu.core import spec\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert {"smilify_tpu", "jax"} <= set(_imported_roots(p))


def test_entry_points_raise_without_cuda(monkeypatch):
    from smilify_tpu_torch import bench
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter import FitData, SmalFitter, params_from_numpy
    from smilify_tpu_torch.fitter.fitter_batch import BatchedFitter
    from smilify_tpu_torch.fitter.progressive import ProgressiveFitter
    from smilify_tpu_torch.render.cameras import default_camera
    from smilify_tpu_torch.render.rasterizer import auto_approx_max_faces
    from smilify_tpu_torch.cli import optimise_3d, optimize_corpus, optimize_to_joints, sdf_batch
    from smilify_tpu_torch.fitter.fitter3d import fit3d_params_from_numpy, pad_target_meshes
    from smilify_tpu_torch.tools import bench_all, bench_corpus, bench_progressive
    from smilify_tpu_torch.cli import dataset_viewer
    from smilify_tpu_torch.data.synthetic import generate_synthetic_multiview, synthesize_multiview
    from smilify_tpu_torch.train.trainer import DeviceDataCache

    spec = toy_model_spec(device="cpu")
    data = FitData(rgb=None, sil=torch.zeros((1, 32, 32)), joints=torch.zeros((1, 6, 2)),
                   visibility=torch.ones((1, 6)))
    clips = FitData(rgb=None, sil=torch.zeros((2, 1, 32, 32)), joints=torch.zeros((2, 1, 6, 2)),
                    visibility=torch.ones((2, 1, 6)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: toy_model_spec(),
        lambda: default_camera(),
        lambda: SmalFitter(spec, data, (32, 32)),
        lambda: BatchedFitter(spec, clips, (32, 32)),
        lambda: ProgressiveFitter(spec, data, (32, 32), scales=(1, 2)),
        lambda: auto_approx_max_faces((512, 512)),
        lambda: params_from_numpy({k: np.zeros(1) for k in
                                   ("global_rot", "joint_rot", "betas", "trans", "fov",
                                    "log_beta_scales", "joint_trans")}),
        lambda: bench.load_spec(),
        lambda: bench.main([]),
        lambda: bench_all.main([]),
        lambda: bench_all.measure_fp32_fma_peak_gflops(),
        lambda: bench_corpus.main([]),
        lambda: bench_progressive.main([]),
        lambda: optimize_to_joints.main(["--model", "m.pkl"]),
        lambda: optimize_corpus.main(["--model", "m.pkl", "--all-replicant"]),
        lambda: optimise_3d.main(["--model", "m.pkl", "--mesh_dir", ".", "--yaml_src", "c.yaml"]),
        lambda: sdf_batch.main(["--mesh_dir", "."]),
        lambda: bench_all.main(["--only", "config2", "--target-obj", "t.obj"]),
        lambda: pad_target_meshes([(np.zeros((3, 3)), np.zeros((1, 3), int))]),
        lambda: fit3d_params_from_numpy({k: np.zeros(1) for k in
                                         ("global_rot", "joint_rot", "betas", "trans",
                                          "log_beta_scales", "betas_trans", "deform_verts")}),
        lambda: synthesize_multiview(spec, 2),
        lambda: generate_synthetic_multiview(spec, "s.h5", 2),
        lambda: DeviceDataCache([{"x": np.zeros(2, np.float32)}]),
        lambda: dataset_viewer.main(["--dataset", "d.h5"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, the same entry points run there
    assert SmalFitter(spec, data, (32, 32), device="cpu").device.type == "cpu"
    assert BatchedFitter(spec, clips, (32, 32), device="cpu").n_seqs == 2
    assert ProgressiveFitter(spec, data, (32, 32), device="cpu").fitter.device.type == "cpu"
    assert len(synthesize_multiview(spec, 2, 2, 32, device="cpu")) == 2
    assert DeviceDataCache([{"x": np.zeros(2, np.float32)}], device="cpu").n == 1
    # the FP32 peak is the card's: no CPU stand-in
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_all.measure_fp32_fma_peak_gflops(device="cpu")


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The regressors' serving path: the CLIs, the checkpoint loader and
    bench_all's configs 4, 5a and 5b default to the card and raise without
    one; asked for the CPU, the loader runs there."""
    from smilify_tpu_torch.cli import benchmark_model, run_inference
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.models.weight_port import build_model
    from smilify_tpu_torch.tools import bench_all
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.train.config import load_config, resolve_model_spec
    from smilify_tpu_torch.train.trainer import TrainState, save_checkpoint

    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), toy_model_spec(device="cpu"))
    cfg = load_config(None, overrides={"smal_model.smal_file": pkl, "model.backbone_name": "unet_micro",
                                       "model.input_resolution": 32})
    model = build_model(cfg.regressor_config(resolve_model_spec(cfg, device="cpu")), img_size=32)
    ckpt = save_checkpoint(str(tmp_path), TrainState(model.state_dict()), cfg, "final_model")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: run_inference.main(["--checkpoint", ckpt, "--data-path", str(tmp_path)]),
        lambda: benchmark_model.main(["--checkpoint", ckpt, "--dataset-path", str(tmp_path)]),
        lambda: run_inference.load_model_from_checkpoint(ckpt),
        lambda: bench_all.main(["--only", "config4", "config5"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    loaded = run_inference.load_model_from_checkpoint(ckpt, device="cpu")[0]
    assert next(loaded.parameters()).device.type == "cpu"


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The trainers, bench_all's train-step configs and the input-pipeline
    bench default to the card and raise without one, before they touch
    their data."""
    from smilify_tpu_torch.cli import train_multiview, train_pointnet, train_regressor
    from smilify_tpu_torch.tools import bench_all, bench_input_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = ["--model", str(tmp_path / "m.pkl"), "--data-path", str(tmp_path)]
    calls = [
        lambda: train_regressor.main(data),
        lambda: train_multiview.main(data),
        lambda: train_pointnet.main(["--model", str(tmp_path / "m.pkl")]),
        lambda: bench_all.main(["--only", "config4b", "config4c", "config5c"]),
        lambda: bench_input_pipeline.main(["--work", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not any(tmp_path.iterdir())


def test_scale_out_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Serving export and its loader, the sharded fitters and the multi-rank
    harness default to the card and raise without one, before they write
    anything; the sharded fitters in one process run on the CPU when asked."""
    from smilify_tpu_torch import serve
    from smilify_tpu_torch.cli import export_serving
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter import FitData
    from smilify_tpu_torch.fitter.fitter_batch import GridShardedFitter, ShardedBatchedFitter
    from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter
    from smilify_tpu_torch.train import multidevice

    spec = toy_model_spec(device="cpu")
    data = FitData(rgb=None, sil=torch.zeros((2, 32, 32)), joints=torch.zeros((2, 6, 2)),
                   visibility=torch.ones((2, 6)))
    clips = FitData(rgb=None, sil=torch.zeros((2, 2, 32, 32)), joints=torch.zeros((2, 2, 6, 2)),
                    visibility=torch.ones((2, 2, 6)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt, out = str(tmp_path / "final_model"), str(tmp_path / "a.pt2z")
    calls = [
        lambda: export_serving.main(["--checkpoint", ckpt, "--output", out]),
        lambda: serve.export_serving_artifact(ckpt, out),
        lambda: multidevice.main([]),
        lambda: multidevice.run_trainer_check(),
        lambda: multidevice.dryrun_multichip(),
        lambda: serve.load_serving_artifact(out),
        lambda: serve.ServingModel(out),
        lambda: ShardedSequenceFitter(spec, data, (32, 32)),
        lambda: ShardedBatchedFitter(spec, clips, (32, 32)),
        lambda: GridShardedFitter(spec, clips, (32, 32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not any(tmp_path.iterdir())
    assert ShardedSequenceFitter(spec, data, (32, 32), device="cpu").n_frames == 2
    assert GridShardedFitter(spec, clips, (32, 32), device="cpu").n_local == (2, 2)
