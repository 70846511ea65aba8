"""Rules of the PyTorch port that hold without a card.

* No module of ``smilify_tpu_torch``, no script of ``scripts/`` and not
  ``chip_smoke.py`` imports JAX, Flax, Optax or anything of the JAX package
  ``smilify_tpu`` (importing any of its modules runs its ``__init__``,
  which imports JAX).
* An entry point given no device runs on ``cuda`` or raises; it never falls
  back to the CPU on its own.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smilify_tpu")


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
    from smilify_tpu_torch.tools import bench_all, bench_corpus, bench_progressive

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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, the same entry points run there
    assert SmalFitter(spec, data, (32, 32), device="cpu").device.type == "cpu"
    assert BatchedFitter(spec, clips, (32, 32), device="cpu").n_seqs == 2
    assert ProgressiveFitter(spec, data, (32, 32), device="cpu").fitter.device.type == "cpu"
    # the FP32 peak is the card's: no CPU stand-in
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_all.measure_fp32_fma_peak_gflops(device="cpu")
