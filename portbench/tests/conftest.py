"""The benchmark's own tests. Tests that need a card carry the ``card``
marker and decide about the card in the ``card`` fixture, when they run."""

from __future__ import annotations

import json

import pytest

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: python -m pytest portbench/tests -m card")
    return torch.device("cuda", 0)


# the cells cut to a size the CPU runs in seconds: a 12²-vertex mesh, 64²
# frames and a cap of 24 faces; ResNet-50 at 32² in float32 on a cache of 16
# samples, 4 to a batch (fewer leave its last BatchNorms, over 1×1 maps,
# normalizing two numbers, where rounding decides the result)
TINY = {
    "smil_stick_fit512": {"model": {"kind": "smil_procedural", "V_side": 12, "J": 6, "B": 3},
                          "image_size": [64, 64]},
    "resnet50_ief_sv224": {"model": {"kind": "smil_procedural", "V_side": 8, "J": 6, "B": 3},
                           "image_size": 32, "cache_samples": 16, "backbone_dtype": "float32"},
}
TINY_PARAMS = {"fit_sequence": {"frames": 4, "approx_max_faces": 24, "chunk": 5, "trace_steps": 5},
               "regressor_train": {"batch": 4},
               "regressor_infer": {"batch": 4}}


def tiny_cell(name: str) -> dict:
    """The cell ``name`` (its file; BENCHMARK.json need not list it), its
    limits as committed, at the tiny size."""
    cell = json.loads((harness.HERE / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["config_data"] = json.loads(
        (harness.HERE / "configs" / f"{cell['config']}.json").read_text())
    cell["config_data"] = dict(cell["config_data"], **TINY[cell["config"]])
    if cell["driver"] == "fit_sequence":
        stages = [list(s) for s in cell["config_data"]["stages"]]
        stages[cell["params"]["stage"]][7] = 20          # whole stages of 4 chunks
        cell["config_data"]["stages"] = stages
    cell["params"] = dict(cell["params"], **TINY_PARAMS[cell["driver"]])
    if cell["chips"] > 1:
        cell["params"]["batch"] = 2          # a rank's rows: a global batch of 8
    return json.loads(json.dumps(cell))
