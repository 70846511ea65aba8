"""The multi-view driver (``drivers/multiview_train.py``) rehearsed on the CPU
at its own tiny size (``MULTIVIEW_TINY`` below: ViT-B/16 at 32², 4 frames of
4 view slots a step): a sound run is ``correct`` under the limits the cell
commits, each of its faults is not, and a seed gives the same inputs every
time. It writes no result and times nothing worth reading.

``portbench/conftest.py`` enters these sizes in ``portbench/tests/conftest.py``'s
``TINY`` and ``TINY_PARAMS``; pytest imports it before any test under
``portbench/`` runs, so ``test_portbench_faults.py``'s cases over every
cell of ``BENCHMARK.json`` find them too
(:func:`test_every_listed_cell_has_its_tiny_size`)."""

from __future__ import annotations

import pytest

from portbench import harness, inputs_mv
from portbench.drivers import multiview_train
from portbench.tests import conftest as tests_conftest
from portbench.tests.conftest import tiny_cell
from portbench.tests.test_portbench_drivers import rehearse

CELL = "train_mv4_vitl_b32"

# SMILify's multi-view regressor at ViT-B/16's published widths (the port
# builds its ViTs by name) at 32², 2 × 2 patch tokens a view, a decoder of
# 32 × 2 × 2 iterations, a 10²-vertex mesh, 4 frames of 4 views a step from
# a cache of 8
MULTIVIEW_TINY = {
    "training_config": {
        "mode": "multi_view",
        "model": {"backbone_name": "vit_base_patch16_224", "head_type": "transformer_decoder",
                  "transformer_depth": 2, "transformer_heads": 2, "transformer_dim_head": 16,
                  "transformer_mlp_dim": 48, "transformer_ief_iters": 2,
                  "freeze_backbone": False, "backbone_lr_multiplier": 0.1},
        "multiview": {"num_views_to_use": 4, "num_canonical_cameras": 18,
                      "cross_attention_heads": 2, "cross_attention_layers": 2},
        "optimizer": {"optimizer_type": "adamw", "learning_rate": 5e-05, "weight_decay": 0.0001,
                      "gradient_clip_norm": 1.0},
        "training": {"batch_size": 4, "use_gt_camera_init": True, "use_mixed_precision": False},
        "scale_trans_beta": {"mode": "ignore"},
    },
    "vit": {"depth": 12, "dim": 768, "heads": 12, "mlp": 3072, "patch": 16},
    "head": {"dim": 32, "depth": 2, "heads": 2, "mlp": 48, "iters": 2},
    "fusion": {"heads": 2, "layers": 2},
    "image_size": 32,
    "model": {"kind": "smil_procedural", "V_side": 10, "J": 6, "B": 3},
    "backbone_dtype": "float32",
    "cache_samples": 8,
}

# every frame with two views of four, so that the masks weigh in a batch of two
MULTIVIEW_TINY_PARAMS = {"check_steps": 2, "warmup_steps": 1, "trace_steps": 2,
                         "views_present": [[2, 1.0]]}


def test_every_listed_cell_has_its_tiny_size():
    names = [w["name"] for w in harness.manifest()["workloads"]]
    assert CELL in names
    assert tests_conftest.TINY["vitl16_ief512_mv4_224"] == MULTIVIEW_TINY
    assert tests_conftest.TINY_PARAMS["multiview_train"] == MULTIVIEW_TINY_PARAMS
    for name in names:
        assert tiny_cell(name)["config_data"]


def test_sound_run_is_correct_on_the_cpu():
    out = rehearse(CELL)
    ok, checks = harness.judge(out.numbers, tiny_cell(CELL)["limits"])
    assert ok, checks
    assert out.attempted > 0 and out.setup_s > 0 and out.memory_peak_bytes == 0
    assert out.rate["train_images_per_s"] > 0
    w = out.obs["window"]
    assert w["items"] == w["steps"] * 4 * 4                # frames × view slots
    assert out.obs["work"]["flops_per_item"] > 0


@pytest.mark.parametrize("fault", sorted(multiview_train.FAULTS))
def test_each_fault_makes_the_run_incorrect(fault):
    out = rehearse(CELL, readings_only=True, fault=fault)
    ok, checks = harness.judge(out.numbers, tiny_cell(CELL)["limits"])
    assert not ok, checks


def test_backbone_grad_spread_takes_out_a_common_factor():
    ref = {"grad": {"backbone.a": 2.0, "backbone.b": 5.0, "backbone.c": 3.0,
                    "camera_head.d": 4.0, "view_embeddings": 0.1}}
    scaled = {"grad": {k: 1.3 * g for k, g in ref["grad"].items()}}
    assert multiview_train.backbone_grad_spread(scaled, ref) == pytest.approx(0.0, abs=1e-12)
    apart = {"grad": dict(scaled["grad"], **{"backbone.c": 1.1 * scaled["grad"]["backbone.c"]})}
    assert multiview_train.backbone_grad_spread(apart, ref) > 0.04


@pytest.mark.parametrize("lower", ["vit", "head"])
def test_each_control_gives_every_number(lower):
    cell = tiny_cell(CELL)
    r = harness.Run(cell=cell, seed=2**31 + 5, seconds=0.0, trace=False, t0=0.0, device="cpu",
                    readings_only=True)
    numbers = multiview_train.control_numbers(r, lower)
    assert set(cell["limits"]) <= set(numbers)
    assert all(v == v for v in numbers.values())        # no NaN
    assert numbers["head_out_gap"] < 1e-5               # the CPU has no TF32


def test_same_seed_same_inputs():
    cell = tiny_cell(CELL)
    a, b = (inputs_mv.multiview_inputs(cell["config_data"], cell["params"], 2**31 + 9, "cpu")
            for _ in range(2))
    assert all((a["weights"][k] == b["weights"][k]).all() for k in a["weights"])
    assert all((a["frames"].cols[k] == b["frames"].cols[k]).all() for k in a["frames"].cols)
    c = inputs_mv.multiview_inputs(cell["config_data"], cell["params"], 2**31 + 10, "cpu")
    assert (c["frames"].cols["images"] != a["frames"].cols["images"]).any()
    # every frame has 2-4 distinct cameras of the rig and its first views present
    cols = a["frames"].cols
    assert all(len(set(ids)) == len(ids) for ids in cols["camera_indices"])
    present = cols["view_mask"].sum(1)
    assert ((present >= 2) & (present <= 4)).all()
    assert (cols["view_mask"] == (cols["view_mask"].cumprod(1) > 0)).all()
    assert (cols["images"][~cols["view_mask"]] == 0).all()
    assert (cols["keypoint_visibility"][~cols["view_mask"]] == 0).all()
