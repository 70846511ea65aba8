"""Each driver end to end on the CPU at a tiny size, through the harness:
a rehearsal of the control flow. It writes no result (a result comes only
from a run on the card) and its times are no measurements."""

from __future__ import annotations

import time

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell

ONE_CARD = ["fit_sil_seq64", "train_sv_b128", "infer_sv_b128"]


def rehearse(name: str, **kw) -> harness.Outcome:
    cell = tiny_cell(name)
    r = harness.Run(cell=cell, seed=(1 << 31) + 5, seconds=kw.pop("seconds", 0.5), trace=False,
                    t0=time.perf_counter(), device="cpu", **kw)
    return harness.driver(cell["driver"]).run(r)


@pytest.mark.parametrize("name", ONE_CARD)
def test_driver_runs_and_checks_on_the_cpu(name):
    out = rehearse(name)
    ok, checks = harness.judge(out.numbers, tiny_cell(name)["limits"])
    assert ok, checks
    assert out.attempted > 0 and out.setup_s > 0 and out.memory_peak_bytes == 0
    assert all(v > 0 for v in out.rate.values()) and len(out.rate) == 1
    r = harness.Run(cell=tiny_cell(name), seed=0, seconds=0.5, trace=False, t0=0.0, device="cpu")
    with pytest.raises(RuntimeError, match="writes no result"):
        harness.result_line(tiny_cell(name), r, out, harness.manifest())


def test_same_seed_same_inputs():
    from portbench import inputs

    cfg = tiny_cell("train_sv_b128")["config_data"]
    a, b = (inputs.regressor_inputs(cfg, 2**31 + 9, "cpu") for _ in range(2))
    assert all((a["weights"][k] == b["weights"][k]).all() for k in a["weights"])
    assert (a["samples"].cols["image"] == b["samples"].cols["image"]).all()


def test_data_parallel_driver_over_four_gloo_ranks():
    out = rehearse("train_sv_ddp4_b128")
    ok, checks = harness.judge(out.numbers, tiny_cell("train_sv_ddp4_b128")["limits"])
    assert ok, checks
    assert out.count == 4 and out.rate["train_images_per_s"] > 0
