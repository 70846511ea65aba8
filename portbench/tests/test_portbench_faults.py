"""The check against faults planted under the timed path (``faults.py``):
the harness's look for a card is skipped, the rest of a run is driven on
the CPU at a tiny size, and ``correct`` comes out false, under the limits
the cell commits, for each fault its cell can have."""

from __future__ import annotations

import pytest

from portbench import faults, harness
from portbench.tests.conftest import tiny_cell
from portbench.tests.test_portbench_drivers import rehearse

# the cells of BENCHMARK.json, and the data-parallel cell where it does not
# list it (its path runs here over four gloo ranks all the same)
LISTED = [w["name"] for w in harness.manifest()["workloads"]]
CASES = [(w["name"], f) for w in harness.manifest()["workloads"]
         for f in faults.kinds(harness.load_cell(w["name"])["driver"])
         if f != "no_exchange" or w["chips"] > 1] + [
    ("train_sv_ddp4_b128", f) for f in faults.kinds("regressor_train")
    if "train_sv_ddp4_b128" not in LISTED]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_makes_the_run_incorrect(name, fault):
    out = rehearse(name, readings_only=True, fault=fault)
    ok, checks = harness.judge(out.numbers, tiny_cell(name)["limits"])
    assert not ok, checks
