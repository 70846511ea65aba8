"""On the card: the control (the reference computed a precision lower and
put in the program's place) fails the limits each one-card cell commits, at
the cell's own size, and a cell's check passes its own sound run.

    python -m pytest portbench/tests -m card      # on a machine with a card"""

from __future__ import annotations

import time

import pytest

from portbench import calibrate, harness

ONE_CARD = [w["name"] for w in harness.manifest()["workloads"] if w["chips"] == 1]
# a control is the reference alone: a data-parallel cell's runs on one card too
ALL = [w["name"] for w in harness.manifest()["workloads"]]
SEED = (1 << 31) + 777


def _run(name, device) -> harness.Run:
    return harness.Run(cell=harness.load_cell(name), seed=SEED, seconds=0.0, trace=False,
                       t0=time.perf_counter(), device=str(device), readings_only=True)


@pytest.mark.card
@pytest.mark.parametrize("name", ALL)
def test_control_fails_the_limits(card, name):
    r = _run(name, card)
    ok, checks = harness.judge(calibrate.control_numbers(r), r.cell["limits"])
    assert not ok, checks


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_passes_the_limits(card, name):
    r = _run(name, card)
    out = harness.driver(r.cell["driver"]).run(r)
    ok, checks = harness.judge(out.numbers, r.cell["limits"])
    assert ok, checks
