"""The readings that a cell's limits are set from, on the card at the cell's
own size: the program's compared numbers over many seeds (sound runs), the
control's (the reference computed a precision lower put in the program's
place) and each fault's that the cell can have (``faults.py``; a data-
parallel cell's faults are planted in the reference at the global batch,
one card). Not part of a benchmark run.

    python -m portbench.calibrate --workload <name> [--sound SEED ...]
        [--control SEED ...] [--faults SEED ...] [--out FILE]

Prints one JSON line a reading and, with ``--out``, writes them all."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import faults, harness  # noqa: E402


def control_numbers(r: harness.Run) -> dict:
    """The control's numbers: the reference a precision lower against the reference."""
    drv = r.cell["driver"]
    if drv == "fit_sequence":
        from portbench.drivers import fit_sequence as d

        inp = d.setup_inputs(r)
        return harness.training_numbers(d.reference_steps(r, inp, tf32_on=True),
                                        d.reference_steps(r, inp))
    if drv == "regressor_train":
        return _train_reference_numbers(r, lambda order: order, lower=True)
    from portbench import inputs
    from portbench.drivers import regressor_infer as d

    inp = inputs.regressor_inputs(r.config, r.seed, r.device)
    order = inputs.order_iter(r.config["cache_samples"], r.seed, r.params["batch"])
    idx = [next(order) for _ in range(r.params["check_batches"])]
    return d.answer_gap([d.reference_outputs(r, inp, i, lower=True) for i in idx],
                        [d.reference_outputs(r, inp, i) for i in idx])


def _train_reference_numbers(r: harness.Run, planted, lower=False) -> dict:
    """The training rule between the reference on ``planted(global batches)``
    (a precision lower with ``lower``) and the reference on the batches."""
    import itertools

    from portbench import inputs
    from portbench.drivers import regressor_train as d

    inp = inputs.regressor_inputs(r.config, r.seed, r.device)
    gbatch = r.params["batch"] * r.cell["chips"]
    order = list(itertools.islice(inputs.order_iter(r.config["cache_samples"], r.seed, gbatch),
                                  r.params["check_steps"]))
    return harness.training_numbers(d.reference_steps(r, inp, planted(order), lower=lower),
                                    d.reference_steps(r, inp, order))


def fault_numbers(r: harness.Run, fault: str) -> dict:
    drv = r.cell["driver"]
    if drv == "regressor_train" and r.cell["chips"] > 1:
        if fault == "unchanged":
            return {"change_gap": 1.0}          # by the rule's measure, without a run
        n = r.params["batch"]
        keep = (lambda o: [i[: len(i) // 2] for i in o]) if fault == "half_batch" else \
            (lambda o: [i[:n] for i in o])      # no exchange: rank 0's rows, its own statistics
        return _train_reference_numbers(r, keep)
    return harness.driver(drv).run(dataclasses.replace(r, fault=fault)).numbers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell["chips"] if args.sound else 1)
    base = harness.Run(cell=cell, seed=0, seconds=0.0, trace=False, t0=T0, readings_only=True)
    jobs = ([("sound", s, None) for s in args.sound] + [("control", s, None) for s in args.control]
            + [(f, s, f) for s in args.faults for f in faults.kinds(cell["driver"])
               if f != "no_exchange" or cell["chips"] > 1])
    readings = []
    for kind, seed, fault in jobs:
        r = dataclasses.replace(base, seed=seed, t0=time.perf_counter())
        t = time.perf_counter()
        if kind == "sound":
            numbers = harness.driver(cell["driver"]).run(r).numbers
        elif kind == "control":
            numbers = control_numbers(r)
        else:
            numbers = fault_numbers(r, fault)
        row = {"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
               "seconds": time.perf_counter() - t}
        readings.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(readings, indent=1))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
