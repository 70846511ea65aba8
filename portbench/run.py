"""Run one cell of the benchmark once.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the result as the last line of standard
output and the compared numbers beside their limits as the last lines of
standard error; exits 2 without a result when CUDA sees fewer cards than the
cell asks for, 3 when JAX or the JAX package is loaded at the end."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be non-negative")
    harness.cache_dirs()
    bench = harness.manifest()
    cell = harness.load_cell(args.workload, bench)
    harness.require_cards(cell["chips"])
    r = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                    t0=T0)
    out = harness.driver(cell["driver"]).run(r)
    harness.emit(harness.result_line(cell, r, out, bench))


if __name__ == "__main__":
    main()
