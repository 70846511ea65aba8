"""One-off measurement: the held-out learning proof's train step on one NVIDIA GPU.

    python3 scripts/heldout_profile.py [--mode sv] [--samples 2400] [--warmup 20] \\
        [--steps 20] [--workdir build/heldout_profile] [--out build/heldout_profile.json]

Runs ``tools/prove_learning.py``'s ``heldout`` run (``unet_mid`` at 96²,
B=32 for sv, 8 for mv, the trainer CLI from ``DeviceDataCache``) for one
epoch over ``--samples`` samples, and watches the trainer's own step
(``train/trainer.py::make_train_step``, wrapped here and nowhere else):
after ``--warmup`` steps, ``--steps`` steps timed on the host's clock
between two synchronizations (wall ms a step), then ``--steps`` more under
``torch.profiler`` tracing the device only: device busy ms and device
operations a step, and the top operations by device time. One epoch of a
one-epoch run takes the last phase of the schedule's weights and lr; the
operations a step are the same in every phase.

Prints the card's name and power limit, then one JSON line, which ``--out``
also gets.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["sv", "mv"], default="sv")
    ap.add_argument("--samples", type=int, default=2400)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workdir", default="build/heldout_profile")
    ap.add_argument("--out", default="build/heldout_profile.json")
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smilify_tpu_torch._device import card_line
    from smilify_tpu_torch.tools import prove_learning
    from smilify_tpu_torch.train import trainer

    card = card_line()
    print(card, flush=True)
    first, last = args.warmup, args.warmup + 2 * args.steps
    seen = {"n": 0}
    out = {"mode": args.mode, "samples": args.samples, "card": card,
           "batch": prove_learning.RUNS["heldout"]["batch"][args.mode]}
    make_train_step = trainer.make_train_step

    def watched(*a, **kw):
        step = make_train_step(*a, **kw)

        def run_step(batch):
            i = seen["n"]
            seen["n"] += 1
            if i in (first, first + args.steps):
                torch.cuda.synchronize()
                out["_t0"] = time.perf_counter()
                if i == first + args.steps:
                    out["_prof"] = profile(activities=[ProfilerActivity.CUDA])
                    out["_prof"].__enter__()
            result = step(batch)
            if i in (first + args.steps - 1, last - 1):
                torch.cuda.synchronize()
                ms = (time.perf_counter() - out.pop("_t0")) * 1e3 / args.steps
                if i == first + args.steps - 1:
                    out["wall_ms"] = ms
                else:
                    prof = out.pop("_prof")
                    prof.__exit__(None, None, None)
                    out["wall_ms_profiled"] = ms
                    by_name = {}
                    for e in prof.events():
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                            us, n = by_name.get(e.name, (0.0, 0))
                            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
                    out["device_busy_ms"] = sum(us for us, _ in by_name.values()) / 1e3 / args.steps
                    out["device_ops"] = sum(n for _, n in by_name.values()) / args.steps
                    out["top"] = [{"name": k[:100], "ms": us / 1e3 / args.steps, "count": n / args.steps}
                                  for k, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]]
            return result

        return run_step

    trainer.make_train_step = watched
    n_train = len(trainer.split_dataset(args.samples, prove_learning.RUNS["heldout"]["ratios"],
                                        prove_learning.SPLIT_SEED)[0])
    if n_train // out["batch"] < last:
        raise SystemExit(f"{args.samples} samples give {n_train // out['batch']} steps, "
                         f"fewer than the {last} this measurement needs")
    shutil.rmtree(os.path.join(args.workdir, f"heldout_{args.mode}"), ignore_errors=True)
    prove_learning.run(args.mode, "heldout", args.workdir, epochs=1, samples=args.samples)
    out["steps"] = args.steps
    if "device_busy_ms" in out:
        out["device_busy_share"] = out["device_busy_ms"] / out["wall_ms"]
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
