"""What every cell shares: finding its files by name, the look for cards,
the run's record, the per-layer readers, the comparison that decides
``correct``, and the result line.

A cell ``<name>`` of ``BENCHMARK.json`` has ``workloads/<name>.json`` (its
configuration, traffic label, chips, driver, the driver's parameters, the
limits of the numbers its check compares, and why); its configuration has
``configs/<config>.json``; its driver is ``drivers/<driver>.py`` with
``run(r: Run) -> Outcome``; a per-layer metric ``<metric>`` is read by
``metrics/<metric>.py``'s ``read(obs) -> float | None``."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smilify_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's file with its configuration and its manifest entry joined in."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json: {key} {cell[key]!r} differs from "
                             f"BENCHMARK.json's {entry[key]!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cell["name"] = name
    cell["config_data"] = json.loads((ROOT / conf["file"]).read_text())
    return cell


def load_file(path: Path):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def require_cards(n: int) -> None:
    """Exit with code 2 unless CUDA sees at least ``n`` cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: this cell needs {n} CUDA card(s), {have} visible", file=sys.stderr)
        raise SystemExit(2)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))


def tf32(on: bool) -> None:
    """TF32 for float32 matmuls and convolutions on or off (the
    configurations state float32 with it off; the controls turn it on)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver is given."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    t0: float                      # the process's start, host clock
    device: str = "cuda"
    rank: int = 0
    world: int = 1
    store: Optional[str] = None    # the rendezvous file of a multi-card cell
    readings_only: bool = False    # calibration: the first steps and the check, no window
    fault: Optional[str] = None    # a fault of ``faults.py`` planted in the program (checks only)

    @property
    def params(self) -> dict:
        return self.cell["params"]

    @property
    def config(self) -> dict:
        return self.cell["config_data"]


@dataclasses.dataclass
class Outcome:
    """What a driver returns on the printing rank."""

    numbers: dict                  # compared numbers by name
    rate: dict                     # end-to-end metrics by name (not setup_s)
    setup_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    count: int
    obs: dict                      # what the per-layer readers read


def planted(r: Run):
    """The run's planted fault as a context manager (none in a benchmark run)."""
    if r.fault is None:
        return contextlib.nullcontext()
    from portbench import faults

    return faults.plant(r.cell["driver"], r.fault)


def median(xs):
    return statistics.median(xs) if xs else 0.0


def training_numbers(prog: dict, ref: dict) -> dict:
    """The training rule. ``prog`` and ``ref`` hold ``losses`` (a list),
    ``grad`` and ``change`` ({leaf: norm}): the first gradient as Adam got
    it, and the parameters' change over the steps. Each leaf's gap is
    measured against the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out
    of the change. ``loss_gap``, ``grad_gap`` and ``change_gap`` take the
    worst step and the worst leaf; ``loss1_gap`` is the first step's loss
    and ``grad_median_gap`` the median leaf's first gradient, steadier where
    a small leaf's gradient cancels to its own round-off (a cell's limits
    name the numbers it compares)."""
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    g_med = median(list(ref["grad"].values()))
    grad = [abs(prog["grad"][k] - g) / max(g, g_med, 1e-30) for k, g in ref["grad"].items()]
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = median([ref["change"][k] for k in moved])
    change = [abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med, 1e-30)
              for k in moved]
    return {"loss_gap": max(rel), "grad_gap": max(grad), "change_gap": max(change),
            "loss1_gap": rel[0], "grad_median_gap": median(grad)}


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number finite and within its limit."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def per_layer(cell: dict, bench: dict, obs: dict) -> dict:
    """Each per-layer metric that this cell reports, read from ``obs``;
    a reader that finds nothing leaves its metric out."""
    out = {}
    for m in bench["per_layer"]:
        if cell["name"] not in m.get("workloads", [cell["name"]]):
            continue
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: dict, r: Run, out: Outcome, bench: dict) -> dict:
    """The result of a run on the card; a run elsewhere writes no device metric."""
    import torch

    if torch.device(r.device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("a run off the card writes no result")
    correct, checks = judge(out.numbers, cell["limits"])
    if r.trace:
        metrics = per_layer(cell, bench, out.obs)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.rate.items()}
        metrics["setup_s"] = {"value": out.setup_s, "unit": units["setup_s"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": out.count,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if r.trace:
        t = out.obs["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = out.obs["breakdown"]
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output; refuses when JAX or its package loaded."""
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}: no result", file=sys.stderr)
        raise SystemExit(3)
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
