"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and free of JAX and (for the reference) of the program."""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys_and_counts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    assert (Path(harness.ROOT) / "BENCHMARK.json").stat().st_size <= 64 * 1024
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_their_keys_and_allowed_names(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert TEXT.match(e[k])
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in e.get("reduced", []):
            assert NAME.match(k)
        assert set(e.get("workloads", [])) <= set(CELLS)


def test_metrics_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert TEXT.match(c["why"]) and c["chips"] in (1, 4)
    assert harness.driver(c["driver"]).run
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert {"setup_s"} < {m["name"] for m in e2e}
    assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])
    assert c["limits"] and all(v > 0 for v in c["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name_and_silent_without_a_trace(metric):
    reader = harness.load_file(harness.HERE / "metrics" / f"{metric}.py")
    assert reader.read({"chips": 1}) is None


def test_config_files_hold_their_reductions():
    seen = set()
    for c in BENCH["configs"]:
        path = Path(harness.ROOT) / c["file"]
        assert path.is_file() and c["file"].startswith(tuple(BENCH["paths"])) and path not in seen
        seen.add(path)
        data = __import__("json").loads(path.read_text())
        assert all(k in data for k in c["reduced"])


def test_budget_of_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


SOURCES = sorted(harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_by_top_level_name(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "numpy", "torch", "portbench"}
    assert all(n.startswith(("portbench.reference", "torch", "numpy", "math", "__future__"))
               for n in _imports(path))


def test_forbidden_names_compare_whole():
    import sys

    sys.modules["smilify_tpu_torch_probe"] = object()
    try:
        assert "smilify_tpu" not in harness.loaded_forbidden()
    finally:
        del sys.modules["smilify_tpu_torch_probe"]
