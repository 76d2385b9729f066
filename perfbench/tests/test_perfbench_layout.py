"""The benchmark's layout: every cell, configuration, traffic mix, metric
reader and limit named in BENCHMARK.json is found by its name, the file
keeps to its own limits, and nothing under perfbench/ imports JAX or the
JAX package (top-level module names compared whole)."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "aerial_gym_simulator_tpu"}
PORT = "aerial_gym_simulator_tpu_torch"


def _imports(path: Path):
    """Top-level names of every module a file imports (relative imports
    excluded)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    from perfbench.harness import core
    w, cfg, traffic, limits, e2e, per_layer = core.load_cell(cell)
    kind = core.load_kind(traffic["kind"])
    assert hasattr(kind, "Loop") and hasattr(kind, "Check")
    assert {"setup_s"} <= {m["name"] for m in e2e} and len(e2e) >= 2
    for m in e2e:
        assert callable(core.load_reader(m["name"], "end_to_end"))
    assert per_layer, "every cell reports a per-layer metric"
    for m in per_layer:
        assert callable(core.load_reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert cfg["name"] == w["config"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found(metric):
    from perfbench.harness import core
    assert callable(core.load_reader(metric))


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]])
def test_end_to_end_reader_found(metric):
    from perfbench.harness import core
    assert callable(core.load_reader(metric, "end_to_end"))


def test_shared_harness_names_no_kind_or_metric():
    """The shared run finds kinds and metrics by name: it names no kind, no
    task, no metric and no number of the comparison (but ``setup_s``,
    which every cell reports and the run itself times)."""
    names = {json.loads(p.read_text())["kind"] for p in (BENCH / "traffic").glob("*.json")}
    names |= {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    names |= set().union(*(json.loads(p.read_text()) for p in (BENCH / "limits").glob("*.json")))
    names |= {"navigation", "task_loop", "env_loop", "render_camera"}
    names.discard("setup_s")
    for f in ("core.py", "tracing.py"):
        text = (BENCH / "harness" / f).read_text()
        found = sorted(n for n in names if re.search(rf"\b{re.escape(n)}\b", text))
        assert not found, f"harness/{f} names {found}"


def test_spec_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_no_jax_imports():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        found = set(_imports(f)) & FORBIDDEN
        assert not found, f"{f.relative_to(ROOT)} imports {sorted(found)}"


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_port(folder):
    for f in sorted((BENCH / folder).rglob("*.py")):
        names = set(_imports(f))
        assert PORT not in names and not names & FORBIDDEN, f"{f.relative_to(ROOT)}: {names}"


def test_nothing_reads_the_tpu_records():
    records = ("bench.py", "BASELINE.json", "BENCH_r0", "MULTICHIP_r", "ROOFLINE.jsonl",
               "PERF_REMEASURE.jsonl")
    for f in sorted(BENCH.rglob("*.py")):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        for r in records:
            assert f'"{r}' not in text and f"'{r}" not in text, f"{f.relative_to(ROOT)} names {r}"
