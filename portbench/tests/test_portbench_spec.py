"""BENCHMARK.json and every file it names: found by name, within the
contract's limits of names, units and sizes."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"] for m in BENCH["end_to_end"]}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data
    assert (ROOT / "portbench" / "routes" / f"{data['route']}.py").is_file()
    assert (ROOT / "portbench" / "reference" / f"{data['reference']}.py").is_file()
    gen = importlib.import_module(f"portbench.traffic.{data['generator']['name']}")
    assert callable(gen.generate)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] in (1, 4)
    cell, config = harness.cell_files(name)
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        name, w["config"], w["traffic"], w["chips"], w["why"])
    assert config["name"] == w["config"]
    e2e = [m["name"] for m in harness.metrics_of(BENCH, name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, name, "per_layer")
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


def test_cells_are_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric_found_by_name(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    d = json.loads((ROOT / "portbench" / "end_to_end" / f"{m['name']}.json").read_text())
    stat = importlib.import_module(f"portbench.stats.{d['stat']}")
    window = {"iterations": [5, 5, 5], "solve_s": [0.1, 0.2, 0.3], "window_s": 1.5}
    assert stat.value(4.0, window, **d["params"]) > 0
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_found_by_name(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert m["moves"] in E2E
    for cell in m.get("workloads", []):
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in harness.metrics_of(BENCH, cell, "end_to_end")]
    reader, params = harness.layer_reader(m["name"])
    assert callable(reader.read)
    for _, count in params.get("kernels", {}).items():
        assert callable(importlib.import_module(f"portbench.counts.{count}").work)


def test_names_are_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    assert not E2E & {m["name"] for m in BENCH["per_layer"]}


def test_files_under_paths_use_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", str(p.relative_to(ROOT))), p
