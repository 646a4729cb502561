"""Every entry of ``BENCHMARK.json`` resolves to its files by name, and the
file keeps to the benchmark's contract (keys, names, units, bounds)."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness import families, registry

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_entries_have_only_their_keys_and_valid_names():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_resolves_by_name(cell_name):
    cell = registry.Benchmark(ROOT).cell(cell_name)
    family = families.load(cell.traffic["family"])
    assert hasattr(family, "setup") and hasattr(family, "reference_run")
    for fn in ("train_step",):
        assert callable(getattr(cell.cost, fn))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(registry.metric_reader(metric["name"]).read)
        assert metric["moves"] in reported
    for metric in cell.per_layer:
        if "roofline" in metric["name"]:
            operation = metric["name"].split("_roofline")[0]
            kernels = registry.kernels(operation)
            assert kernels and all(k["trace_names"] and k["launch_names"] for k in kernels)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_and_its_cost_functions(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert (ROOT / config["file"]).with_suffix(".py").exists()
    assert (ROOT / data["reference"]).exists()
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
