"""Everything the harness runs, found by the names in ``BENCHMARK.json``:

* a cell (an entry of ``workloads``): its traffic mix in
  ``portbench/workloads/<traffic>.json`` and its output-check limits in
  ``portbench/checks/<cell>.json``;
* a configuration: its sizes in the file ``BENCHMARK.json`` names
  (``portbench/configs/<config>.json``), its cost functions beside it
  (``portbench/configs/<config>.py``) and the plain reference its
  ``reference`` names;
* a per-layer metric: its reader ``portbench/metrics/<metric>.py``, a
  module with ``read(ctx)``;
* a kernel: ``portbench/kernels/<operation>/<kernel>.json``, the names it
  has in a device trace and in the program's launch counts.

Adding a cell, a configuration, a metric or a kernel is adding files and
entries; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]  # the workloads entry of BENCHMARK.json
    traffic: Dict[str, Any]  # portbench/workloads/<name>.json
    config: Dict[str, Any]  # the configuration's file
    cost: ModuleType  # portbench/configs/<config>.py
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


class Benchmark:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as handle:
            self.spec = json.load(handle)

    def _config_entry(self, name: str) -> Dict[str, Any]:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str, entry: Optional[Dict[str, Any]] = None) -> Cell:
        """The cell ``name`` of ``BENCHMARK.json``, or, with ``entry`` (a
        workloads entry of its own), a cell that is not listed there."""
        if entry is None:
            entries = [w for w in self.spec["workloads"] if w["name"] == name]
            if not entries:
                raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: {', '.join(self.cell_names())})")
            entry = entries[0]
        with open(BENCH_DIR / "workloads" / f"{entry['traffic']}.json") as handle:
            traffic = json.load(handle)
        config_entry = self._config_entry(entry["config"])
        config_path = self.root / config_entry["file"]
        with open(config_path) as handle:
            config = json.load(handle)
        cost = _load_module(config_path.with_suffix(".py"), f"portbench_cost_{entry['config']}")

        def reported(metric):
            return name in metric.get("workloads", [name])

        return Cell(name, entry, traffic, config, cost,
                    [m for m in self.spec["end_to_end"] if reported(m)],
                    [m for m in self.spec["per_layer"] if reported(m)])


def reference(config: Dict[str, Any]) -> ModuleType:
    """The configuration's plain reference: the module its ``reference``
    names (a file under ``portbench/reference/``), with ``leaves(model)``,
    ``network(model, rounding)``, ``Draws`` and ``train_steps``."""
    path = Path(config["reference"])
    return importlib.import_module(".".join(path.with_suffix("").parts))


def metric_reader(name: str) -> ModuleType:
    """``portbench/metrics/<name>.py``: a module with ``read(ctx)``, which
    returns the metric's value or ``None`` where it finds nothing to read."""
    return _load_module(BENCH_DIR / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))


def kernels(operation: str) -> List[Dict[str, Any]]:
    """The kernels of ``operation``: each file of
    ``portbench/kernels/<operation>/``, with ``trace_names`` (substrings
    of its names in a device trace) and ``launch_names`` (its names in
    the program's launch counts)."""
    found = []
    for path in sorted((BENCH_DIR / "kernels" / operation).glob("*.json")):
        with open(path) as handle:
            found.append({"kernel": path.stem, **json.load(handle)})
    return found


def limits(cell: Cell) -> Dict[str, float]:
    """The cell's output-check limits: ``portbench/checks/<cell>.json``."""
    path = BENCH_DIR / "checks" / f"{cell.name}.json"
    if not path.exists():
        return {}
    with open(path) as handle:
        return dict(json.load(handle)["limits"])
