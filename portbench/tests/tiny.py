"""Each cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, and
a run of it through the harness's own path (everything after the look
for a card), for the tests."""
import contextlib
import copy
import io
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_cell(name: str, dtype: str = "float32"):
    """The cell ``name`` at a tiny size, its model in ``dtype``: chunks of 2
    steps, and enough batches for the check's two chunks of one shape."""
    from portbench.harness.registry import Benchmark

    cell = Benchmark(ROOT).cell(name)
    cell.config, cell.traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    family = cell.traffic["family"]
    cell.config["scan_steps"] = 2
    if family == "fullgraph":
        cell.config["graph"].update(num_nodes=600, avg_degree=5, feature_dim=16, num_classes=5)
        cell.config["model"].update(input_dim=16, output_dim=5, net_size=32)
    if family == "kv":
        cell.config["data"].update(classes=9, charset=300)
        cell.config["model"].update(input_dim=304, output_dim=19, net_size=32)
        cell.traffic["pages"] = 96 if isinstance(cell.traffic["boxes"], dict) else 40
        if isinstance(cell.traffic["boxes"], int):
            cell.traffic["boxes"] = 40
        else:
            cell.traffic["boxes"].update(median=40, min=12, max=150)
    cell.config["model"]["compute_dtype"] = dtype
    cell.traffic["trace_seconds"] = 0.2
    return cell


def run(cell, seed: int = 2**31 + 7, seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of ``cell`` on the CPU; its result line."""
    import torch

    from portbench.harness import runner
    from portbench.harness.families.common import Phases

    args = runner.parse(["--workload", cell.name, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert runner.run_cell(torch, args, cell, Phases(time.perf_counter()), time.perf_counter(), "cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
