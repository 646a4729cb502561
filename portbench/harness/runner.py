"""One run of one cell:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. makes the cell's inputs and weights from ``--seed`` and builds its path
   through the program's entry points (set-up: imports, inputs, plan, and
   one warm-up chunk and one capture per shape, the first two of which are
   the chunks the output check compares);
2. measures for ``--seconds``; with ``--trace 1`` the first
   ``trace_seconds`` of the window (whole chunks) are traced with
   ``torch.profiler``, and the cell's per-layer metrics are read from the
   trace, the harness's spans and the counters;
3. reads the peak of device memory, frees the program's state, runs the
   plain reference over the steps of the check's chunks and compares;
4. prints the set-up split, the card (``nvidia-smi``) and the launch counts,
   then, last on standard error, each compared number beside its limit,
   and last on standard output one JSON line: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device``, ``breakdown`` (traced runs) and
   ``check``.

A run without a CUDA card, or with fewer than the cell asks for, exits 2
with no result; one that finds JAX, flax or ``grl_tpu`` loaded exits 3
with no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

from portbench.harness import device as card
from portbench.harness import families, trace
from portbench.harness.check import verdict
from portbench.harness.families.common import Phases, launch_names
from portbench.harness.registry import Benchmark, kernels, limits, metric_reader


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def per_layer(cell, tracer) -> Dict:
    """The cell's per-layer metrics from the traced window, and the
    ``device`` and ``breakdown`` fields of a traced run."""
    device_events, host_events, device_spans, window_us = trace.read_trace(tracer.trace_path)
    os.unlink(tracer.trace_path)
    busy_us = trace.device_busy_us(device_events)
    ctx = trace.Context(cell, window_us / 1e6, busy_us / 1e6, device_events, tracer.counters(),
                        dict(tracer.spans), device_spans, kernels)
    metrics = {}
    for metric in cell.per_layer:
        value = metric_reader(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return {"metrics": metrics, "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
            "breakdown": trace.breakdown(device_events, host_events, window_us)}


def refuse_forbidden(where: str) -> None:
    found = card.forbidden_modules()
    if found:
        sys.stderr.write(f"portbench: {', '.join(found)} loaded in the run's process ({where}); no result\n")
        sys.exit(3)


def main(argv: Optional[List[str]] = None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    card.prepare_environment()
    cell = Benchmark().cell(args.workload)
    import torch

    card.require_cards(torch, cell.chips)
    phases = Phases(started)
    families.import_program(cell.traffic["family"])
    torch.zeros(1, device="cuda")
    phases.mark("import")
    return run_cell(torch, args, cell, phases, started, "cuda")


def run_cell(torch, args, cell, phases, started, device: str) -> int:
    """Everything of a run after the look for a card, on ``device`` (the
    tests drive it on the CPU at a tiny size)."""
    workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        return _run(torch, args, cell, phases, started, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(torch, args, cell, phases, started, device, workdir) -> int:
    from grl_torch.ops import launches

    cuda = device == "cuda"
    family = families.load(cell.traffic["family"])(torch, cell, args.seed, device, workdir)
    family.setup(phases)
    setup_s = time.perf_counter() - started
    tracer = trace.Tracer(torch, bool(args.trace), float(cell.traffic.get("trace_seconds", 3)))
    measured = family.window(args.seconds, tracer)
    refuse_forbidden("after the window")
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ran = launches.device_counts()
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": int(family.attempted), "failed": int(family.failed)}
    breakdown = None
    if args.trace:
        traced = per_layer(cell, tracer)
        result["metrics"] = traced["metrics"]
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        breakdown = traced["breakdown"]
    else:
        values = {**measured, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    family.release()
    check_started = time.perf_counter()
    numbers = family.numbers(family.program, family.reference_run())
    check_s = time.perf_counter() - check_started
    correct, rows = verdict(numbers, limits(cell))
    result["correct"] = bool(correct and family.failed == 0)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    refuse_forbidden("at the end of the run")

    print(json.dumps({"setup_s": setup_s, "split_s": phases.seconds, "window_s": measured["_window_s"],
                      "steps": measured["_steps"], "check_s": check_s, "run_s": time.perf_counter() - started,
                      "epoch_ends_s": getattr(family, "epoch_ends", None)}))
    print(json.dumps({"card": card.card_report(), "torch": torch.__version__, "cuda": torch.version.cuda}))
    print(json.dumps({"launches": {k: ran[k] for k in launch_names(list(family.operations)) if ran[k]}}))
    print(json.dumps({"check_detail": {k: v for k, v in numbers.items() if k not in result["check"]}}))
    sys.stdout.flush()
    for name, value, limit in rows:
        sys.stderr.write(f"check {name} {value!r} limit {limit!r}\n")
    sys.stderr.write(f"check correct {result['correct']}\n")
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
