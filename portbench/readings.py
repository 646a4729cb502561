"""Readings that a cell's output-check limits are set from, for many seeds in
one process, from the check chunks a run's set-up drives (no measured
window: a training cell's check needs none).

    python portbench/readings.py --workload <cell> --seeds 1,2,3 [--modes program,control,half_batch,per_step]

For each seed, each mode prints one JSON line with the numbers the check
compares:

* ``program``: the program's check chunks against the float32 reference
  (a sound run: its largest reading over a dozen seeds is the lower one);
* ``control``: the reference computed in float8 (per-tensor scaled e4m3,
  the precision below the configuration's bfloat16) put in the
  program's place, against the float32 reference;
* ``half_batch``: the reference with half of the batch's targets left out
  of the loss (the mean taken over the rest) in the program's place;
* ``per_step``: the reference with each chunk's steps all on its first
  step's input (KV: its first batch; full graph: its first step's draws)
  in the program's place;
* ``bfloat16``: the reference computed in bfloat16 in the program's place
  (what the configuration's own precision gives: a witness, not a limit).

A state left unchanged reads 1 on ``change_gap`` by definition and needs
no run.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import device as card  # noqa: E402
from portbench.harness import families  # noqa: E402
from portbench.harness.families.common import Phases, free  # noqa: E402
from portbench.harness.registry import Benchmark  # noqa: E402

PLACED = {"control": ("float8", None), "half_batch": ("float32", "half_batch"), "per_step": ("float32", "per_step"),
          "bfloat16": ("bfloat16", None)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default="program,control,half_batch,per_step")
    parser.add_argument("--placed-seeds", type=int, default=3,
                        help="how many of the seeds, from the first, also read the modes other than program")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    card.prepare_environment()
    cell = Benchmark().cell(args.workload)
    import torch

    if args.device == "cuda":
        card.require_cards(torch, cell.chips)
    modes = args.modes.split(",")
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        seed_modes = modes if n < args.placed_seeds else [m for m in modes if m == "program"]
        workdir = tempfile.TemporaryDirectory(prefix="portbench_")
        family = families.load(cell.traffic["family"])(torch, cell, seed, args.device, workdir.name)
        family.make_inputs()
        if "program" in modes:
            phases = Phases(time.perf_counter())
            family.build()
            if hasattr(family, "encode"):
                family.encode()
            family.check_chunks(phases)
            family.release()
        reference = family.reference_run()
        for mode in seed_modes:
            placed = family.program if mode == "program" else family.reference_run(*PLACED[mode])
            numbers = family.numbers(placed, reference)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode, **numbers}), flush=True)
        del family
        free(torch)
        workdir.cleanup()
        sys.stderr.write(f"seed {seed}: {time.perf_counter() - start:.1f} s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
