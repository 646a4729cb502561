"""K7's routes on the clustered arxiv plan, with the pair hash on and off.

K7 (``csrc/tile.cu``) applies the tile-dense hybrid's tiles. This probe
plans ``chip_smoke.py``'s clustered arxiv graph as its tile phase does
(169,343 nodes, 661 communities, B = 128, bfloat16 tiles, 3198 tiles) and
launches K7 in all four directions at F = 256 and 512 on bfloat16
operands, on each route of :data:`grl_torch.ops.tile.ROUTES` that takes
them (``--routes``), at DropEdge rate 0 (no cell hashed: the staging and
the products alone) and 0.3 (every nonzero cell hashed). Each launch is
held within ``chip_smoke.SPARSE_TOL`` of the plain version and two
launches to the same bits, then timed as ``chip_smoke.py`` times a kernel
row: ``ms`` (CUDA events after an L2 flush) and ``device_ms`` (the card
kept busy until the call is enqueued). Run it by path from the root of a
checkout::

    python grl_torch/probes/tile.py [--routes persistent,simple] [--F 256,512]

It needs an NVIDIA GPU and prints one JSON line (each row's route, launch
plan and times, the card's name and power limit); the log goes to stderr.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RATES = (0.0, 0.3)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("_tile_chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def log(message: str) -> None:
    print(f"[tile] {message}", file=sys.stderr, flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--routes", default="persistent,simple")
    parser.add_argument("--F", default="256,512")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("tile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    from grl_torch.ops import _build, tile

    torch.cuda.set_device(0)
    _build.build(["tile"])
    for line in _build.build_logs.get("tile", "").splitlines():
        if any(word in line for word in ("registers", "spill", "Compiling", "Potential", "injected")):
            log(f"ptxas: {line.strip()}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    data = smoke.clustered_graph()
    N = len(data.features)
    kernel = tile.TileGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                  data.num_relations, device="cuda", **smoke.TILE_PLAN)
    found = {"tiles_total": kernel.tiles_total, "covered_edges": kernel.covered_edges}
    smoke.require(found == smoke.TILE_EXPECTED, f"the clustered graph planned {found}")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    routes = [r for r in args.routes.split(",") if r]
    rows = []
    for F in (int(f) for f in args.F.split(",")):
        for direction in tile.DIRECTIONS:
            plan = kernel.tables.bwd if "backward" in direction else kernel.tables.fwd
            X = smoke.tile_operand(torch, plan, direction, F, "bfloat16", F)
            seed = smoke.device_seed(104729 * (F + 1))
            for rate in RATES:
                ref = tile.tile_apply_reference(X, plan, seed, rate, direction)
                for route in routes:
                    def call(route=route, rate=rate):
                        return tile._launch(X, plan, seed, rate, direction, route=route)

                    out, again = call(), call()
                    torch.cuda.synchronize()
                    what = f"K7 {direction} {route} F={F} rate={rate}"
                    smoke.require(torch.equal(out, again), f"{what}: two launches give other bits")
                    err = smoke.check_close(torch, out, ref, "bfloat16", what, smoke.SPARSE_TOL["bfloat16"])
                    layout = tile.launch_plan(plan, F, X.dtype, direction, route=route,
                                              sms=torch.cuda.get_device_properties(0).multi_processor_count)
                    row = {"direction": direction, "route": route, "F": F, "rate": rate, "max_abs_err": err,
                           "BN": layout.BN, "chunks": layout.chunks, "consumers": layout.consumers,
                           "stages": layout.stages, "smem_bytes": layout.smem_bytes, "ctas": layout.ctas,
                           "ms": smoke.time_ms(torch, call, flush),
                           "device_ms": smoke.time_ms(torch, call, flush, cover=True)}
                    rows.append(row)
                    log(f"{what}: {row['ms']:.4f} ms (device {row['device_ms']:.4f}), max_abs_err {err:.3e}; "
                        f"BN {layout.BN} x {layout.chunks}, {layout.consumers} consumers, {layout.stages} stages, "
                        f"{layout.smem_bytes} B, {layout.ctas} CTAs")
                del ref
    print(json.dumps({"card": card, "tiles": kernel.tiles_total, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
