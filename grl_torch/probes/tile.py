"""K7's routes on the clustered arxiv plan, with the pair hash on and off.

K7 (``csrc/tile.cu``) applies the tile-dense hybrid's tiles. This probe
plans ``chip_smoke.py``'s clustered arxiv graph as its tile phase does
(169,343 nodes, 661 communities, B = 128, 3198 tiles) and launches K7 in
all four directions at F = 256 and 512, on bfloat16 and float32 tiles
(``--tiles``; the float32 tables are the bf16 ones cast, exact: the graph's
weights are 1) under bfloat16 and float32 operands (``--dtypes``): on the
dtype pair's persistent route (``auto``, :func:`grl_torch.ops.tile.route_for`)
and the simple one (``--routes``), the persistent route also at each forced
chunk width of ``--bn``, at DropEdge rate 0 (no cell hashed: the staging and
the products alone) and 0.3 (every nonzero cell hashed). Each launch is
held within ``chip_smoke.SPARSE_TOL`` of the plain version and two
launches to the same bits, then timed as ``chip_smoke.py`` times a kernel
row: ``ms`` (CUDA events after an L2 flush) and ``device_ms`` (the card
kept busy until the call is enqueued). Run it by path from the root of a
checkout::

    python grl_torch/probes/tile.py [--routes auto,simple] [--F 256,512] [--tiles bfloat16,float32]
                                    [--dtypes bfloat16,float32] [--bn 128]

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
    parser.add_argument("--routes", default="auto,simple")
    parser.add_argument("--F", default="256,512")
    parser.add_argument("--tiles", default="bfloat16,float32")
    parser.add_argument("--dtypes", default="bfloat16,float32")
    parser.add_argument("--bn", default="", help="chunk widths to force on the persistent route, besides its own")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forced = [int(bn) for bn in args.bn.split(",") if bn]
    tables = {"bfloat16": (kernel.tables.fwd, kernel.tables.bwd)}
    tables["float32"] = tuple(p._replace(tiles=p.tiles.float(), launch_cache={}) for p in tables["bfloat16"])
    rows = []
    for tile_dtype in (t for t in args.tiles.split(",") if t):
        for dtype_name in (d for d in args.dtypes.split(",") if d):
            for F in (int(f) for f in args.F.split(",")):
                for direction in tile.DIRECTIONS:
                    plan = tables[tile_dtype][1 if "backward" in direction else 0]
                    X = smoke.tile_operand(torch, plan, direction, F, dtype_name, F)
                    own = tile.route_for(plan.tiles.dtype, X.dtype)
                    launches = [(own if r == "auto" else r, None) for r in args.routes.split(",") if r]
                    for bn in forced:
                        layout = tile.persistent_layout(plan, F, own, bn, direction, sms)
                        launches.append((own, (layout, tile.work_tensor(layout, X.device))))
                    seed = smoke.device_seed(104729 * (F + 1))
                    for rate in RATES:
                        ref = tile.tile_apply_reference(X, plan, seed, rate, direction)
                        for route, forced_layout in launches:
                            layout = (forced_layout or tile._cached_launch(plan, F, X, direction, route))[0]

                            def call(route=route, rate=rate, forced_layout=forced_layout):
                                return tile._launch(X, plan, seed, rate, direction, route, forced_layout)[0]

                            out, again = call(), call()
                            torch.cuda.synchronize()
                            what = (f"K7 {direction} {tile_dtype} tiles, {dtype_name} operands, {route}"
                                    f"{'' if forced_layout is None else f' BN={layout.BN}'} F={F} rate={rate}")
                            smoke.require(torch.equal(out, again), f"{what}: two launches give other bits")
                            err = smoke.check_close(torch, out, ref, dtype_name, what, smoke.SPARSE_TOL[dtype_name])
                            row = {"direction": direction, "tile_dtype": tile_dtype, "dtype": dtype_name,
                                   "route": route, "F": F, "rate": rate, "max_abs_err": err, "BN": layout.BN,
                                   "chunks": layout.chunks, "consumers": layout.consumers, "stages": layout.stages,
                                   "smem_bytes": layout.smem_bytes, "ctas": layout.ctas,
                                   "ms": smoke.time_ms(torch, call, flush),
                                   "device_ms": smoke.time_ms(torch, call, flush, cover=True)}
                            rows.append(row)
                            log(f"{what}: {row['ms']:.4f} ms (device {row['device_ms']:.4f}), max_abs_err "
                                f"{err:.3e}; BN {layout.BN} x {layout.chunks}, {layout.consumers} consumers, "
                                f"{layout.stages} stages, {layout.smem_bytes} B, {layout.ctas} CTAs")
                        del ref
    print(json.dumps({"card": card, "tiles": kernel.tiles_total, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
