"""What the column slices of K5 and K6 buy, at the arxiv shape.

K5 (``csrc/csr_spmm.cu``) and K6 (``csrc/ell.cu``) walk the gathered
operand in column slices (:func:`grl_torch.ops.sparse.gather_slices`) so
that the rows they gather stay in the card's L2. This probe launches both
kernels' forward on the graph of ``configs/arxiv_full_graph.yaml``
(169,343 nodes; K6 planned with the file's ``kernel_plan``), rate 0.3, in
bfloat16 and float32 at F = 256 and 512, with the slice plan forced to

* one slice (the whole row, the kernels' walk before slicing),
* slices of 128, 64, 32 and 16 bf16 columns' bytes (256, 128, 64 and 32
  bytes; half as many float32 columns),
* the plan the wrappers choose (``"planned"``), and that plan as one
  launch per slice instead of one launch over a (row blocks, slices) grid
  (``"one launch per slice"``).

Then K5 forward over X cut to the rows that fit one planned slice's bytes
(and half of them), sources folded onto those rows, in one slice and as
planned: there every gather hits L2, which gives the card's gather rate
from L2 and the cost of the extra walks apart from any miss.

Every variant must give the one-slice output bit for bit, and the
one-slice output must be within ``chip_smoke.SPARSE_TOL`` of the plain
version; then each is timed as ``chip_smoke.py`` times a kernel row: ``ms``
(CUDA events after an L2 flush) and ``device_ms`` (the card kept busy until
the call is enqueued). Run it by path from the root of a checkout::

    python grl_torch/probes/slices.py

It needs an NVIDIA GPU and prints one JSON line (each variant's slices,
bytes of one slice of X, and times, with the card's L2 size and name).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FS = (256, 512)
SLICE_BYTES = (256, 128, 64, 32)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("_slices_chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variants(F: int, itemsize: int, planned):
    """(name, plan, one launch per slice) of every variant at width F."""
    out = [("one slice", [(0, F)], False)]
    for nbytes in SLICE_BYTES:
        cols = nbytes // itemsize
        out.append((f"{nbytes} B", [(c, min(cols, F - c)) for c in range(0, F, cols)], False))
    out += [("planned", planned, False), ("one launch per slice", planned, True)]
    return out


def resident_cases(torch, smoke, csr_spmm, X, layout, planned, flush, rows) -> None:
    """K5 forward over an X that stays in L2, in one slice and as planned."""
    F = X.shape[-1]
    for name, cuts in (("one slice", [(0, F)]), ("planned", planned)):
        def call(cuts=cuts):
            return csr_spmm._launch(X, layout, 104729, smoke.RATE, plan=cuts)
        row = {"kernel": "K5 forward, X in L2", "dtype": "bfloat16", "F": F, "variant": name,
               "x_rows": X.shape[0], "x_mb": X.numel() * 2 / 1e6, "slices": len(cuts), "slice_cols": cuts[0][1],
               "ms": smoke.time_ms(torch, call, flush), "device_ms": smoke.time_ms(torch, call, flush, cover=True)}
        rows.append(row)
        print(f"[slices] K5 forward bfloat16 F={F}, X of {X.shape[0]} rows ({row['x_mb']:.1f} MB) {name}: "
              f"{row['slices']} x {row['slice_cols']} cols: {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms",
              file=sys.stderr, flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("slices: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    from grl_torch.config import load_config
    from grl_torch.ops import _build, csr_spmm, ell, sparse

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["csr_spmm", "ell"])
    for name in ("csr_spmm", "ell"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[slices] ptxas {name}: {line.strip()}", file=sys.stderr, flush=True)
    data = smoke.arxiv_graph()
    N = len(data.features)
    csr = csr_spmm.CSRGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                  data.num_relations, device="cuda")
    plan = dict(load_config(smoke.FULL_GRAPH_YAML)["kernel_plan"])
    tables = ell.ELLGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                data.num_relations, device="cuda", **plan).tables
    kernels = {"K5 forward": (csr_spmm, csr.forward_layout), "K6 forward": (ell, tables.fwd)}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    l2 = sparse.l2_bytes(0)
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        for F in FS:
            for kernel, (module, layout) in kernels.items():
                gen = torch.Generator(device="cuda").manual_seed(F)
                X = torch.randn(layout.num_src_rows, F, generator=gen, device="cuda")
                X = X.to(getattr(torch, dtype_name))
                seed = 104729 * F
                accumulate = module.csr_accumulate_reference if module is csr_spmm else module.ell_accumulate_reference
                ref = accumulate(X, layout, seed, smoke.RATE)
                one = module._launch(X, layout, seed, smoke.RATE, plan=[(0, F)])
                torch.cuda.synchronize()
                smoke.check_close(torch, one, ref, dtype_name, f"{kernel} {dtype_name} F={F}",
                                  smoke.SPARSE_TOL[dtype_name])
                planned = sparse.gather_slices(layout.num_src_rows, F, X.element_size(), l2)
                for name, cuts, per_slice in variants(F, X.element_size(), planned):
                    if per_slice:
                        def call(cuts=cuts):
                            out = torch.empty(layout.num_rows, F, dtype=X.dtype, device="cuda")
                            for col0, cols in cuts:
                                module._enqueue(out, X, layout, seed, smoke.RATE, col0, cols, 1)
                            return out
                    else:
                        def call(cuts=cuts):
                            return module._launch(X, layout, seed, smoke.RATE, plan=cuts)
                    out = call()
                    torch.cuda.synchronize()
                    smoke.require(torch.equal(out, one), f"{kernel} {dtype_name} F={F} {name}: not the "
                                  "one-slice output bit for bit")
                    row = {"kernel": kernel, "dtype": dtype_name, "F": F, "variant": name,
                           "slices": len(cuts), "slice_cols": cuts[0][1],
                           "slice_mb": layout.num_src_rows * cuts[0][1] * X.element_size() / 1e6,
                           "ms": smoke.time_ms(torch, call, flush),
                           "device_ms": smoke.time_ms(torch, call, flush, cover=True)}
                    rows.append(row)
                    print(f"[slices] {kernel} {dtype_name} F={F} {name}: {row['slices']} x {row['slice_cols']} "
                          f"cols ({row['slice_mb']:.1f} MB of X each): {row['ms']:.4f} ms, device "
                          f"{row['device_ms']:.4f} ms", file=sys.stderr, flush=True)
    # The same K5 walk over X cut to the rows that fit one planned slice's
    # bytes, or half of them (sources folded onto them): the gathers then
    # stay in L2 whatever the plan, which separates the L2's gather rate from
    # the slices' cost, and shows how much of the L2 one slice can hold.
    for F in FS:
        layout = csr.forward_layout
        planned = sparse.gather_slices(layout.num_src_rows, F, 2, l2)
        for resident in (layout.num_src_rows * planned[0][1] // F, layout.num_src_rows * planned[0][1] // (2 * F)):
            folded = layout._replace(cols=layout.cols % resident, num_src_rows=resident)
            X = torch.randn(resident, F, device="cuda").to(torch.bfloat16)
            resident_cases(torch, smoke, csr_spmm, X, folded, planned, flush, rows)
    del flush
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "l2_bytes": l2, "share": sparse.L2_SLICE_SHARE, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
