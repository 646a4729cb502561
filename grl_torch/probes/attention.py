"""K4's layouts and its in-L2 floor, at the arxiv shape and on larger graphs.

K4 (``csrc/sparse_attention.cu``) gives a group of lanes one receiver,
keeps 4 h rows in flight a group, and walks h in column slices sized so
that a slice of h and all of g stay in the card's L2
(:func:`grl_torch.ops.sparse_attention.attention_launch`). This probe
launches K4 on the graph of ``configs/arxiv_full_graph.yaml`` (169,343
nodes, 1,184,773 edges) at K = 16, F = 128, in bfloat16 and float32, laid
out as

* the plan (``"planned"``),
* groups of 4, 8, 16 and 32 lanes, each in one slice and in slices of 256,
  128 and 64 bytes of h a row (at the plan's group, the same bits as the
  plan; at another, other rounds of the online softmax, within tolerance),
* the plan with 2, 4, 8 and 16 blocks an SM,

and then with h and g folded onto the rows whose bytes fill half the L2
(every sender taken modulo that row count), as planned, in one slice, and
in one slice with a lane for every vector of a row:
every gather then hits L2, and that time is the design's in-L2 floor,
printed beside the kernel's (``chip_smoke.fold``, which ``chip_smoke.py``
also times).

Then it takes the arxiv graph tiled 1, 2, 4 and 14 times (each edge's
sender moved to a random copy, so every receiver keeps its degree and the
senders spread over all the rows), at F = 128 and 256 (256 not at 14
copies), and times the plan beside one slice and slices of 256 and 128
bytes a row, each with a lane for every vector of a slice row: where the
plan's rule departs from one slice, this says what it costs or buys. The
rows in flight (``kStages`` in the source) are swept by editing that
constant.

Every variant is held within ``chip_smoke.SPARSE_TOL`` of the plain
version and, where its group is the plan's, to the planned output bit for
bit; then each is timed as ``chip_smoke.py`` times a kernel row: ``ms``
(CUDA events after an L2 flush) and ``device_ms`` (the card kept busy until
the call is enqueued). Run it by path from the root of a checkout::

    python grl_torch/probes/attention.py

It needs an NVIDIA GPU and prints one JSON line (each variant's layout and
times, the card's name, power limit and L2 size); the log goes to stderr.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
K, F = 16, 128
SLICE_BYTES = (256, 128, 64)
GROUPS = (4, 8, 16, 32)
COPIES = (1, 2, 4, 14)  # of the arxiv graph, tiled
WIDE_F = 256  # also timed on the tiled graphs of up to 4 copies


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("_attention_chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variants(planned, itemsize: int, sms: int):
    """(name, launch) of every layout, the plan first."""
    out = [("planned", planned)]
    slicings = [("one slice", [(0, F)])]
    for nbytes in SLICE_BYTES:
        cols = nbytes // itemsize
        if cols < F:
            slicings.append((f"{nbytes} B slices", [(c, min(cols, F - c)) for c in range(0, F, cols)]))
    for group in GROUPS:
        out += [(f"group {group}, {name}", planned._replace(group=group, slices=cuts)) for name, cuts in slicings]
    out += [(f"{b} blocks an SM", planned._replace(blocks=b * sms)) for b in (2, 4, 8, 16)]
    return out


def tiled(senders, receivers, N: int, copies: int, rng):
    """The graph tiled ``copies`` times: copy c holds every edge with its
    receiver moved to copy c and its sender to a random copy."""
    E = len(senders)
    copy = np.repeat(np.arange(copies), E)
    return (np.tile(senders, copies) + N * rng.randint(0, copies, copies * E),
            np.tile(receivers, copies) + N * copy)


def row_layouts(planned, F: int, itemsize: int):
    """(name, launch) of the plan, one slice and slices of 256 and 128
    bytes a row, each with a lane for every vector of a slice row."""
    out = [("planned", planned)]
    for nbytes in (F * itemsize,) + tuple(b for b in SLICE_BYTES[:2] if b < F * itemsize):
        cols = nbytes // itemsize
        name = "one slice" if cols == F else f"{nbytes} B slices"
        slices = [(c, min(cols, F - c)) for c in range(0, F, cols)]
        out.append((name, planned._replace(group=min(32, nbytes // 16), slices=slices)))
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    from grl_torch.ops import _build, sparse, sparse_attention

    torch.cuda.set_device(0)
    _build.build(["sparse_attention"])
    for line in _build.build_logs.get("sparse_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[attention] ptxas: {line.strip()}", file=sys.stderr, flush=True)
    data = smoke.arxiv_graph()
    N = len(data.features)
    kernel = sparse_attention.SparseAttentionKernel(data.senders, data.receivers, N, device="cuda")
    E = kernel.num_edges
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    l2, sms = sparse.l2_bytes(0), sparse.sm_count(0)
    rows = []

    def timed(name, dtype_name, launch, call, **extra):
        row = {"variant": name, "dtype": dtype_name, "group": launch.group, "slices": len(launch.slices),
               "slice_cols": launch.slices[0][1], "blocks": launch.blocks,
               "ms": smoke.time_ms(torch, call, flush), "device_ms": smoke.time_ms(torch, call, flush, cover=True),
               **extra}
        rows.append(row)
        print(f"[attention] K4 {dtype_name} {name}: group {row['group']}, "
              f"{row['slices']} x {row['slice_cols']} cols, {row['blocks']} blocks: {row['ms']:.4f} ms, "
              f"device {row['device_ms']:.4f} ms", file=sys.stderr, flush=True)
        return row

    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(7)
        f, g, h = (torch.randn(N, d, generator=gen, device="cuda").to(dtype) for d in (K, K, F))
        itemsize = h.element_size()
        planned = sparse_attention.attention_launch(N, K, F, itemsize, l2, sms)
        ref = sparse_attention.attend_reference(f, g, h, kernel.plan)
        base = sparse_attention._launch(f, g, h, kernel.plan, planned)
        torch.cuda.synchronize()
        smoke.check_close(torch, base, ref, dtype_name, f"K4 {dtype_name} planned", smoke.SPARSE_TOL[dtype_name])
        for name, launch in variants(planned, itemsize, sms):
            def call(launch=launch):
                return sparse_attention._launch(f, g, h, kernel.plan, launch)
            out = call()
            torch.cuda.synchronize()
            smoke.check_close(torch, out, ref, dtype_name, f"K4 {dtype_name} {name}", smoke.SPARSE_TOL[dtype_name])
            smoke.require(launch.group != planned.group or torch.equal(out, base),
                          f"K4 {dtype_name} {name}: not the planned output bit for bit")
            timed(name, dtype_name, launch, call)
        # Every gather in L2: h and g folded onto rows that fit.
        folded, g_in, h_in = smoke.fold(torch, kernel.plan, g, h, l2)
        ref_in = sparse_attention.attend_reference(f, g_in, h_in, folded)
        row_group = min(32, F * itemsize // 16)
        for name, launch in (("in L2, planned", planned), ("in L2, one slice", planned._replace(slices=[(0, F)])),
                             (f"in L2, group {row_group}, one slice",
                              planned._replace(group=row_group, slices=[(0, F)]))):
            def call(launch=launch):
                return sparse_attention._launch(f, g_in, h_in, folded, launch)
            out = call()
            torch.cuda.synchronize()
            smoke.check_close(torch, out, ref_in, dtype_name, f"K4 {dtype_name} {name}", smoke.SPARSE_TOL[dtype_name])
            timed(name, dtype_name, launch, call, rows_in_l2=h_in.shape[0],
                  mb_in_l2=h_in.shape[0] * (K + F) * itemsize / 1e6)

    # Larger graphs: where the plan's rule departs from one slice.
    rng = np.random.RandomState(11)
    for copies in COPIES:
        senders, receivers = tiled(data.senders, data.receivers, N, copies, rng)
        n = N * copies
        big = sparse_attention.SparseAttentionKernel(senders, receivers, n, device="cuda")
        del senders, receivers
        for width in (F, WIDE_F):
            if width == WIDE_F and copies > 4:
                continue
            for dtype_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dtype_name)
                gen = torch.Generator(device="cuda").manual_seed(copies)
                f, g, h = (torch.randn(n, d, generator=gen, device="cuda").to(dtype) for d in (K, K, width))
                itemsize = h.element_size()
                planned = sparse_attention.attention_launch(n, K, width, itemsize, l2, sms)
                ref = sparse_attention.attend_reference(f, g, h, big.plan)
                for name, launch in row_layouts(planned, width, itemsize):
                    def call(launch=launch):
                        return sparse_attention._launch(f, g, h, big.plan, launch)
                    out = call()
                    torch.cuda.synchronize()
                    what = f"K4 {dtype_name} {copies} copies F={width} {name}"
                    smoke.check_close(torch, out, ref, dtype_name, what, smoke.SPARSE_TOL[dtype_name])
                    timed(f"{copies} copies, F={width}, {name}", dtype_name, launch, call, N=n,
                          E=big.num_edges, F=width)
                    del out
                del f, g, h, ref
                torch.cuda.empty_cache()
        del big
    del flush
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "l2_bytes": l2, "sm_count": sms, "N": N, "E": E, "K": K, "F": F,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
