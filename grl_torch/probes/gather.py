"""The gather-rate probe P: how fast does the card gather rows?

Counterpart of ``scripts/probe_gather.py``, whose probes measured the
ceiling of the ELL kernel's hot loop (row gathers) on a TPU. Run from the
root of a checkout::

    python -m grl_torch.probes.gather [--quick] [--device cpu]

and it prints one JSON line with the script's keys (``unit``, ``shapes``,
``hbm_peak_rows_per_s_f32``, ``results`` in M rows/s, ``failures``) and
the ``device`` it ran on. Every probe gathers from V (N = 169,343 rows of
F = 128 float32, seed 0):

* A, B1, B2, C, D: ``torch.index_select`` over E = 1,183,000 random,
  sorted and semi-local (random within 2048-row windows) indices, bf16
  rows, and 256- and 512-wide float32 rows: the library's gather rates
  (XLA gathers in the script);
* E1 (``:154``), E2 (``:177``), F (``:219``), G (``:285``): the script's
  Pallas kernels, as CUDA kernels (``grl_torch/csrc/gather_probe.cu``) —
  E1 gathers rows of a window resident in shared memory, E2 is the
  per-element ``take_along_axis`` form, F streams window i into shared
  memory and gathers 16,384 rows from it, G sums 1024 rows a block through
  a ring of 8 single-row bulk copies (``cp.async.bulk``, one ``mbarrier`` a
  slot), at the script's 32 blocks and at one block per SM.

Deviation: the TPU's window is 2048 float32 rows (1 MB of VMEM); a block
has at most 227 KB of shared memory, so E1, E2 and F use windows of 256
rows (128 KB) and keep the script's total rows gathered (``shapes``
records the window). Each kernel wrapper takes its plain PyTorch version
for CPU tensors, launches its kernel for CUDA tensors or raises, and
counts its launches. Before timing, every kernel is held against its plain
version on the same inputs (E1, E2, F exactly; G within 1e-5 relative, a
float32 sum in another order); a probe that fails makes the run fail.

Times are CUDA events around single launches, the median of 40, with the
50 MB L2 flushed before each. ``--quick`` skips D and gathers a sixteenth
of the rows. ``--device cpu`` runs the plain versions with the host clock:
a check of the control flow, whose rates are not the card's.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from grl_torch.ops import _build

N, F, E = 169_343, 128, 1_183_000  # arxiv-scale shapes (scripts/probe_gather.py:56)
WINDOW_ROWS = 256  # the TPU's 2048-row window does not fit a block's shared memory
BLOCK_ROWS = 2048  # E1/E2: rows a block gathers (R in the script)
F_WINDOWS, F_WINDOW_GATHERS = 64, 64 * 256  # F: windows streamed, rows gathered from each
G_ROWS, G_BLOCKS = 1024, 32  # G: rows a block sums (R_DMA), the script's grid
QUICK_DIVISOR = 16
REPS = 40
# Data-sheet HBM rates (NVIDIA H100 SXM, H200 SXM), matched on the card's name.
HBM_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}
G_TOLERANCE = 1e-5  # relative, of the largest sum: float32 in another order


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("gather_probe")
    tail = [ctypes.c_int, ctypes.c_void_p]  # device, stream
    lib.grl_probe_window_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + tail
    lib.grl_probe_window_take_along.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + tail
    lib.grl_probe_row_dma_sum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + tail
    for fn in (lib.grl_probe_window_gather, lib.grl_probe_window_take_along, lib.grl_probe_row_dma_sum):
        fn.restype = ctypes.c_int
    return lib


def _on_card(name: str, src: torch.Tensor, idx: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA ones
    the kernel takes; raises for anything else."""
    if src.device.type == "cpu":
        return False
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {src.device}")
    if src.dtype != torch.float32 or idx.dtype != torch.int32 or idx.device != src.device:
        raise TypeError(f"CUDA {name} takes float32 rows and int32 indices on one device")
    if src.dim() != 2 or src.shape[1] % 4 or not src.is_contiguous() or not idx.is_contiguous() \
            or src.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError(f"CUDA {name} needs contiguous, 16-byte aligned (rows, F) rows with F % 4 == 0")
    return True


def _check_window(win_rows: int, F_: int) -> None:
    if win_rows * F_ * 4 > 232_448:
        raise ValueError(f"a window of {win_rows} x {F_} float32 exceeds a block's 227 KB of shared memory")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def window_take_reference(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain E1: ``win[idx]`` for ``idx (blocks, rows)``, flattened."""
    return win[idx.reshape(-1).long()]


def window_take(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E1: rows ``win[idx[b, r]]`` gathered by block b from its staged copy
    of the window ``win (M, F)``; ``(blocks * rows, F)``."""
    if not _on_card("P-E1", win, idx):
        return window_take_reference(win, idx)
    _check_window(win.shape[0], win.shape[1])
    blocks, rows = idx.shape
    out = torch.empty(blocks * rows, win.shape[1], dtype=win.dtype, device=win.device)
    lib = _library()
    err = lib.grl_probe_window_gather(win.data_ptr(), idx.data_ptr(), out.data_ptr(), win.shape[0],
                                      win.shape[1], rows, blocks, blocks, win.device.index, _stream(win))
    _build.check_launch(lib, err, "P-E1")
    window_take.launches += 1
    return out


def window_take_along_reference(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain E2: ``win[idx, arange(F)]`` for ``idx (blocks, rows, F)``."""
    idx = idx.reshape(-1, win.shape[1]).long()
    return win[idx, torch.arange(win.shape[1], device=win.device)]


def window_take_along(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E2: ``out[r, f] = win[idx[r, f], f]``, block b taking rows ``idx[b]``
    of ``idx (blocks, rows, F)`` from its staged window; ``(blocks*rows, F)``."""
    if not _on_card("P-E2", win, idx):
        return window_take_along_reference(win, idx)
    _check_window(win.shape[0], win.shape[1])
    blocks, rows, F_ = idx.shape
    if F_ != win.shape[1]:
        raise ValueError(f"idx has {F_} columns for a window {win.shape[1]} wide")
    out = torch.empty(blocks * rows, F_, dtype=win.dtype, device=win.device)
    lib = _library()
    err = lib.grl_probe_window_take_along(win.data_ptr(), idx.data_ptr(), out.data_ptr(), win.shape[0],
                                          F_, rows, blocks, win.device.index, _stream(win))
    _build.check_launch(lib, err, "P-E2")
    window_take_along.launches += 1
    return out


def windowed_stream_reference(V: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain F: ``V[window_base + idx]`` for ``idx (windows, rows)`` local to
    windows of ``V.shape[0] // windows`` rows."""
    windows = idx.shape[0]
    base = torch.arange(windows, device=V.device)[:, None] * (V.shape[0] // windows)
    return V[(base + idx.long()).reshape(-1)]


def windowed_stream(V: torch.Tensor, idx: torch.Tensor, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """F: window i of V (``V.shape[0] // windows`` rows) streamed into shared
    memory, then its ``idx[i]`` rows gathered from it, ``block_rows`` a
    block; ``(windows * rows, F)``."""
    if not _on_card("P-F", V, idx):
        return windowed_stream_reference(V, idx)
    windows, rows = idx.shape
    window_rows = V.shape[0] // windows
    _check_window(window_rows, V.shape[1])
    if rows % block_rows:
        raise ValueError(f"{rows} rows a window do not split into blocks of {block_rows}")
    blocks_per_window = rows // block_rows
    out = torch.empty(windows * rows, V.shape[1], dtype=V.dtype, device=V.device)
    lib = _library()
    err = lib.grl_probe_window_gather(V.data_ptr(), idx.data_ptr(), out.data_ptr(), window_rows,
                                      V.shape[1], block_rows, windows * blocks_per_window,
                                      blocks_per_window, V.device.index, _stream(V))
    _build.check_launch(lib, err, "P-F")
    windowed_stream.launches += 1
    return out


def row_dma_sum_reference(V: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain G: ``V[idx].view(blocks, rows, F).sum(1)`` in float32."""
    return V[idx.reshape(-1).long()].view(*idx.shape, V.shape[1]).float().sum(1)


def row_dma_sum(V: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G: block b sums rows ``V[idx[b, j]]`` copied one by one through a
    ring of bulk copies; ``(blocks, F)`` float32."""
    if not _on_card("P-G", V, idx):
        return row_dma_sum_reference(V, idx)
    if V.shape[1] > 512:
        raise ValueError(f"CUDA P-G sums rows of at most 512 floats, not {V.shape[1]}")
    blocks, rows = idx.shape
    out = torch.empty(blocks, V.shape[1], dtype=torch.float32, device=V.device)
    lib = _library()
    err = lib.grl_probe_row_dma_sum(V.data_ptr(), idx.data_ptr(), out.data_ptr(), V.shape[1], rows,
                                    blocks, V.device.index, _stream(V))
    _build.check_launch(lib, err, "P-G")
    row_dma_sum.launches += 1
    return out


KERNELS = {"E1": window_take, "E2": window_take_along, "F": windowed_stream, "G": row_dma_sum}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


reset_launches()


# ---------------------------------------------------------------------------
# Inputs, checks and timing
# ---------------------------------------------------------------------------
def make_inputs(device, quick: bool = False, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Every probe's operands on ``device``, drawn from ``RandomState(seed)``
    in the script's order. ``quick`` gathers a sixteenth of the rows."""
    device = torch.device(device)
    cut = QUICK_DIVISOR if quick else 1
    edges = E // cut
    rng = np.random.RandomState(seed)

    def put(array, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device=device, dtype=dtype)

    V32 = put(rng.randn(N, F).astype(np.float32))
    idx_rand = rng.randint(0, N, edges).astype(np.int32)
    blocks = edges // 256
    base = (rng.randint(0, max(N // 2048, 1), blocks) * 2048)[:, None]
    semi = np.minimum((base + rng.randint(0, 2048, (blocks, 256))).ravel(), N - 1)
    inputs = {
        "V32": V32, "V16": V32.to(torch.bfloat16), "idx_rand": put(idx_rand),
        "idx_sorted": put(np.sort(idx_rand)), "idx_semi": put(semi, torch.int32),
    }
    if not quick:
        for width in (256, 512):
            rows = N // (width // F)
            inputs[f"V_w{width}"] = put(rng.randn(rows, width).astype(np.float32))
            inputs[f"idx_w{width}"] = put(rng.randint(0, rows, edges).astype(np.int32))
    grid = edges // BLOCK_ROWS
    inputs["win"] = V32[:WINDOW_ROWS]
    inputs["idx_e1"] = put(rng.randint(0, WINDOW_ROWS, (grid, BLOCK_ROWS)).astype(np.int32))
    per_row = put(rng.randint(0, WINDOW_ROWS, (grid, BLOCK_ROWS, 1)).astype(np.int32))
    inputs["idx_e2"] = per_row.expand(grid, BLOCK_ROWS, F).contiguous()
    windows = F_WINDOWS // cut
    inputs["V_f"] = V32[: windows * WINDOW_ROWS]
    inputs["idx_f"] = put(rng.randint(0, WINDOW_ROWS, (windows, F_WINDOW_GATHERS)).astype(np.int32))
    fill = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 132
    inputs["idx_g"] = put(rng.randint(0, N, (G_BLOCKS, G_ROWS)).astype(np.int32))
    inputs["idx_g_fill"] = put(rng.randint(0, N, (fill, G_ROWS)).astype(np.int32))
    return inputs


def probe_calls(inputs: Dict[str, torch.Tensor]):
    """``{name: (kernel call, plain call, library call, rows gathered, bytes
    moved)}`` for E1, E2, F, G and G at one block per SM. ``bytes`` counts
    each input read once and each output written once."""
    win, V32, Vf = inputs["win"], inputs["V32"], inputs["V_f"]
    idx_e1, idx_e2, idx_f = inputs["idx_e1"], inputs["idx_e2"], inputs["idx_f"]
    rows_e = idx_e1.numel()
    windows = idx_f.shape[0]
    f_global = ((torch.arange(windows, device=Vf.device)[:, None] * WINDOW_ROWS) + idx_f).reshape(-1)
    e2_long = idx_e2.view(-1, F).long()
    calls = {
        "E1": (lambda: window_take(win, idx_e1), lambda: window_take_reference(win, idx_e1),
               lambda: torch.index_select(win, 0, idx_e1.view(-1)), rows_e,
               4 * (win.numel() + rows_e + rows_e * F)),
        "E2": (lambda: window_take_along(win, idx_e2), lambda: window_take_along_reference(win, idx_e2),
               lambda: torch.gather(win, 0, e2_long), rows_e,
               4 * (win.numel() + 2 * idx_e2.numel())),
        "F": (lambda: windowed_stream(Vf, idx_f), lambda: windowed_stream_reference(Vf, idx_f),
              lambda: torch.index_select(Vf, 0, f_global), idx_f.numel(),
              4 * (Vf.numel() + idx_f.numel() + idx_f.numel() * F)),
    }
    for name, idx in (("G", inputs["idx_g"]), ("G_fill", inputs["idx_g_fill"])):
        calls[name] = (
            lambda idx=idx: row_dma_sum(V32, idx), lambda idx=idx: row_dma_sum_reference(V32, idx),
            lambda idx=idx: torch.nn.functional.embedding_bag(idx, V32, mode="sum"),
            idx.numel(), 4 * (idx.numel() * F + idx.numel() + idx.shape[0] * F),
        )
    return calls


def check_kernels(inputs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each kernel against its plain version on ``inputs``: E1, E2 and F
    exactly, G within ``G_TOLERANCE`` of the largest sum. Returns the max
    abs errors; raises on a mismatch."""
    errors = {}
    for name, (kernel, plain, _, _, _) in probe_calls(inputs).items():
        out, ref = kernel(), plain()
        if out.shape != ref.shape or out.dtype != ref.dtype or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"P-{name}: {tuple(out.shape)} {out.dtype}, plain {tuple(ref.shape)} {ref.dtype}")
        errors[name] = err = float((out - ref).abs().max())
        limit = G_TOLERANCE * float(ref.abs().max()) if name.startswith("G") else 0.0
        if err > limit:
            raise AssertionError(f"P-{name} disagrees with its plain version: max abs err {err:.3e} > {limit:.3e}")
    return errors


def time_ms(fn: Callable[[], object], flush: Optional[torch.Tensor], reps: int = REPS) -> float:
    """Median time of one call in ms: CUDA events around single calls with
    ``flush`` (a buffer larger than the L2) zeroed before each, or the host
    clock when ``flush`` is None (CPU tensors)."""
    for _ in range(3):
        fn()
    if flush is None:
        samples = []
        for _ in range(reps):
            start = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - start) * 1e3)
        return statistics.median(samples)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def hbm_bytes_per_s(device: torch.device) -> Optional[float]:
    """The card's data-sheet HBM rate, or None (CPU, or an unknown card)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((rate for key, rate in HBM_BYTES_PER_S.items() if key in name), None)


def measure(inputs: Dict[str, torch.Tensor], quick: bool = False) -> dict:
    """Time every probe on ``inputs``. Returns the script's record, the
    bytes each probe moves, and for E1, E2, F, G: the kernel, plain and
    library times and the bound."""
    V32 = inputs["V32"]
    device = V32.device
    on_card = device.type == "cuda"
    # 256 MiB, five times the H100's 50 MB L2, zeroed before each timed call.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device) if on_card else None
    reps = REPS if on_card else 3
    hbm = hbm_bytes_per_s(device)
    results, gb_per_s, kernels = {}, {}, {}

    def record(name, rows, ms, nbytes):
        results[name] = round(rows / (ms / 1e3) / 1e6, 1)
        gb_per_s[name] = round(nbytes / (ms / 1e3) / 1e9, 1)
        print(f"[probe] {name}: {results[name]} M rows/s, {gb_per_s[name]} GB/s ({ms:.4f} ms)",
              file=sys.stderr, flush=True)

    library = [("A_index_select_random_f32", "V32", "idx_rand"), ("B1_index_select_sorted_f32", "V32", "idx_sorted"),
               ("B2_index_select_semilocal_f32", "V32", "idx_semi"), ("C_index_select_random_bf16", "V16", "idx_rand")]
    if not quick:
        library += [(f"D_index_select_random_f32_w{w}", f"V_w{w}", f"idx_w{w}") for w in (256, 512)]
    for name, src, idx in library:
        V, I = inputs[src], inputs[idx]
        ms = time_ms(lambda: torch.index_select(V, 0, I), flush, reps)
        record(name, I.numel(), ms, I.numel() * (V.shape[1] * V.element_size() * 2 + 4))

    names = {"E1": "E1_cuda_smem_take", "E2": "E2_cuda_smem_take_along", "F": "F_cuda_windowed_stream",
             "G": "G_cuda_row_dma", "G_fill": f"G_cuda_row_dma_{inputs['idx_g_fill'].shape[0]}_blocks"}
    for key, (kernel, plain, lib_call, rows, nbytes) in probe_calls(inputs).items():
        ms = time_ms(kernel, flush, reps)
        record(names[key], rows, ms, nbytes)
        bound_ms = nbytes / hbm * 1e3 if hbm else None
        kernels[key] = {
            "name": names[key], "rows": rows, "bytes": nbytes, "ms": ms,
            "plain_ms": time_ms(plain, flush, reps), "library_ms": time_ms(lib_call, flush, reps),
            "bound_ms": bound_ms, "bound_by": "bytes",
        }
    return {
        "unit": "M rows/s (row = 512 B f32 / 256 B bf16)",
        "shapes": {"N": N, "F": F, "E": E // (QUICK_DIVISOR if quick else 1), "window_rows": WINDOW_ROWS,
                   "block_rows": BLOCK_ROWS, "F_windows": inputs["idx_f"].shape[0],
                   "F_rows_per_window": F_WINDOW_GATHERS, "G_rows_per_block": G_ROWS,
                   "G_blocks": [G_BLOCKS, inputs["idx_g_fill"].shape[0]]},
        "hbm_peak_rows_per_s_f32": round(hbm / (F * 4) / 1e6, 1) if hbm else None,
        "results": results,
        "failures": None,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "gb_per_s": gb_per_s,
        "kernels": kernels,
    }


def run(device, quick: bool = False) -> dict:
    """Build the inputs, hold every kernel against its plain version, then
    time every probe; the record of :func:`measure` with the errors."""
    inputs = make_inputs(device, quick)
    errors = check_kernels(inputs)
    out = measure(inputs, quick)
    for key, err in errors.items():
        out["kernels"][key]["max_abs_err"] = err
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true", help="skip D and gather a sixteenth of the rows")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no GPU visible: pass --device cpu to run the plain versions on the CPU")
    print(json.dumps(run(device, args.quick)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
