"""The gather-rate probe P in grl_torch against scripts/probe_gather.py.

The script's Pallas kernels are closures of its ``main`` that Mosaic never
compiled; what they compute is ``jnp.take`` of window rows (E1, F),
``jnp.take_along_axis`` (E2) and a float32 sum of rows taken from V (G).
The port's plain versions, which the CUDA kernels are held to on the card
(tests/test_torch_cuda.py, chip_smoke.py), must equal that math on the
same inputs. The command line runs on the CPU and prints the script's
JSON keys.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from grl_torch.probes import gather

REPO = Path(__file__).resolve().parent.parent


def operands(seed=0, N=500, F=16, M=32, blocks=3, rows=64):
    rng = np.random.RandomState(seed)
    V = rng.randn(N, F).astype(np.float32)
    return rng, V, V[:M], rng.randint(0, M, (blocks, rows)).astype(np.int32)


def test_e1_is_a_take_of_window_rows():
    _, _, win, idx = operands()
    expected = np.concatenate([np.asarray(jnp.take(jnp.asarray(win), jnp.asarray(i), axis=0)) for i in idx])
    out = gather.window_take(torch.from_numpy(win), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), expected)


def test_e2_is_take_along_axis():
    rng, _, win, _ = operands(1)
    idx = rng.randint(0, win.shape[0], (3, 64, win.shape[1])).astype(np.int32)
    expected = np.asarray(jnp.take_along_axis(jnp.asarray(win), jnp.asarray(idx.reshape(-1, win.shape[1])),
                                              axis=0))
    out = gather.window_take_along(torch.from_numpy(win), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), expected)
    # The script's operand: one index a row, broadcast over the features,
    # which makes E2 a row gather.
    rows = np.broadcast_to(idx[..., :1], idx.shape).copy()
    np.testing.assert_array_equal(gather.window_take_along(torch.from_numpy(win), torch.from_numpy(rows)).numpy(),
                                  win[rows[..., 0].reshape(-1)])


def test_f_takes_each_block_from_its_own_window():
    rng, V, _, _ = operands(2)
    windows, window_rows = 4, 32
    Vw = V[: windows * window_rows]
    idx = rng.randint(0, window_rows, (windows, 128)).astype(np.int32)
    expected = np.concatenate([
        np.asarray(jnp.take(jnp.asarray(Vw[i * window_rows:(i + 1) * window_rows]), jnp.asarray(idx[i]), axis=0))
        for i in range(windows)
    ])
    out = gather.windowed_stream(torch.from_numpy(Vw), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), expected)


def test_g_sums_the_taken_rows_in_float32():
    rng, V, _, _ = operands(3)
    idx = rng.randint(0, V.shape[0], (5, 1024)).astype(np.int32)
    expected = np.asarray(jnp.take(jnp.asarray(V), jnp.asarray(idx), axis=0).sum(axis=1, dtype=jnp.float32))
    out = gather.row_dma_sum(torch.from_numpy(V), torch.from_numpy(idx))
    assert out.dtype == torch.float32 and out.shape == (5, V.shape[1])
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=gather.G_TOLERANCE * np.abs(expected).max())


@pytest.mark.parametrize("blocks, rows, F, plan", [
    (32, 1024, 128, (8, 128, 8, 8, 37888)),  # the script's grid: 8 CTAs an output row, 2 an SM
    (132, 1024, 128, (2, 512, 8, 8, 39424)),  # one output row an SM: 2 CTAs each
    (32, 1024, 512, (8, 128, 8, 6, 115584)),  # 2 KB rows: fewer in flight a warp, 2 CTAs still fit an SM
    (132, 1024, 512, (2, 512, 8, 5, 100672)),
    (7, 1001, 128, (8, 126, 8, 8, 37880)),  # 1001 rows over 8 CTAs: the last takes 119
    (5, 3, 16, (3, 1, 8, 8, 5124)),  # fewer rows than CTAs a row could take: one row a CTA
])
def test_row_dma_plan(blocks, rows, F, plan):
    """G's layout: the largest cluster (at most 8) whose CTAs still fit one
    wave of two CTAs an SM on 132 SMs, chunks covering the rows (the last
    CTA may take fewer), 8 warps, 8 rows in flight a warp or fewer where
    two CTAs' shared memory would not fit an SM."""
    got = gather.row_dma_plan(blocks, rows, F, 132)
    assert tuple(got) == plan
    assert (got.cluster - 1) * got.chunk < rows <= got.cluster * got.chunk
    assert blocks * got.cluster <= max(2 * 132, blocks)
    assert got.smem == gather.row_dma_smem(F, got.chunk, got.warps, got.depth)
    assert 2 * (got.smem + 1024) <= gather.SM_SMEM_BYTES
    assert 2 * (gather.row_dma_smem(F, got.chunk, got.warps, got.depth + 1) + 1024) > gather.SM_SMEM_BYTES \
        or got.depth == gather.G_DEPTH
    assert got.rows_in_flight(blocks) == blocks * got.cluster * got.warps * got.depth


def test_row_dma_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        gather.row_dma_plan(132, 60000, 512, 132)  # 30,000 indices a CTA: 120 KB


def test_wrappers_refuse_other_devices_and_oversized_windows():
    meta = torch.zeros(32, 16, device="meta")
    idx = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    for call in (lambda: gather.window_take(meta, idx), lambda: gather.windowed_stream(meta, idx),
                 lambda: gather.row_dma_sum(meta, idx),
                 lambda: gather.window_take_along(meta, idx.expand(2, 8).reshape(2, 8, 1))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(ValueError, match="227 KB"):
        gather._check_window(512, 128)
    gather._check_window(gather.WINDOW_ROWS, gather.F)  # the probe's window fits


def test_inputs_checks_and_probe_shapes_on_the_cpu():
    """The probe's own operands at --quick size: every plain version passes
    the probe's check, the totals are the script's cut by QUICK_DIVISOR, and
    the window fits a block."""
    inputs = gather.make_inputs("cpu", quick=True)
    errors = gather.check_kernels(inputs)
    assert set(errors) == {"E1", "E2", "F", "G", "G_fill"} and all(e == 0 for e in errors.values())
    edges = gather.E // gather.QUICK_DIVISOR
    assert inputs["idx_rand"].numel() == edges
    assert inputs["idx_e1"].shape == (edges // gather.BLOCK_ROWS, gather.BLOCK_ROWS)
    assert inputs["idx_e2"].shape == (edges // gather.BLOCK_ROWS, gather.BLOCK_ROWS, gather.F)
    assert inputs["idx_f"].shape == (gather.F_WINDOWS // gather.QUICK_DIVISOR, gather.F_WINDOW_GATHERS)
    assert int(inputs["idx_f"].max()) < gather.WINDOW_ROWS and inputs["win"].shape == (gather.WINDOW_ROWS, gather.F)
    assert inputs["idx_g"].shape == (gather.G_BLOCKS, gather.G_ROWS)


def test_command_line_prints_the_scripts_keys(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    result = subprocess.run(
        [sys.executable, "-m", "grl_torch.probes.gather", "--quick", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    record = json.loads(result.stdout.strip().splitlines()[-1])
    assert {"unit", "shapes", "hbm_peak_rows_per_s_f32", "results", "failures"} <= set(record)
    assert record["failures"] is None and record["device"] == "cpu"
    assert record["hbm_peak_rows_per_s_f32"] is None  # no device rate from a CPU run
    assert record["shapes"]["window_rows"] == gather.WINDOW_ROWS
    assert {"A_index_select_random_f32", "E1_cuda_smem_take", "E2_cuda_smem_take_along",
            "F_cuda_windowed_stream", "G_cuda_row_dma"} <= set(record["results"])
    assert not any(name.startswith("D_") for name in record["results"])  # --quick skips D
    assert all(v > 0 for v in record["results"].values())
    for kernel in record["kernels"].values():
        assert kernel["max_abs_err"] == 0.0 and kernel["bound_ms"] is None and kernel["device_ms"] > 0
    g = record["kernels"]["G"]
    plan = gather.row_dma_plan(gather.G_BLOCKS, gather.G_ROWS, gather.F, 132)
    assert {k: g[k] for k in plan._fields} == plan._asdict()
    assert g["rows_in_flight"] == plan.rows_in_flight(gather.G_BLOCKS)
