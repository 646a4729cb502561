"""The launch plans of the bfloat16 K3/K1/K2 (grl_torch/csrc/dropedge_sm90.cu),
of the bfloat16 K3 at ragged shapes (grl_torch/csrc/relagg_ragged.cu) and
of the float32 K1/K2/K3 (grl_torch/csrc/dropedge_f32.cu), and K3's route.

``dropedge_plan`` is plain Python; the launcher passes its width BN and
K2's split S to the kernels, which compute their tiles from those. Here, on
the CPU: BN is a width the kernels are built for, S divides K2's 64-row
steps so every split walks whole steps, the cluster shape divides the grid,
S follows the split rule, and the shape check refuses what TMA cannot read.
These tests do not run the kernels: that every output element is written
once, with the right value, is shown on the card, where each kernel is held
to its plain version element by element (tests/test_torch_cuda.py,
chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from grl_torch.ops import relagg
from grl_torch.ops.relagg import (aggregate_plan, check_sm90_shape, dropedge_f32_forward_plan, dropedge_f32_plan,
                                  dropedge_plan, k3_route, ragged_plan)

B = 8
SHAPES = [(N, L, F) for N in (64, 192, 256) for L in (1, 6) for F in (64, 128, 256, 512, 1536)]


@pytest.mark.parametrize("N, L, F", SHAPES)
def test_width_is_one_the_kernels_take(N, L, F):
    """BN is min(F, 256) rounded up to 64, one of the four widths
    dropedge_sm90.cu is instantiated for, and its tiles span F."""
    plan = dropedge_plan(B, N, L, F)
    assert plan.BN in (64, 128, 192, 256) and plan.BN == min(-(-F // 64) * 64, 256)
    assert (plan.f_tiles - 1) * plan.BN < F <= plan.f_tiles * plan.BN


@pytest.mark.parametrize("N, L, F", SHAPES)
def test_split_is_the_smallest_that_fills_the_card(N, L, F):
    """S is the smallest divisor of the step count (at most 8) whose grid
    reaches 66 blocks, one for every two of the H100's 132 SMs, else the
    largest such divisor: every split walks the same whole 64-row steps,
    and the cluster axis of the grid is divisible by S."""
    plan = dropedge_plan(B, N, L, F)
    S = plan.splits
    assert 1 <= S <= 8 and plan.steps % S == 0
    assert plan.cluster == (S, 1, 1) and plan.backward_grid[0] % S == 0
    divisors = [s for s in range(1, 9) if plan.steps % s == 0]
    tiles = B * plan.m_tiles * plan.f_tiles
    filling = [s for s in divisors if tiles * s >= 66]
    assert S == (filling[0] if filling else divisors[-1])
    assert int(np.prod(plan.backward_grid)) == tiles * S


@pytest.mark.parametrize("F, BN, S, blocks", [(256, 256, 3, 96), (512, 256, 2, 128)])
def test_main_shape_fills_the_card(F, BN, S, blocks):
    """The flagship's shape, B=8 N=256 L=6: 24 row steps and 32 (F=256) or
    64 (F=512) output tiles of K2, split 3 and 2 ways, the fastest splits
    on the H100; K1's grid has 192 / 384 blocks."""
    plan = dropedge_plan(8, 256, 6, F)
    assert (plan.BN, plan.splits, plan.steps) == (BN, S, 24)
    assert int(np.prod(plan.backward_grid)) == blocks >= 66
    assert int(np.prod(plan.forward_grid)) == 192 * (F // 256) >= 132


@pytest.mark.parametrize("N, F, unmet", [(100, 64, "N % 8 == 0 (got N=100)"), (64, 44, "F % 8 == 0 (got F=44)"),
                                         (12, 4, "N % 8 == 0 (got N=12) and F % 8 == 0 (got F=4)")])
def test_shape_check_names_the_unmet_constraint(N, F, unmet):
    with pytest.raises(ValueError) as raised:
        check_sm90_shape(N, F)
    assert unmet in str(raised.value) and "TMA" in str(raised.value)
    with pytest.raises(ValueError):
        dropedge_plan(B, N, 6, F)
    check_sm90_shape(8, 8)


def test_shape_check_is_the_cuda_launchers_only():
    """On CPU tensors the wrappers take their plain versions, which take any
    N and F; on the card the same call raises (tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(0)
    V = torch.from_numpy(rng.randn(1, 12, 4).astype(np.float32)).to(torch.bfloat16)
    A = torch.from_numpy((rng.rand(1, 12, 2, 12) < 0.3).astype(np.float32)).to(torch.bfloat16)
    out = relagg.dropedge_aggregate(V, A, 3, 0.3)
    assert out.shape == (1, 12, 2, 4) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, relagg.dropedge_aggregate_reference(V, A, 3, 0.3))


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        dropedge_plan(0, 64, 6, 64)


# ---------------------------------------------------------------------------
# K3: the route by shape and its sm90 plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N, F, route", [(256, 256, "sm90"), (64, 512, "sm90"), (192, 1280, "sm90"),
                                         (8, 8, "sm90"), (230, 256, "ragged"), (256, 36, "ragged"),
                                         (100, 44, "ragged")])
def test_k3_route_follows_the_tma_shape_rule(N, F, route):
    """bf16 K3 takes dropedge_sm90.cu exactly where TMA can read its
    operands (check_sm90_shape passes), relagg_ragged.cu elsewhere, whose
    plan takes any shape; float32 K3 is dropedge_f32.cu's forward whatever
    the shape."""
    assert k3_route(torch.bfloat16, N, F) == route
    assert k3_route(torch.float32, N, F) == "float32"
    if route == "sm90":
        check_sm90_shape(N, F)
        aggregate_plan(B, N, 6, F)
    else:
        with pytest.raises(ValueError, match="% 8 == 0"):
            aggregate_plan(B, N, 6, F)
        assert ragged_plan(B, N, 6, F).forward_grid == (-(-F // 256), -(-N * 6 // 64), B)


def test_every_inference_bucket_takes_the_sm90_route():
    """KVInference pads to multiples of 64 and the trunk's widths are
    multiples of 8 at every net_size the configs use: serving never takes
    the ragged route."""
    for N in range(64, 1025, 64):
        for F in (64, 128, 256, 512):
            assert k3_route(torch.bfloat16, N, F) == "sm90"


@pytest.mark.parametrize("N, L, F", SHAPES)
def test_k3_plan_is_k1s_forward_layout(N, L, F):
    """K3 is K1's kernel with the mask compiled out: the same BN and the
    same forward grid, and no split."""
    plan, k1 = aggregate_plan(B, N, L, F), dropedge_plan(B, N, L, F)
    assert (plan.BN, plan.forward_grid) == (k1.BN, k1.forward_grid)
    assert not hasattr(plan, "splits")
    assert plan.forward_grid == (-(-F // plan.BN), -(-N * L // 64), B)


@pytest.mark.parametrize("F, BN, blocks", [(256, 256, 192), (512, 256, 384)])
def test_k3_main_shape_grid(F, BN, blocks):
    """The flagship's shape, B=8 N=256 L=6: 24 row tiles of 64 a batch;
    one BN = 256 column tile at F = 256 (192 blocks of ~82 KB, two an SM,
    one wave), two at F = 512."""
    plan = aggregate_plan(8, 256, 6, F)
    assert plan.BN == BN and plan.forward_grid == (F // 256, 24, 8)
    assert int(np.prod(plan.forward_grid)) == blocks


# ---------------------------------------------------------------------------
# The float32 K2 (dropedge_f32.cu)
# ---------------------------------------------------------------------------
F32_SHAPES = [(N, L, F) for N in (64, 192, 230, 256) for L in (1, 6) for F in (36, 64, 256, 512, 1280)]


# Blocks run at once in clusters of S = 1..8: one an SM of 132 by default,
# and what an H100 80GB HBM3 reports (cudaOccupancyMaxActiveClusters): its
# GPCs do not all divide into clusters of 3 to 8.
CAPACITIES = [(132,) * 8, (132, 132, 117, 120, 110, 102, 105, 120)]


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("N, L, F", F32_SHAPES)
def test_f32_split_walks_whole_steps(N, L, F, capacity):
    """S divides the ceil(N*L / 32) reduction steps and is at most 8; the
    cluster shape divides the grid; S minimises the waves of the blocks the
    card runs at once in clusters of S times each block's share of the
    steps (the smaller S on a tie); the tiles of 128 span N and F."""
    plan = dropedge_f32_plan(B, N, L, F, capacity)
    S = plan.splits
    assert 1 <= S <= 8 and plan.steps % S == 0 and plan.steps == -(-N * L // 32)
    assert plan.cluster == (S, 1, 1) and plan.grid[0] % S == 0
    assert (plan.m_tiles - 1) * 128 < N <= plan.m_tiles * 128
    assert (plan.f_tiles - 1) * 128 < F <= plan.f_tiles * 128
    tiles = B * plan.m_tiles * plan.f_tiles
    assert int(np.prod(plan.grid)) == tiles * S
    cost = {s: -(-tiles * s // capacity[s - 1]) / s for s in range(1, 9) if plan.steps % s == 0}
    assert cost[S] == min(cost.values()) and S == min(s for s, c in cost.items() if c == cost[S])
    assert plan.vec == (4 if N % 4 == 0 and F % 4 == 0 else 1)


@pytest.mark.parametrize("F, S, grid", [(256, 4, (8, 2, 8)), (512, 2, (8, 2, 8))])
def test_f32_main_shape_plan(F, S, grid):
    """B=8 N=256 L=6: 48 steps of 32 rows; 32 (F=256) or 64 (F=512) output
    tiles of 128 x 128, split 4 and 2 ways: 128 blocks, one wave of the
    card's 132 slots, in clusters of S."""
    plan = dropedge_f32_plan(8, 256, 6, F)
    assert (plan.steps, plan.splits, plan.grid, plan.cluster, plan.vec) == (48, S, grid, (S, 1, 1), 4)
    assert int(np.prod(plan.grid)) == 128 <= 132


@pytest.mark.parametrize("F, S", [(256, 3), (512, 2)])
def test_f32_split_follows_the_cards_capacity(F, S):
    """The H100 fits only 120 blocks at once in clusters of 4, so the main
    shape's 128 blocks at S = 4 would take two waves: S = 3 (96 blocks)
    walks 16 of the 48 steps in one. At F = 512, S = 2 (128 blocks) stays."""
    plan = dropedge_f32_plan(8, 256, 6, F, CAPACITIES[1])
    assert plan.splits == S and int(np.prod(plan.grid)) <= CAPACITIES[1][S - 1]


def test_f32_ragged_plan():
    """N = 230 (a trainer padded at quantum 2): 1380 rows in 44 steps, split
    4 ways (128 blocks); 4-byte copies, since rows of 230 floats are not
    16-byte multiples."""
    plan = dropedge_f32_plan(8, 230, 6, 256)
    assert (plan.steps, plan.splits, plan.grid, plan.cluster, plan.vec) == (44, 4, (8, 2, 8), (4, 1, 1), 1)


def test_f32_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        dropedge_f32_plan(8, 0, 6, 64)


# ---------------------------------------------------------------------------
# The bfloat16 K3 at ragged shapes (relagg_ragged.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N, F, BN, row_tiles, vec, v_tma", [
    (230, 256, 256, 22, 2, True), (231, 256, 256, 22, 1, True), (230, 512, 256, 22, 2, True),
    (231, 512, 256, 22, 1, True), (256, 250, 256, 24, 2, False), (230, 36, 64, 22, 2, False),
    (100, 44, 64, 10, 2, False), (99, 45, 64, 10, 1, False)])
def test_ragged_plan(N, F, BN, row_tiles, vec, v_tma):
    """K1's forward layout at any shape: BN is F rounded up to 64 (at most
    256; wgmma's n is a multiple of 8, and V's MN-major 128-byte swizzled
    boxes are 64 columns wide, so the copies zero-fill V past F and the
    epilogue stores columns < F), 64-row tiles of N*L (N = 230 and 231: 1380
    and 1386 rows, 22 tiles), 4-byte copies where N and F are even, V
    through TMA where F % 8 == 0."""
    plan = ragged_plan(B, N, 6, F)
    assert (plan.BN, plan.row_tiles, plan.vec, plan.v_tma) == (BN, row_tiles, vec, v_tma)
    assert plan.BN % 8 == 0 and plan.BN >= min(-(-F // 8) * 8, 256)
    assert (plan.f_tiles - 1) * plan.BN < F <= plan.f_tiles * plan.BN
    assert plan.forward_grid == (plan.f_tiles, row_tiles, B)


def test_ragged_main_shape_fills_one_wave():
    """N = 230, F = 256: 176 blocks of 128 threads at ~82 KB, two an SM of
    the H100's 132: one wave."""
    assert int(np.prod(ragged_plan(8, 230, 6, 256).forward_grid)) == 176 <= 2 * 132


def test_ragged_plan_refuses_empty_and_oversized_shapes():
    with pytest.raises(ValueError):
        ragged_plan(0, 230, 6, 256)
    with pytest.raises(ValueError):
        ragged_plan(8, 230, 6, 0)
    with pytest.raises(ValueError):
        ragged_plan(65536, 230, 6, 256)


# ---------------------------------------------------------------------------
# The float32 K1 and K3 (dropedge_f32.cu's forward)
# ---------------------------------------------------------------------------
# Blocks of the forward the card runs at once: one an SM of the H100 SXM's
# 132, and of the PCIe part's 114.
F32_SLOTS = [132, 114]


@pytest.mark.parametrize("slots", F32_SLOTS)
@pytest.mark.parametrize("N, L, F", F32_SHAPES)
def test_f32_forward_blocks_share_the_tiles(N, L, F, slots):
    """The 128 x 128 tiles span N*L and F, the reduction steps of 32 span
    N; the grid is one row of at most ``slots`` blocks, and walking tiles
    c, c + blocks, ... gives every block at least one tile and no block
    more than one tile past any other."""
    plan = dropedge_f32_forward_plan(B, N, L, F, slots)
    assert (plan.row_tiles - 1) * 128 < N * L <= plan.row_tiles * 128
    assert (plan.f_tiles - 1) * 128 < F <= plan.f_tiles * 128
    assert (plan.steps - 1) * 32 < N <= plan.steps * 32
    assert plan.tiles == B * plan.row_tiles * plan.f_tiles
    assert plan.grid == (plan.blocks, 1, 1) and 1 <= plan.blocks <= min(slots, plan.tiles)
    walked = [len(range(c, plan.tiles, plan.blocks)) for c in range(plan.blocks)]
    assert sum(walked) == plan.tiles and min(walked) >= 1 and max(walked) - min(walked) <= 1


@pytest.mark.parametrize("N, F, slots, tiles, blocks", [(256, 256, 132, 192, 132), (256, 512, 132, 384, 132),
                                                        (256, 256, 114, 192, 114), (230, 256, 132, 176, 132)])
def test_f32_forward_main_shape_plan(N, F, slots, tiles, blocks):
    """B=8 L=6: 1536 rows a batch (N = 256) in 12 tiles, or 1380 (N = 230)
    in 11, times F / 128 column tiles; 8 steps of 32 columns. More tiles
    than slots: every slot runs one block, which streams 1 to 3 tiles."""
    plan = dropedge_f32_forward_plan(8, N, 6, F, slots)
    assert (plan.steps, plan.tiles, plan.blocks, plan.grid) == (8, tiles, blocks, (blocks, 1, 1))


def test_f32_forward_few_tiles_take_one_block_each():
    """One batch of N = 512 at F = 128: 24 tiles, fewer than the slots, so
    24 blocks each walk one tile's 16 steps."""
    plan = dropedge_f32_forward_plan(1, 512, 6, 128, 132)
    assert (plan.tiles, plan.steps, plan.blocks, plan.grid) == (24, 16, 24, (24, 1, 1))


@pytest.mark.parametrize("N, F, vec", [(256, 256, 4), (230, 256, 2), (231, 256, 1), (256, 36, 4), (256, 250, 2),
                                       (64, 42, 2), (192, 512, 4), (230, 33, 1)])
def test_f32_forward_copy_width(N, F, vec):
    """16-byte copies where rows of A (N floats) and of V and out (F
    floats) are 16-byte multiples, 8-byte where they are 8-byte multiples,
    4-byte otherwise (the launcher also narrows the copies for an operand
    off a 16- or 8-byte boundary)."""
    assert dropedge_f32_forward_plan(B, N, 6, F).vec == vec


@pytest.mark.parametrize("N, F, steps, row_tiles, f_tiles", [(230, 256, 8, 11, 2), (231, 256, 8, 11, 2),
                                                             (230, 36, 8, 11, 1), (33, 129, 2, 2, 2)])
def test_f32_forward_ragged_plan(N, F, steps, row_tiles, f_tiles):
    """Any N and F: the last step, row tile and column tile are partial and
    zero-filled by the copies (N = 230: 1380 rows in 11 tiles, 230 columns
    in 8 steps)."""
    plan = dropedge_f32_forward_plan(B, N, 6, F)
    assert (plan.steps, plan.row_tiles, plan.f_tiles) == (steps, row_tiles, f_tiles)


@pytest.mark.parametrize("shape", [(0, 256, 6, 256), (8, 0, 6, 256), (8, 256, 0, 256), (8, 256, 6, 0)])
def test_f32_forward_plan_refuses_empty_shapes(shape):
    with pytest.raises(ValueError):
        dropedge_f32_forward_plan(*shape)
