"""The launch plan of the bfloat16 K1/K2 (grl_torch/csrc/dropedge_sm90.cu).

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
from grl_torch.ops.relagg import check_sm90_shape, dropedge_plan

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
