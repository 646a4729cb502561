"""K4's layout on the card (``grl_torch.ops.sparse_attention.attention_launch``).

K4 (``csrc/sparse_attention.cu``) gives a group of lanes one receiver and
walks h in column slices (``grl_torch.ops.sparse.gather_slices``) whose
rows, with all of g, stay in the card's L2, but never in slice rows under
``MIN_SLICE_BYTES``, and in one slice where such a slice and g take more
than ``SLICED_L2_MULTIPLE`` times the L2, over one wave of blocks. The plan
is pure Python and is checked here without a card: a group covers a slice
row in whole 16-byte vectors and is at most 32 lanes, the slices cover F
exactly, a slice of h plus g fits the share unless a slice of the narrowest
row already does not, graphs too large for that take one slice, and a
hand-computed table holds at the arxiv shape. On the card (``tests/test_torch_cuda.py``) every slicing at the
plan's group gives the same bits.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from grl_torch.ops import sparse_attention
from grl_torch.ops.sparse import L2_SLICE_SHARE, slice_grid
from grl_torch.ops.sparse_attention import (BLOCKS_PER_SM, MIN_SLICE_BYTES, SLICED_L2_MULTIPLE, THREADS,
                                            attention_launch)

H100_L2 = 52_428_800  # bytes, as torch.cuda.get_device_properties reports the H100's
H100_SMS = 132
ARXIV_N = 169_343

# The arxiv shape, K = 16, at the H100's L2: the slices' share is 0.85 of
# it, 44,564,480 bytes. g takes N * 16 * itemsize of it: 5,418,976 bytes in
# bf16, 10,837,952 in float32, leaving 39,145,504 and 33,726,528. One
# 16-byte vector column of h is 2,709,488 bytes: 8 vectors (21,675,904)
# fit either, 16 (43,351,808) neither. 8 vectors are 128 bytes a row,
# widened to 256: 128 bf16 columns (F = 128 one slice; F = 264 slices of
# 128, the last of 8) or 64 float32 columns (F = 128 two slices; F = 264
# four and the last of 8), each a group of 16 lanes; a slice and g take
# 48,770,784 and 54,189,760 bytes, within twice the L2. 256 / 16 receivers
# a block need more blocks than one wave of 4 x 132. (itemsize, F) ->
# (group, slices, columns of each but the last, columns of the last,
# blocks).
ARXIV_TABLE = {
    (2, 128): (16, 1, 128, 128, 528),
    (2, 264): (16, 3, 128, 8, 528),
    (4, 128): (16, 2, 64, 64, 528),
    (4, 264): (16, 5, 64, 8, 528),
}

SHAPES = [
    (n, K, F, itemsize, l2)
    for n in (1000, ARXIV_N, 2_450_000, 5_000_000)
    for K, F in ((16, 128), (2, 16), (12, 264), (64, 1040))
    for itemsize in (2, 4)
    for l2 in (H100_L2, 4 * 2**20)
]


def plan_of(n, K, F, itemsize, l2):
    return attention_launch(n, K, F, itemsize, l2, H100_SMS)


@pytest.mark.parametrize("n, K, F, itemsize, l2", SHAPES)
def test_group_covers_a_slice_row_in_whole_vectors(n, K, F, itemsize, l2):
    launch = plan_of(n, K, F, itemsize, l2)
    vecs = launch.slices[0][1] * itemsize // 16
    group = launch.group
    assert group & (group - 1) == 0 and 1 <= group <= 32
    # The fewest lanes that give each vector of a slice row its own, at most a warp.
    assert group >= vecs or group == 32
    assert group == 1 or group // 2 < vecs
    # One wave of blocks at most, and no more blocks than the receivers fill.
    receivers = THREADS // group
    assert 1 <= launch.blocks <= H100_SMS * BLOCKS_PER_SM
    assert launch.blocks == H100_SMS * BLOCKS_PER_SM or launch.blocks * receivers >= n > (launch.blocks - 1) * receivers


@pytest.mark.parametrize("n, K, F, itemsize, l2", SHAPES)
def test_slices_cover_F_and_fit_with_g(n, K, F, itemsize, l2):
    launch = plan_of(n, K, F, itemsize, l2)
    plan = launch.slices
    per_vec = 16 // itemsize
    assert plan[0][0] == 0 and plan[-1][0] + plan[-1][1] == F
    assert all(c0 + cols == next_c0 for (c0, cols), (next_c0, _) in zip(plan, plan[1:]))
    assert all(cols > 0 and cols % per_vec == 0 for _, cols in plan)
    assert slice_grid(plan, F, itemsize) == (plan[0][1], len(plan))
    budget = L2_SLICE_SHARE * l2
    g_bytes = n * K * itemsize
    narrowest = min(F, MIN_SLICE_BYTES // itemsize)
    # No slice row is narrower than MIN_SLICE_BYTES, but the last where F ends.
    assert plan[0][1] >= narrowest
    if n * narrowest * itemsize + g_bytes > SLICED_L2_MULTIPLE * l2:
        assert plan == [(0, F)]
        return
    assert n * plan[0][1] * itemsize + g_bytes <= SLICED_L2_MULTIPLE * l2 or len(plan) == 1
    for _, cols in plan:
        assert n * cols * itemsize + g_bytes <= budget or cols <= narrowest
    if len(plan) == 1:
        assert n * F * itemsize + g_bytes <= budget or F <= MIN_SLICE_BYTES // itemsize
    else:
        # The widest power of two of vectors that fits, or the narrowest row.
        vecs = plan[0][1] // per_vec
        assert vecs & (vecs - 1) == 0
        assert plan[0][1] == narrowest or 2 * vecs * 16 * n + g_bytes > budget


@pytest.mark.parametrize("n, F, itemsize, slices", [
    (2_450_000, 128, 2, 1), (2_450_000, 128, 4, 1), (2_450_000, 264, 2, 1), (2_450_000, 264, 4, 1),
    (697_000, 128, 4, 1),
    # The arxiv graph twice over: float32 F = 128 and 256 in one slice
    # (a 64-column slice and g take 108,379,520 bytes), bf16 F = 256 in
    # slices of 128 columns (97,541,568 bytes).
    (338_686, 128, 4, 1), (338_686, 256, 4, 1), (338_686, 256, 2, 2),
    # 200,000 receivers: g 6.4 / 12.8 MB; the budget fits 128-byte slice
    # rows of h at most, and the plan keeps 256.
    (200_000, 128, 2, 1), (200_000, 256, 2, 2), (200_000, 128, 4, 2), (200_000, 256, 4, 4),
])
def test_slices_of_large_graphs(n, F, itemsize, slices):
    """Where a slice of 256-byte rows and g take more than twice the L2,
    one slice, with a lane for each vector of a row up to 32; else slices of
    256-byte rows at the least."""
    launch = plan_of(n, 16, F, itemsize, H100_L2)
    cols = F if slices == 1 else MIN_SLICE_BYTES // itemsize
    assert launch.slices == [(c, min(cols, F - c)) for c in range(0, F, cols)]
    assert launch.group == min(32, cols * itemsize // 16)


@pytest.mark.parametrize("itemsize, F", sorted(ARXIV_TABLE))
def test_arxiv_plan_is_the_hand_computed_table(itemsize, F):
    group, count, width, last, blocks = ARXIV_TABLE[(itemsize, F)]
    launch = attention_launch(ARXIV_N, 16, F, itemsize, H100_L2, H100_SMS)
    assert launch.group == group and launch.blocks == blocks
    assert launch.slices == [(k * width, width) for k in range(count - 1)] + [((count - 1) * width, last)]


def test_small_graphs_take_one_slice_and_fewer_blocks():
    """The card-test graphs fit the L2 whole: one slice, a group for the
    whole row, and only the blocks their receivers fill."""
    launch = plan_of(3001, 16, 128, 2, H100_L2)
    assert launch.slices == [(0, 128)] and launch.group == 16 and launch.blocks == 188
    assert plan_of(3001, 16, 1040, 4, H100_L2).group == 32


@pytest.mark.parametrize("change", [
    dict(slices=[(0, 64)]),  # does not cover F
    dict(slices=[(0, 32), (32, 96)]),  # the narrower is not the last
    dict(slices=[(0, 12), (12, 116)]),  # not whole 16-byte vectors
    dict(group=12),
    dict(group=64),
    dict(group=0),
    dict(group=3),
    dict(blocks=0),
])
def test_launch_refuses_a_layout_it_cannot_take(change):
    """Checked before anything is built or launched."""
    rng = np.random.RandomState(0)
    plan = sparse_attention.plan_attention(rng.randint(0, 50, 400), rng.randint(0, 50, 400), 50)
    f, g, h = torch.randn(50, 16), torch.randn(50, 16), torch.randn(50, 128)
    launch = attention_launch(50, 16, 128, 4, H100_L2, H100_SMS)._replace(**change)
    with pytest.raises(ValueError):
        sparse_attention._launch(f, g, h, plan, launch)
