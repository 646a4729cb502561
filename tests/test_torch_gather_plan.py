"""The column-slice plan of K5 and K6 (``grl_torch.ops.sparse.gather_slices``).

K5 (``csrc/csr_spmm.cu``) and K6 (``csrc/ell.cu``) walk the gathered
operand X in column slices, all rows of one slice before the next, so that
the rows they gather stay in the card's L2. The plan is pure Python and is
checked here without a card: slices of whole 16-byte vectors that cover F
exactly, each within the L2 budget unless one vector column already
exceeds it, one slice where all of X fits, and a hand-computed table at
the arxiv shape. On the card (``tests/test_torch_cuda.py``) every plan
gives the same bits.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from grl_torch.ops import csr_spmm, ell
from grl_torch.ops.sparse import L2_SLICE_SHARE, gather_slices, slice_grid

H100_L2 = 52_428_800  # bytes, as torch.cuda.get_device_properties reports the H100's
ARXIV_N = 169_343

# The arxiv shape at the H100's L2: the budget is 0.85 of it, 44,564,480
# bytes; one 16-byte vector column of 169,343 rows is 2,709,488 bytes, so
# 16 fit (43,351,808 bytes) and the width is 16 vectors: 128 bf16 or 64
# float32 columns, 256 bytes of each row. (itemsize, F) -> (slices,
# columns of each but the last, columns of the last).
ARXIV_TABLE = {
    (2, 128): (1, 128, 128),
    (2, 256): (2, 128, 128),
    (2, 512): (4, 128, 128),
    (2, 264): (3, 128, 8),
    (4, 128): (2, 64, 64),
    (4, 256): (4, 64, 64),
    (4, 512): (8, 64, 64),
    (4, 264): (5, 64, 8),
}

SHAPES = [
    (n, F, itemsize, l2)
    for n in (1000, ARXIV_N, 50_000_000)
    for F in (8, 256, 264, 1040)
    for itemsize in (2, 4)
    for l2 in (H100_L2, 4 * 2**20)
]


@pytest.mark.parametrize("n, F, itemsize, l2", SHAPES)
def test_slices_cover_F_in_whole_vectors(n, F, itemsize, l2):
    plan = gather_slices(n, F, itemsize, l2)
    per_vec = 16 // itemsize
    assert plan[0][0] == 0
    assert all(c0 + cols == next_c0 for (c0, cols), (next_c0, _) in zip(plan, plan[1:]))
    assert plan[-1][0] + plan[-1][1] == F
    assert all(cols > 0 and cols % per_vec == 0 and c0 % per_vec == 0 for c0, cols in plan)
    # Equal slices but the last, which is no wider: what the kernels launch.
    assert slice_grid(plan, F, itemsize) == (plan[0][1], len(plan))


@pytest.mark.parametrize("n, F, itemsize, l2", SHAPES)
def test_each_slice_fits_the_budget_unless_one_vector_does_not(n, F, itemsize, l2):
    plan = gather_slices(n, F, itemsize, l2)
    budget = L2_SLICE_SHARE * l2
    one_vector = 16 * n
    for _, cols in plan:
        assert n * cols * itemsize <= budget or (cols * itemsize == 16 and one_vector > budget)
    if len(plan) > 1:
        # The widest power-of-two number of vectors that fits: twice it does not.
        vecs = plan[0][1] * itemsize // 16
        assert vecs & (vecs - 1) == 0
        assert 2 * vecs * one_vector > budget or one_vector > budget


@pytest.mark.parametrize("n, F, itemsize", [(2000, 256, 2), (2000, 1040, 4), (ARXIV_N, 64, 2),
                                            (ARXIV_N, 32, 4), (1, 8, 2)])
def test_X_that_fits_is_one_slice(n, F, itemsize):
    assert n * F * itemsize <= L2_SLICE_SHARE * H100_L2
    assert gather_slices(n, F, itemsize, H100_L2) == [(0, F)]


@pytest.mark.parametrize("itemsize, F", sorted(ARXIV_TABLE))
def test_arxiv_plan_is_the_hand_computed_table(itemsize, F):
    count, width, last = ARXIV_TABLE[(itemsize, F)]
    plan = gather_slices(ARXIV_N, F, itemsize, H100_L2)
    assert plan == [(k * width, width) for k in range(count - 1)] + [((count - 1) * width, last)]


@pytest.mark.parametrize("plan, F, itemsize", [
    ([], 256, 2),
    ([(0, 128)], 256, 2),  # does not cover F
    ([(0, 64), (64, 128), (192, 64)], 256, 2),  # unequal
    ([(0, 128), (128, 64), (192, 64)], 256, 2),  # the narrower is not the last
    ([(0, 12), (12, 12)], 24, 2),  # not whole 16-byte vectors
    ([(64, 64), (0, 64)], 128, 2),  # out of order
    ([(0, 96), (96, 96)], 160, 2),  # the last runs past F
])
def test_slice_grid_refuses_other_plans(plan, F, itemsize):
    with pytest.raises(ValueError):
        slice_grid(plan, F, itemsize)


def test_gather_slices_refuses_partial_vectors():
    with pytest.raises(ValueError):
        gather_slices(1000, 12, 2, H100_L2)


def small_graph():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 50, 400), rng.randint(0, 50, 400), rng.randint(0, 2, 400),
            (rng.rand(400) + 0.5).astype(np.float32))


@pytest.mark.parametrize("which", ["K5", "K6"])
def test_wrappers_refuse_a_plan_they_cannot_launch(which):
    """The plan is checked before anything is built or launched."""
    X = torch.randn(100, 64)
    if which == "K5":
        launch, layout = csr_spmm._launch, csr_spmm.CSRGraphKernel(*small_graph(), 50, 2).forward_layout
    else:
        launch, layout = ell._launch, ell.ELLGraphKernel(*small_graph(), 50, 2).tables.fwd
    with pytest.raises(ValueError, match="slices"):
        launch(X, layout, 0, 0.3, plan=[(0, 32), (32, 16), (48, 16)])
