"""K7's launch plan (``grl_torch.ops.tile.launch_plan``) on the host.

The persistent routes of ``csrc/tile.cu`` walk a work list the host deals
out; these tests hold, without a card, what the kernel relies on: the
route each (tile dtype, operand dtype) takes, the ring's shared memory
within the H100's 232,448 bytes with at least two stages, a work list that
covers every (block, part, column chunk) exactly once, CTAs whose loads
differ by at most one item, and the source and output geometry of each
direction equal to the views the plain version (``tile._layout``) takes.
The plans are the clustered graphs of tests/test_torch_tile.py's generator
(LPA order) and ``chip_smoke.py``'s K7_SMALL graph (B = 64, L = 3, the last
block ragged).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from grl_torch.ops import tile

SMEM_LIMIT = 232448


def clustered_edges(seed=0, N=700, L=2, E=9000, n_com=5, intra=0.8):
    """Community-clustered random edges over scattered node ids."""
    rng = np.random.RandomState(seed)
    com = rng.randint(0, n_com, N)
    send = rng.randint(0, N, E)
    order = np.argsort(com, kind="stable")
    starts = np.searchsorted(com[order], np.arange(n_com))
    counts = np.bincount(com, minlength=n_com)
    same = rng.rand(E) < intra
    pick = rng.randint(0, np.maximum(counts[com[send]], 1))
    recv = np.where(same, order[starts[com[send]] + pick], rng.randint(0, N, E))
    return (send, recv, rng.randint(0, L, E), rng.rand(E).astype(np.float32) + 0.5), N, L


def k7_small_edges():
    """chip_smoke.py's K7_SMALL graph: N = 1000, L = 3, 30,000 uniform edges."""
    import chip_smoke

    small = chip_smoke.K7_SMALL
    rng = np.random.RandomState(3)
    n, e = small["N"], small["E"]
    edges = (rng.randint(0, n, e), rng.randint(0, n, e), rng.randint(0, small["L"], e),
             (rng.rand(e) + 0.5).astype(np.float32))
    return edges, n, small["L"], small["tile_size"], small["tile_min_edges"]


@pytest.fixture(scope="module")
def kernels():
    """Tile kernels on the CPU by name: clustered at B = 64, 128 and 256
    (L = 2, LPA order), K7_SMALL's (B = 64, L = 3), bf16 and f32 tiles."""
    found = {}
    edges, N, L = clustered_edges(seed=1, N=1500, L=2, E=40000, n_com=6)
    for B, min_edges in ((64, 40), (128, 60), (256, 100)):
        for dtype in ("bfloat16", "float32"):
            found[f"clustered B={B} {dtype}"] = tile.TileGraphKernel(
                *edges, N, L, tile_size=B, tile_min_edges=min_edges, tile_dtype=dtype, plan_projected=True,
                device="cpu")
    edges, N, L, B, min_edges = k7_small_edges()
    for dtype in ("bfloat16", "float32"):
        found[f"K7_SMALL {dtype}"] = tile.TileGraphKernel(*edges, N, L, tile_size=B, tile_min_edges=min_edges,
                                                          reorder="none", tile_dtype=dtype, plan_projected=True,
                                                          device="cpu")
    for name, kernel in found.items():
        assert kernel.tiles_total > 0, name
    return found


NAMES = ["clustered B=64 bfloat16", "clustered B=128 bfloat16", "K7_SMALL bfloat16"]
WIDTHS = [8, 40, 64, 136, 256, 264, 512, 1000]
# The persistent route of each (tile dtype, operand dtype) pair.
ROUTE_OF = {("bfloat16", torch.bfloat16): "persistent", ("float32", torch.bfloat16): "persistent_f32tiles",
            ("bfloat16", torch.float32): "persistent_tf32", ("float32", torch.float32): "persistent_tf32"}


def plans_of(kernel):
    """(direction, plan) of the four directions."""
    return [(d, kernel.tables.bwd if "backward" in d else kernel.tables.fwd) for d in tile.DIRECTIONS]


@pytest.mark.parametrize("name", ["clustered B=128", "K7_SMALL"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tile_dtype", ["bfloat16", "float32"])
def test_route_follows_the_dtypes(kernels, name, tile_dtype, x_dtype):
    """Each dtype pair takes its own persistent route in every direction
    (bf16 x bf16 ``persistent``, float32 tiles under bf16 operands
    ``persistent_f32tiles``, float32 operands ``persistent_tf32``) with a
    work list; every other persistent route is refused for the pair, and
    the simple route (one CTA a 64 x 64 output tile, no work list) can be
    forced on every pair."""
    kernel = kernels[f"{name} {tile_dtype}"]
    own = ROUTE_OF[(tile_dtype, x_dtype)]
    for direction, plan in plans_of(kernel):
        layout = tile.launch_plan(plan, 256, x_dtype, direction)
        assert layout.route == own == tile.route_for(plan.tiles.dtype, x_dtype)
        assert layout.items.size > 0 and layout.stages >= 2
        for other in set(tile.ROUTES) - {own, "simple"}:
            with pytest.raises(ValueError, match="route"):
                tile.launch_plan(plan, 256, x_dtype, direction, route=other)
        simple = tile.launch_plan(plan, 256, x_dtype, direction, route="simple")
        assert simple.route == "simple" and simple.items.size == 0 and simple.stages == 0
        assert simple.ctas == simple.chunks * simple.parts * plan.nb == -(-256 // 64) * (plan.B // 64) * plan.nb


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_persistent_layout_fits_the_card(kernels, name, F):
    """BN covers F in equal chunks of at most 256 columns (multiples of 64),
    two consumers where 128 divides B, at least two stages, and the ring's
    shared memory the sum the kernel checks, within 232,448 bytes."""
    kernel = kernels[name]
    for direction, plan in plans_of(kernel):
        layout = tile.launch_plan(plan, F, torch.bfloat16, direction)
        assert layout.chunks == -(-F // 256) and layout.chunks * layout.BN >= F
        assert layout.BN == 64 * -(-(-(-F // layout.chunks)) // 64) <= 256  # ceil(F / chunks), rounded up to 64
        assert layout.consumers == (2 if plan.B % 128 == 0 else 1)
        assert layout.parts * 64 * layout.consumers == plan.B
        assert 2 <= layout.stages <= 8
        stage = 64 * 64 * 2 * (layout.consumers + layout.BN // 64)
        assert layout.smem_bytes == (1024 + layout.stages * stage + layout.consumers * 64 * 72 * 2
                                     + 16 * layout.stages)
        assert layout.smem_bytes == tile.persistent_smem(layout.BN, layout.consumers, layout.stages)
        assert layout.smem_bytes <= SMEM_LIMIT
        assert layout.stages == 8 or tile.persistent_smem(layout.BN, layout.consumers, layout.stages + 1) > SMEM_LIMIT


def test_main_path_layout():
    """The tile phase's shape (B = 128, F = 256 and 512): 256 columns, two
    consumers, four stages of 48 KB in 216,128 bytes, a CTA a SM."""
    from grl_torch.ops.tile import persistent_smem

    assert persistent_smem(256, 2, 4) == 216128 <= SMEM_LIMIT < persistent_smem(256, 2, 5)
    edges, N, L = clustered_edges(seed=4, N=3000, L=1, E=60000, n_com=20)
    kernel = tile.TileGraphKernel(*edges, N, L, tile_size=128, tile_min_edges=40, tile_dtype="bfloat16",
                                  device="cpu")
    for F, chunks in ((256, 1), (512, 2)):
        layout = tile.launch_plan(kernel.tables.fwd, F, torch.bfloat16, "forward", sms=132)
        assert (layout.BN, layout.chunks, layout.consumers, layout.stages) == (256, chunks, 2, 4)
        assert layout.ctas == min(132, kernel.nb * chunks)


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("F", [64, 512])
@pytest.mark.parametrize("name, x_dtype", [(name, torch.bfloat16) for name in NAMES]
                         + [("clustered B=128 float32", torch.bfloat16), ("K7_SMALL float32", torch.float32),
                            ("clustered B=64 bfloat16", torch.float32)])
def test_work_list_covers_every_item_once(kernels, name, x_dtype, F, sms):
    """Every (block, part, chunk) is one CTA's item exactly once, on every
    persistent route; each CTA's items are in list order; the CTAs' loads
    (tile slices plus one for each output written) differ by at most one
    item's."""
    kernel = kernels[name]
    for direction, plan in plans_of(kernel):
        layout = tile.launch_plan(plan, F, x_dtype, direction, sms=sms)
        total = plan.nb * layout.parts * layout.chunks
        assert layout.ctas == min(sms, total)
        assert layout.cta_first.dtype == np.int32 and layout.items.dtype == np.int32
        assert layout.cta_first[0] == 0 and layout.cta_first[-1] == total == len(layout.items)
        assert np.all(np.diff(layout.cta_first) >= 1)
        np.testing.assert_array_equal(np.sort(layout.items), np.arange(total))
        chunk = layout.items % layout.chunks
        part = layout.items // layout.chunks % layout.parts
        block = layout.items // (layout.chunks * layout.parts)
        assert len(set(zip(block.tolist(), part.tolist(), chunk.tolist()))) == total
        assert block.max() == plan.nb - 1
        writes = plan.L if layout.stacked else 1
        cost = plan.tile_counts.sum(axis=0)[block] * (plan.B // 64) + writes
        loads = np.add.reduceat(cost, layout.cta_first[:-1])
        for c in range(layout.ctas):
            mine = layout.items[layout.cta_first[c]:layout.cta_first[c + 1]]
            assert np.all(np.diff(mine) > 0)
        assert loads.max() - loads.min() <= cost.max()


@pytest.mark.parametrize("name", NAMES + ["K7_SMALL float32"])
def test_tile_counts_are_the_tables(kernels, name):
    """The host's (relation, block) tile counts, which weigh the items,
    equal the device tables' per-row counts through row_of_block."""
    kernel = kernels[name]
    for _, plan in plans_of(kernel):
        row_of_block = plan.row_of_block.view(plan.L, plan.nb).numpy()
        counts = plan.rows[:, 2].numpy()
        want = np.where(row_of_block >= 0, counts[np.maximum(row_of_block, 0)], 0)
        np.testing.assert_array_equal(plan.tile_counts, want)
        assert plan.tile_counts.sum() == plan.num_tiles == kernel.tiles_total


@pytest.mark.parametrize("F", [64, 136])
@pytest.mark.parametrize("name", NAMES + ["K7_SMALL float32"])
def test_geometry_is_the_plain_versions_layout(kernels, name, F):
    """The source each relation reads (X's element n * src_row_stride + r *
    src_rel_offset + c, the relation coordinate r where src_relations is L,
    0 where it is 1) and the output each relation writes are exactly the
    views tile._layout takes, in every direction, on both routes."""
    kernel = kernels[name]
    for direction, plan in plans_of(kernel):
        N, L = plan.num_nodes, plan.L
        rows, cols = {"forward": (N, F), "projected forward": (N * L, F), "backward": (N, L * F),
                      "projected backward": (N, F)}[direction]
        X = torch.arange(rows * cols, dtype=torch.float64).view(rows, cols)
        width, source, shape, stacked = tile._layout(direction, X, plan)
        for route in ("simple", "persistent") if plan.tiles.dtype == torch.bfloat16 else ("simple",):
            layout = tile.launch_plan(plan, F, torch.bfloat16 if route == "persistent" else torch.float32, direction,
                                      route=route)
            assert width == F and layout.stacked == stacked
            assert layout.src_relations in (1, L) and (layout.src_relations == L) == (layout.src_rel_offset != 0)
            n = torch.arange(N, dtype=torch.float64)[:, None]
            c = torch.arange(F, dtype=torch.float64)[None, :]
            for r in range(L):
                rel = r if layout.src_relations > 1 else 0
                assert torch.equal(source(r), n * layout.src_row_stride + rel * layout.src_rel_offset + c)
            out = torch.arange(int(np.prod(shape)), dtype=torch.float64).view(shape)
            if stacked:
                per_relation = out.view(N, L, F)
                for r in range(L):
                    assert torch.equal(per_relation[:, r], n * layout.out_row_stride + r * layout.out_rel_offset + c)
            else:
                assert shape == (N, F) and layout.out_rel_offset == 0
                assert torch.equal(out, n * layout.out_row_stride + c)


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("tile_dtype, x_dtype", list(ROUTE_OF))
def test_every_route_fits_the_card(kernels, tile_dtype, x_dtype, B, F):
    """Every dtype pair's persistent route at B = 64, 128 and 256 and F = 8
    to 1000: BN covers F in equal chunks of at most 256 columns (128 on the
    TF32 route), two consumers where 128 divides B, at least two ring
    stages and as many as fit, the stage and shared-memory sums the kernel
    checks (a bf16-operand stage: a 64 x 64 tile slice a consumer and
    BN / 64 bf16 source boxes; a TF32 stage: a slice of 64 rows of 32
    cells padded by 16 bytes a consumer and the TF32 hi and lo copies of
    32 x BN source values; epilogue boxes on bf16 outputs only), within
    232,448 bytes."""
    kernel = kernels[f"clustered B={B} {tile_dtype}"]
    route = ROUTE_OF[(tile_dtype, x_dtype)]
    cell = 4 if tile_dtype == "float32" else 2
    widest = 128 if route == "persistent_tf32" else 256
    for direction, plan in plans_of(kernel):
        assert plan.B == B
        layout = tile.launch_plan(plan, F, x_dtype, direction)
        assert layout.route == route
        assert layout.chunks == -(-F // widest) and layout.chunks * layout.BN >= F
        assert layout.BN % 64 == 0 and layout.BN == 64 * -(-(-(-F // layout.chunks)) // 64) <= widest
        assert layout.consumers == (2 if B % 128 == 0 else 1) and layout.parts * 64 * layout.consumers == B
        if route == "persistent_tf32":
            stage = layout.consumers * 64 * (32 * cell + 16) + 2 * layout.BN * 32 * 4
            epilogue = 0
        else:
            stage = layout.consumers * 64 * 64 * cell + layout.BN // 64 * 64 * 64 * 2
            epilogue = layout.consumers * 64 * 72 * 2
        assert tile.stage_bytes(layout.BN, layout.consumers, route, cell) == stage and stage % 1024 == 0
        assert layout.smem_bytes == 1024 + layout.stages * stage + epilogue + 16 * layout.stages
        assert layout.smem_bytes == tile.persistent_smem(layout.BN, layout.consumers, layout.stages, route, cell)
        assert 2 <= layout.stages <= 8 and layout.smem_bytes <= SMEM_LIMIT
        assert layout.stages == 8 or (tile.persistent_smem(layout.BN, layout.consumers, layout.stages + 1, route, cell)
                                      > SMEM_LIMIT)


def test_new_routes_main_path_layout():
    """The tile phase's shape (B = 128, F = 256 and 512) on float32 tiles:
    under bf16 operands BN 256 in 1 or 2 chunks, two consumers, three
    stages of 64 KB in 216,112 bytes (four do not fit); under float32
    operands (and on bf16 tiles) BN 128 in 2 or 4 chunks, four stages of
    50 KB in 205,888 bytes (five on bf16 tiles, of 42 KB in 216,144); a
    CTA a SM or a work item. launch_plan's persistent layout is
    persistent_layout's at its BN; a BN that a measurement forces lays out
    its own chunks and ring."""
    assert tile.persistent_smem(256, 2, 3, "persistent_f32tiles", 4) == 216112 <= SMEM_LIMIT
    assert tile.persistent_smem(256, 2, 4, "persistent_f32tiles", 4) > SMEM_LIMIT
    assert tile.persistent_smem(128, 2, 4, "persistent_tf32", 4) == 205888 <= SMEM_LIMIT
    assert tile.persistent_smem(128, 2, 5, "persistent_tf32", 2) == 216144 <= SMEM_LIMIT
    edges, N, L = clustered_edges(seed=4, N=3000, L=1, E=60000, n_com=20)
    found = {}
    for tile_dtype in ("float32", "bfloat16"):
        found[tile_dtype] = tile.TileGraphKernel(*edges, N, L, tile_size=128, tile_min_edges=40,
                                                 tile_dtype=tile_dtype, device="cpu").tables.fwd
    for F, chunks in ((256, 1), (512, 2)):
        layout = tile.launch_plan(found["float32"], F, torch.bfloat16, "forward", sms=132)
        assert (layout.route, layout.BN, layout.chunks, layout.consumers, layout.stages) == (
            "persistent_f32tiles", 256, chunks, 2, 3)
        assert layout.smem_bytes == 216112 and layout.ctas == min(132, len(layout.items))
        same = tile.persistent_layout(found["float32"], F, "persistent_f32tiles", 256, "forward", sms=132)
        assert same._replace(items=None, cta_first=None) == layout._replace(items=None, cta_first=None)
        assert np.array_equal(same.items, layout.items) and np.array_equal(same.cta_first, layout.cta_first)
        forced = tile.persistent_layout(found["float32"], F, "persistent_f32tiles", 128, "forward", sms=132)
        assert (forced.BN, forced.chunks, forced.stages) == (128, 2 * chunks, 4)
        for tile_dtype, stages in (("float32", 4), ("bfloat16", 5)):
            layout = tile.launch_plan(found[tile_dtype], F, torch.float32, "forward", sms=132)
            assert (layout.route, layout.BN, layout.chunks, layout.consumers, layout.stages) == (
                "persistent_tf32", 128, 2 * chunks, 2, stages)
    with pytest.raises(ValueError, match="BN"):
        tile.persistent_layout(found["float32"], 256, "persistent_tf32", 256)
    with pytest.raises(ValueError, match="BN"):
        tile.persistent_layout(found["float32"], 256, "persistent_f32tiles", 96)
    with pytest.raises(ValueError, match="BN"):
        tile.persistent_layout(found["float32"], 256, "simple", 128)


def test_refusals():
    edges, N, L, B, min_edges = k7_small_edges()
    kernel = tile.TileGraphKernel(*edges, N, L, tile_size=B, tile_min_edges=min_edges, reorder="none",
                                  tile_dtype="bfloat16", device="cpu")
    plan = kernel.tables.fwd
    with pytest.raises(ValueError, match="multiple of 8"):
        tile.launch_plan(plan, 36, torch.bfloat16)
    with pytest.raises(ValueError, match="direction"):
        tile.launch_plan(plan, 64, torch.bfloat16, "sideways")
    with pytest.raises(ValueError, match="route"):
        tile.launch_plan(plan, 64, torch.bfloat16, route="fastest")
    odd = plan._replace(B=96)
    with pytest.raises(ValueError, match="tile_size"):
        tile.launch_plan(odd, 64, torch.bfloat16)
