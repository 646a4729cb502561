"""K7: the tile-dense hybrid — relational aggregation over dense adjacency
tiles plus an ELL residual, with DropEdge fused.

Counterpart of ``grl_tpu/ops/tile.py``. Where a graph has locally dense
structure, a B x B block of the adjacency holding many edges is stored as
one dense tile and applied as a matrix product against a B-row block of
features; every edge of a block below the density threshold stays on the
ELL gather tables (K6, :class:`grl_torch.ops.ell.ELLGraphKernel`). A
label-propagation node order (:func:`grl_torch.ops.reorder.lpa_order`)
packs communities into contiguous rows first, so that tiles exist at all;
the kernel exposes ``node_perm`` and the caller places features and labels
through it (``attach_kernel`` and ``FullGraphProcedure`` do). A graph on
which no block clears the threshold plans no tile and runs as pure ELL.

The host planner gives grl_tpu's tables exactly (:func:`_build_tile_tables`,
``tile.py:136-217``, and ``TileGraphKernel.__init__``, :298-419): per
relation and direction, block-rows bucketed by tile count into geometric
widths, each bucket's tiles inline in the K-concat layout ``(rows, B,
W*B)`` (a row's W tiles side by side along the contraction axis), each
row's source block ids ``col``, its ``out_block``, and ``inv_perm``, the
bucket-concatenated row of each block. The backward tables hold the same
tiles transposed, keyed ``(J, I)``. The planner's quirks are kept so that
plans match: the dense O((N/B)^2) bincount of the tile keys, one keep
decision for duplicate edges in one tile cell (their weights add in one
cell), and ``reorder: degree`` refused.

:class:`TilePlan` holds one direction of every relation on a device:
tiles, ``col`` and the per-row table (first slot, width, tile count)
raveled and concatenated over relations and buckets, and ``row_of_block``,
each (relation, block)'s table row (grl_tpu's ``inv_perm`` plus the
relation's first row; -1 where the relation has no tiles).
:func:`tile_accumulate` takes the plain version
(:func:`tile_apply_reference`, ``_apply_tables`` step by step: take, mask
through :func:`~grl_torch.ops.hashing.hash_keep_pair`, a float32 batched
product, the stitch by ``inv_perm``) for CPU tensors, and launches K7
(``grl_torch/csrc/tile.cu``) for CUDA tensors, or raises. One launch covers
every relation and bucket of a call, in one of :data:`DIRECTIONS`; launches
are counted as ``K7`` and ``K7 <direction>`` in :mod:`grl_torch.ops.launches`.
:func:`launch_plan` lays a launch out on the host: bf16 tiles under bf16
operands take the persistent route (a CTA a SM walking a list of work
items through a ring of staged tile and source slices, ``wgmma``), every
other dtype pair the simple route (a CTA an output tile, ``mma.sync`` or
FMA).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from grl_torch.ops import _build, launches
from grl_torch.ops.ell import ELLGraphKernel, _pad_rows
from grl_torch.ops.hashing import Seed, hash_keep_pair, keep_probability, seed_tensor
from grl_torch.ops.sparse import sm_count

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
# The directions of one call: which tables (forward or transposed) and how
# the source and the output are laid out (see :func:`_layout`).
DIRECTIONS = ("forward", "backward", "projected forward", "projected backward")
# CUDA K7 works on 64-row parts of a block (grl_torch/csrc/tile.cu).
_CUDA_ROWS = 64
_MAX_BLOCKS = 65535
# K7's routes (:func:`launch_plan`): "persistent" for bfloat16 tiles under
# bfloat16 operands, "simple" (a CTA an output tile of 64 x 64) for the rest.
ROUTES = ("persistent", "simple")
# The persistent route's staged boxes: 64 x 64 bfloat16 (8 KB), 128-byte
# rows; a work item's output columns BN (a multiple of 64, at most 256);
# its consumer warpgroups' bf16 staging boxes for the epilogue (64 rows of
# 64 + 8 columns each); the card's shared memory a block; the ring's depth
# at most.
_BOX_BYTES = 64 * 64 * 2
_MAX_BN = 256
_EPILOGUE_BYTES = 64 * 72 * 2
SMEM_LIMIT = 232448
_MAX_STAGES = 8
# The H100's SM count: the CTAs that launch_plan lays out by default.
H100_SMS = 132


def default_min_edges(tile_size: int, feature_dim: int = 128) -> int:
    """Edges per tile above which a block goes dense (``tile.py:82-97``).

    This is grl_tpu's threshold, kept so that the port plans the same
    tiles: ``max(32, ceil(B^2 / 30e9 * 1e9 / 4.7))`` (about ``B^2 / 141``),
    where grl_tpu equates its dense-tile and ELL per-edge costs with
    constants it measured on a TPU v5e. They are not rates of any GPU: an
    H100 threshold would be set from K7's and K6's own costs (ROADMAP.md).
    ``feature_dim`` is not used, as in grl_tpu.
    """
    del feature_dim
    entries_per_s = 30e9
    ell_edge_ns = 4.7
    tile_ns = tile_size * tile_size / entries_per_s * 1e9
    return max(32, int(np.ceil(tile_ns / ell_edge_ns)))


def _rel_seed_mix(r: int) -> int:
    """Relation r's seed mix (``tile.py:132-133``): the mask of relation r
    is keyed on ``seed ^ _rel_seed_mix(r)``."""
    return (0x85EB0001 * (r + 1)) & 0xFFFFFFFF


class _TileBucket(NamedTuple):
    tiles: np.ndarray  # (rows, B, W*B) float32: tile w at columns w*B..(w+1)*B; 0 in padding slots
    col: np.ndarray  # (rows, W) int32: source block of each slot; 0 for padding
    out_block: np.ndarray  # (rows,) int32: the block-row each row writes


class _DirectionPlan(NamedTuple):
    """One relation's planned direction on the host (``tile.py:113-115``)
    and each bucket row's tile count (its slots past the count are padding)."""

    buckets: Tuple[_TileBucket, ...]
    inv_perm: np.ndarray  # (nb,) int32: block -> bucket-concatenated row
    counts: Tuple[np.ndarray, ...]  # (rows,) int32 a bucket


def _build_tile_tables(out_blk: np.ndarray, src_blk: np.ndarray, out_loc: np.ndarray, src_loc: np.ndarray,
                       weights: np.ndarray, nb: int, B: int, dense_key_set: np.ndarray) -> _DirectionPlan:
    """One direction's bucketed inline-tile tables (``tile.py:136-217``).

    ``out_blk``/``src_blk``: per covered edge, its output and source block;
    ``out_loc``/``src_loc``: its coordinates within them;
    ``dense_key_set``: the sorted ``out_blk * nb + src_blk`` keys of the
    selected tiles. Every block-row lands in some bucket (tile-less rows in
    the width-1 bucket, as all padding). The tiles stay float32 here; they
    are cast to the storage dtype where they are placed on a device.
    """
    T = len(dense_key_set)
    dI = (dense_key_set // nb).astype(np.int64)
    dJ = (dense_key_set % nb).astype(np.int64)
    tiles_per_row = np.bincount(dI, minlength=nb)
    max_t = int(tiles_per_row.max()) if T else 0
    widths = [1]
    while widths[-1] < max(max_t, 1):
        widths.append(widths[-1] * 2)
    bucket_of_row = np.searchsorted(np.asarray(widths), tiles_per_row)

    # slot of each tile within its row (tiles are sorted by (I, J))
    starts = np.concatenate([[0], np.cumsum(tiles_per_row)])
    slot = np.arange(T, dtype=np.int64) - starts[dI]

    rows_by_bucket = np.argsort(bucket_of_row, kind="stable")
    bucket_counts = np.bincount(bucket_of_row, minlength=len(widths))
    bucket_starts = np.concatenate([[0], np.cumsum(bucket_counts)])
    rank_in_bucket = np.empty(nb, np.int64)
    rank_in_bucket[rows_by_bucket] = np.arange(nb) - bucket_starts[bucket_of_row[rows_by_bucket]]

    # map each covered edge to its tile id
    key = out_blk * nb + src_blk
    tile_id = np.searchsorted(dense_key_set, key)
    e_bucket = bucket_of_row[dI[tile_id]]

    buckets: List[_TileBucket] = []
    counts = []
    perm_parts = []
    for bi, W in enumerate(widths):
        n_rows = int(bucket_counts[bi])
        if n_rows == 0 and bi > 0:
            continue
        tiles = np.zeros((n_rows, B, W * B), np.float32)
        col = np.zeros((n_rows, W), np.int32)
        rows_here = rows_by_bucket[bucket_starts[bi]: bucket_starts[bi] + n_rows]
        tsel = bucket_of_row[dI] == bi
        col[rank_in_bucket[dI[tsel]], slot[tsel]] = dJ[tsel].astype(np.int32)
        # K-concat: slot w occupies columns w*B..(w+1)*B; duplicate edges
        # of one cell add into it.
        esel = e_bucket == bi
        t_e = tile_id[esel]
        np.add.at(tiles, (rank_in_bucket[dI[t_e]], out_loc[esel], slot[t_e] * B + src_loc[esel]), weights[esel])
        buckets.append(_TileBucket(tiles, col, rows_here.astype(np.int32)))
        counts.append(tiles_per_row[rows_here].astype(np.int32))
        perm_parts.append(rows_here)
    perm = np.concatenate(perm_parts)
    inv_perm = np.argsort(perm).astype(np.int32)
    return _DirectionPlan(tuple(buckets), inv_perm, tuple(counts))


class TilePlan(NamedTuple):
    """One planned direction of every relation on one device: K7's operand.

    Relation r's buckets follow relation r - 1's. ``rows[j]`` is table row
    j's (first slot, width W, tile count); its tiles are elements
    ``first_slot * B * B`` on of ``tiles``, one ``(B, W*B)`` K-concat row,
    its source blocks ``col[first_slot:first_slot + W]``, and it writes
    block ``out_block[j]``. ``row_of_block[r * nb + o]`` is the table row
    of relation r that writes block o, or -1 where r has no tiles.
    ``transposed`` marks the backward tables (the mask's key order).
    """

    tiles: torch.Tensor  # (slots * B * B,) in the tile dtype
    col: torch.Tensor  # int32 (slots,)
    out_block: torch.Tensor  # int32 (rows,)
    rows: torch.Tensor  # int32 (rows, 3)
    row_of_block: torch.Tensor  # int32 (L * nb,)
    rel_mix: torch.Tensor  # int32 (L,): the bits of _rel_seed_mix(r)
    shapes: Tuple[Optional[Tuple[Tuple[int, int], ...]], ...]  # per relation: (rows, W) a bucket, or None
    B: int
    nb: int
    num_nodes: int
    transposed: bool
    # On the host: each (relation, block)'s tile count, (L, nb), which
    # launch_plan weighs work items by; and the launches laid out so far,
    # by (route, F, operand dtype, direction, SMs), with their work lists
    # on the device.
    tile_counts: np.ndarray
    launch_cache: dict

    @property
    def L(self) -> int:
        return len(self.shapes)

    @property
    def num_slots(self) -> int:
        return int(self.col.numel())

    @property
    def num_tiles(self) -> int:
        return int(self.rows[:, 2].sum())

    def relation_views(self) -> List[Optional[Tuple[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                                                    torch.Tensor]]]:
        """Per relation: ``([(tiles (rows, B, W*B), col (rows, W),
        out_block (rows,)) a bucket], inv_perm (nb,) int64)``, or None."""
        B, views, row, slot = self.B, [], 0, 0
        for r, shapes in enumerate(self.shapes):
            if shapes is None:
                views.append(None)
                continue
            first, buckets = row, []
            for rows, W in shapes:
                tiles = self.tiles[slot * B * B:(slot + rows * W) * B * B].view(rows, B, W * B)
                buckets.append((tiles, self.col[slot:slot + rows * W].view(rows, W), self.out_block[row:row + rows]))
                row, slot = row + rows, slot + rows * W
            inv_perm = self.row_of_block[r * self.nb:(r + 1) * self.nb].long() - first
            views.append((buckets, inv_perm))
        return views


def place_plans(plans: Sequence[Optional[_DirectionPlan]], B: int, nb: int, num_nodes: int, transposed: bool,
                tile_dtype: torch.dtype, device=None) -> TilePlan:
    """Every relation's host plan of one direction as a :class:`TilePlan`
    on ``device``, the tiles cast to ``tile_dtype``."""
    tiles, cols, out_blocks, rows, shapes = [], [], [], [], []
    row_of_block = np.full((len(plans), nb), -1, np.int64)
    tile_counts = np.zeros((len(plans), nb), np.int32)
    row, slot = 0, 0
    for r, plan in enumerate(plans):
        if plan is None:
            shapes.append(None)
            continue
        row_of_block[r] = row + plan.inv_perm
        tile_counts[r] = np.concatenate(plan.counts)[plan.inv_perm]
        for bucket, count in zip(plan.buckets, plan.counts):
            n_rows, W = bucket.col.shape
            tiles.append(torch.from_numpy(bucket.tiles.reshape(-1)).to(tile_dtype))
            cols.append(bucket.col.reshape(-1))
            out_blocks.append(bucket.out_block)
            first = slot + np.arange(n_rows, dtype=np.int64) * W
            rows.append(np.stack([first, np.full(n_rows, W), count], 1))
            row, slot = row + n_rows, slot + n_rows * W
        shapes.append(tuple(b.col.shape for b in plan.buckets))
    if slot >= 2**31 or row >= 2**31:
        raise ValueError(f"{slot} tile slots in {row} rows: too many for K7's int32 tables")

    def put(array, dtype):
        return torch.from_numpy(np.ascontiguousarray(array)).to(dtype=dtype, device=device)

    def cat(parts, dtype):
        return put(np.concatenate(parts) if parts else np.zeros(0), dtype)

    mix = np.array([_rel_seed_mix(r) for r in range(len(plans))], np.uint32).view(np.int32)
    return TilePlan(
        tiles=(torch.cat(tiles) if tiles else torch.zeros(0, dtype=tile_dtype)).to(device),
        col=cat(cols, torch.int32), out_block=cat(out_blocks, torch.int32),
        rows=put(np.concatenate(rows) if rows else np.zeros((0, 3)), torch.int32),
        row_of_block=put(row_of_block.reshape(-1), torch.int32), rel_mix=put(mix, torch.int32),
        shapes=tuple(shapes), B=int(B), nb=int(nb), num_nodes=int(num_nodes), transposed=bool(transposed),
        tile_counts=tile_counts, launch_cache={},
    )


class TileTables(NamedTuple):
    """The planned graph (``tile.py:118-129``): the forward and transposed
    tile plans (None where no tile was selected), the ELL residual's tables,
    and ``proj``, ``()`` where the project-first mode was planned (the
    marker ``GraphConv`` reads), else None."""

    fwd: Optional[TilePlan]
    bwd: Optional[TilePlan]
    ell: object
    proj: object = None


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def _layout(direction: str, X: torch.Tensor, plan: TilePlan):
    """(F, source of relation r as an (N, F) view, output shape, stacked)
    of a call in ``direction`` (tile.py:481-499, 513-535, 540-562, 576-599)."""
    N, L = plan.num_nodes, plan.L
    if direction == "forward":
        F = X.shape[1]
        return F, lambda r: X[:N], (N, L * F), True
    if direction == "projected forward":
        F = X.shape[1]
        return F, lambda r: X[:N * L].view(N, L, F)[:, r], (N, F), False
    if direction == "backward":
        F = X.shape[1] // L
        return F, lambda r: X[:N].view(N, L, F)[:, r], (N, F), False
    if direction == "projected backward":
        F = X.shape[1]
        return F, lambda r: X[:N], (N * L, F), True
    raise ValueError(f"unknown K7 direction {direction!r}; expected one of {DIRECTIONS}")


def bucket_operands(buckets, Xblk: torch.Tensor, B: int, seed: Seed, rate: float, mix: int, transposed: bool):
    """Per bucket of one relation (``tile.py:248-266``): the tiles masked by
    the pair hash and rounded to Xblk's dtype, ``(rows, B, W*B)``, and the
    gathered source blocks, ``(rows, W*B, F)``."""
    F = Xblk.shape[-1]
    for tiles, col, out_block in buckets:
        rows, W = col.shape
        src = Xblk[col.long()].reshape(rows, W * B, F)
        masked = tiles.float()
        if rate > 0.0:
            a_id = torch.arange(B, device=Xblk.device).view(1, B, 1)
            within = torch.arange(W * B, device=Xblk.device) % B
            src_ids = col.long().repeat_interleave(B, dim=1)[:, None, :] * B + within  # (rows, 1, W*B)
            out_ids = out_block.long()[:, None, None] * B + a_id  # (rows, B, 1)
            recv, send = (src_ids, out_ids) if transposed else (out_ids, src_ids)
            masked = masked * hash_keep_pair(recv, send, seed, rate, mix)
        yield masked.to(Xblk.dtype), src


def relation_blocks(X: torch.Tensor, plan: TilePlan, direction: str):
    """(F, output shape, stacked, each relation's source as ``(nb, B, F)``
    blocks, rows past N zero) of a call in ``direction``."""
    F, source, shape, stacked = _layout(direction, X, plan)
    pad = plan.nb * plan.B - plan.num_nodes
    blocks = [torch.nn.functional.pad(source(r), (0, 0, 0, pad)).reshape(plan.nb, plan.B, F) for r in range(plan.L)]
    return F, shape, stacked, blocks


def _apply_relation(buckets, inv_perm: torch.Tensor, Xblk: torch.Tensor, B: int, seed: Seed, rate: float,
                    mix: int, transposed: bool) -> torch.Tensor:
    """One relation's ``_apply_tables`` (``tile.py:220-276``): a float32
    batched product a bucket (products of the operand dtype summed in
    float32, ``preferred_element_type``), stitched to block order,
    ``(nb, B, F)``."""
    parts = [torch.bmm(masked.float(), src.float())
             for masked, src in bucket_operands(buckets, Xblk, B, seed, rate, mix, transposed)]
    return torch.cat(parts, dim=0)[inv_perm]


def tile_apply_reference(X: torch.Tensor, plan: TilePlan, seed: Seed = 0, rate: float = 0.0,
                         direction: str = "forward") -> torch.Tensor:
    """Plain K7: every relation of ``plan`` applied to ``X`` laid out as
    ``direction`` says, in X's dtype: a stacked direction rounds each
    relation's float32 sum on its own (zeros for a relation with no tiles),
    a summed one adds the relations in float32 and rounds once."""
    keep_probability(rate)
    F, shape, stacked, blocks = relation_blocks(X, plan, direction)
    N, B, nb = plan.num_nodes, plan.B, plan.nb
    parts = []
    total = torch.zeros(nb * B, F, dtype=torch.float32, device=X.device)
    mixes = [mix & 0xFFFFFFFF for mix in plan.rel_mix.tolist()]
    for r, view in enumerate(plan.relation_views()):
        if view is None:
            parts.append(torch.zeros(N, F, dtype=X.dtype, device=X.device))
            continue
        out = _apply_relation(*view, blocks[r], B, seed, float(rate), mixes[r], plan.transposed)
        out = out.reshape(nb * B, F)
        if stacked:
            parts.append(out[:N].to(X.dtype))
        else:
            total = total + out
    if stacked:
        return torch.stack(parts, dim=1).reshape(shape)
    return total[:N].to(X.dtype)


# ---------------------------------------------------------------------------
# Launching the kernel
# ---------------------------------------------------------------------------
class LaunchPlan(NamedTuple):
    """One K7 launch laid out on the host (:func:`launch_plan`).

    The persistent route: ``ctas`` CTAs, each of one producer warpgroup and
    ``consumers`` consumer warpgroups (one a 64-row part of a work item);
    CTA i walks work items ``items[cta_first[i]:cta_first[i + 1]]``, each
    ``(block * parts + part) * chunks + chunk``: ``64 * consumers`` rows of
    an output block and ``BN`` of its columns, through a ring of ``stages``
    stages in ``smem_bytes`` of dynamic shared memory. The simple route:
    one CTA an output tile of 64 rows and ``BN`` = 64 columns, ``ctas`` of
    them, no work list. Either way the source of relation r starts at
    element ``r * src_rel_offset`` of X, row n at ``n * src_row_stride``
    (``src_relations`` is L where the relations read other columns or rows,
    else 1); out's row n at ``n * out_row_stride``, relation r at ``r *
    out_rel_offset`` where ``stacked``.
    """

    route: str
    BN: int
    chunks: int
    consumers: int
    parts: int
    stages: int
    smem_bytes: int
    ctas: int
    items: np.ndarray  # int32
    cta_first: np.ndarray  # int32 (ctas + 1,)
    src_relations: int
    src_row_stride: int
    src_rel_offset: int
    out_row_stride: int
    out_rel_offset: int
    stacked: bool


def stage_bytes(BN: int, consumers: int) -> int:
    """One stage of the persistent route's ring: a 64 x 64 tile slice for
    each consumer warpgroup and 64 source rows of BN columns."""
    return _BOX_BYTES * (consumers + BN // 64)


def persistent_smem(BN: int, consumers: int, stages: int) -> int:
    """Dynamic shared memory of a persistent CTA: 1024 bytes of alignment
    slack, the ring, the consumers' epilogue boxes and a full and an empty
    mbarrier a stage (csrc/tile.cu checks the same sum)."""
    return 1024 + stages * stage_bytes(BN, consumers) + consumers * _EPILOGUE_BYTES + 16 * stages


def _source_geometry(direction: str, L: int, F: int):
    """(src_relations, src_row_stride, src_rel_offset, out_row_stride,
    out_rel_offset, stacked) of a call in ``direction``, in elements, as
    :func:`_layout` views X and out."""
    stacked = direction in ("forward", "projected backward")
    if direction in ("forward", "projected backward"):
        src = (1, F, 0)  # every relation reads X (N, F)
    elif direction in ("projected forward", "backward"):
        src = (L, L * F, F)  # row n*L + r of (N*L, F), or column r*F of (N, L*F): one address
    else:
        raise ValueError(f"unknown K7 direction {direction!r}; expected one of {DIRECTIONS}")
    out = (L * F, F) if stacked else (F, 0)
    return src + out + (stacked,)


def _work_list(costs: np.ndarray, ctas: int) -> Tuple[np.ndarray, np.ndarray]:
    """Items 0.. in order, each given to the CTA with the least work so far
    (ties to the lowest index): CTAs run items of nearby blocks at the same
    time, and finish together. Returns (items, cta_first)."""
    owner = np.empty(len(costs), np.int64)
    heap = [(0, c) for c in range(ctas)]
    for i, cost in enumerate(costs.tolist()):
        load, c = heapq.heappop(heap)
        owner[i] = c
        heapq.heappush(heap, (load + cost, c))
    order = np.argsort(owner, kind="stable")
    first = np.concatenate([[0], np.cumsum(np.bincount(owner, minlength=ctas))])
    return order.astype(np.int32), first.astype(np.int32)


def launch_plan(plan: TilePlan, F: int, x_dtype: torch.dtype, direction: str = "forward", sms: int = H100_SMS,
                route: Optional[str] = None) -> LaunchPlan:
    """How K7 runs ``plan`` on operands of ``x_dtype`` with F columns in
    ``direction`` on a card of ``sms`` SMs, decided on the host alone.

    The route follows the dtypes: bfloat16 tiles under bfloat16 operands
    take the persistent route, anything else the simple one (``route``
    forces one; the persistent route takes only bf16 x bf16). Persistent:
    F in the fewest column chunks of at most 256, BN a chunk's width
    rounded up to 64; two consumer warpgroups where 128 divides B (a work
    item is 128 rows) else one; as many ring stages as fit the card's 232,448
    bytes (at most 8), one CTA a SM or one a work item where there are
    fewer. A work item weighs its tile slices (each tile's B / 64) plus one
    for each output it writes; :func:`_work_list` deals them out.
    """
    if F <= 0 or F % 8:
        raise ValueError(f"CUDA K7 needs F a positive multiple of 8, got {F}")
    if plan.B % _CUDA_ROWS:
        raise ValueError(f"CUDA K7 needs tile_size a multiple of {_CUDA_ROWS}, got {plan.B}")
    bf16 = plan.tiles.dtype == torch.bfloat16 and x_dtype == torch.bfloat16
    route = route or ("persistent" if bf16 else "simple")
    if route not in ROUTES or (route == "persistent" and not bf16):
        raise ValueError(f"K7 route {route!r} does not take {plan.tiles.dtype} tiles under {x_dtype} operands")
    L, B, nb = plan.L, plan.B, plan.nb
    geometry = _source_geometry(direction, L, F)
    empty = np.zeros(0, np.int32)
    if route == "simple":
        chunks, parts = -(-F // 64), B // _CUDA_ROWS
        return LaunchPlan(route, 64, chunks, 0, parts, 0, 0, chunks * parts * nb, empty, empty, *geometry)
    boxes = -(-F // 64)
    chunks = -(-boxes // (_MAX_BN // 64))
    BN = 64 * -(-boxes // chunks)
    consumers = 2 if B % 128 == 0 else 1
    parts = B // (64 * consumers)
    stages = min(_MAX_STAGES, (SMEM_LIMIT - 1024 - consumers * _EPILOGUE_BYTES) // (stage_bytes(BN, consumers) + 16))
    stacked = geometry[-1]
    block_cost = plan.tile_counts.sum(axis=0).astype(np.int64) * (B // 64) + (L if stacked else 1)
    costs = np.repeat(block_cost, parts * chunks)
    ctas = max(1, min(int(sms), len(costs)))
    items, cta_first = _work_list(costs, ctas)
    return LaunchPlan(route, BN, chunks, consumers, parts, stages, persistent_smem(BN, consumers, stages), ctas,
                      items, cta_first, *geometry)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built K7 library with its C signatures declared (once)."""
    lib = _build.load_library("tile")
    lib.grl_tile_apply.argtypes = (
        [ctypes.c_void_p] * 7  # tiles, col, rows, row_of_block, rel_mix, X, out
        + [ctypes.c_int] * 5  # num_nodes, nb, B, L, F
        + [ctypes.c_longlong] * 4  # src_row_stride, src_rel_offset, out_row_stride, out_rel_offset
        + [ctypes.c_int] * 5  # stack, transposed, tile_dtype, dtype, use_hash
        + [ctypes.c_void_p, ctypes.c_float]  # seed (a device pointer), keep
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_tile_apply.restype = ctypes.c_int
    lib.grl_tile_persistent.argtypes = (
        [ctypes.c_void_p] * 8  # tiles, col, rows, row_of_block, rel_mix, work, X, out
        + [ctypes.c_int] * 6  # num_nodes, nb, B, L, F, src_relations
        + [ctypes.c_longlong] * 4  # src_row_stride, src_rel_offset, out_row_stride, out_rel_offset
        + [ctypes.c_int] * 10  # stack, transposed, BN, chunks, consumers, parts, stages, smem_bytes, ctas, use_hash
        + [ctypes.c_void_p, ctypes.c_float]  # seed (a device pointer), keep
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_tile_persistent.restype = ctypes.c_int
    return lib


def _cached_launch(plan: TilePlan, F: int, X: torch.Tensor, direction: str, route: Optional[str]):
    """(launch plan, its work list on X's device as int32 cta_first then
    items) from the plan's cache, laid out at the first call. A call being
    captured into a CUDA graph cannot upload a new list: it raises."""
    sms = sm_count(X.device.index)
    key = (route, F, X.dtype, direction, sms)
    found = plan.launch_cache.get(key)
    if found is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"K7's launch for F={F} {direction} was not laid out before the CUDA graph capture; "
                               f"run the call once outside the capture first")
        layout = launch_plan(plan, F, X.dtype, direction, sms, route)
        work = torch.from_numpy(np.concatenate([layout.cta_first, layout.items])).to(X.device)
        found = plan.launch_cache[key] = (layout, work)
    return found


def _launch(X: torch.Tensor, plan: TilePlan, seed: Seed, rate: float, direction: str,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch K7 once on the current stream over every relation, on the
    route :func:`launch_plan` picks (or ``route``); no synchronisation."""
    if X.dtype not in _DTYPE_CODES or plan.tiles.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA K7 takes float32 or bfloat16 operands and tiles, not {X.dtype} / {plan.tiles.dtype}")
    F, _, shape, stacked = _layout(direction, X, plan)
    if X.dim() != 2 or not X.is_contiguous() or F % 8 or X.data_ptr() % 16:
        raise ValueError(f"CUDA K7 needs a contiguous, 16-byte aligned 2-D operand with F a multiple of 8; "
                         f"got {tuple(X.shape)} ({direction})")
    if plan.B % _CUDA_ROWS or plan.nb > _MAX_BLOCKS:
        raise ValueError(f"CUDA K7 needs tile_size a multiple of {_CUDA_ROWS} and at most {_MAX_BLOCKS} blocks; "
                         f"got B={plan.B}, {plan.nb} blocks")
    if plan.tiles.device != X.device:
        raise ValueError(f"tables on {plan.tiles.device} but X on {X.device}")
    layout, work = _cached_launch(plan, F, X, direction, route)
    out = torch.empty(shape, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    lib = _library()
    use_hash = float(rate) > 0.0
    seed = seed_tensor(seed, X.device) if use_hash else None
    tables = (plan.tiles.data_ptr(), plan.col.data_ptr(), plan.rows.data_ptr(), plan.row_of_block.data_ptr(),
              plan.rel_mix.data_ptr())
    geometry = (layout.src_row_stride, layout.src_rel_offset, layout.out_row_stride, layout.out_rel_offset)
    tail = (seed.data_ptr() if use_hash else None, keep_probability(rate),
            X.device.index, torch.cuda.current_stream(X.device).cuda_stream)
    if layout.route == "persistent":
        err = lib.grl_tile_persistent(
            *tables, work.data_ptr(), X.data_ptr(), out.data_ptr(), plan.num_nodes, plan.nb, plan.B, plan.L, F,
            layout.src_relations, *geometry, int(stacked), int(plan.transposed), layout.BN, layout.chunks,
            layout.consumers, layout.parts, layout.stages, layout.smem_bytes, layout.ctas, int(use_hash), *tail)
    else:
        err = lib.grl_tile_apply(
            *tables, X.data_ptr(), out.data_ptr(), plan.num_nodes, plan.nb, plan.B, plan.L, F, *geometry,
            int(stacked), int(plan.transposed), _DTYPE_CODES[plan.tiles.dtype], _DTYPE_CODES[X.dtype],
            int(use_hash), *tail)
    _build.check_launch(lib, err, "K7")
    return out


def tile_accumulate(X: torch.Tensor, plan: TilePlan, seed: Seed = 0, rate: float = 0.0,
                    direction: str = "forward") -> torch.Tensor:
    """Every relation of ``plan`` applied to ``X`` in ``direction``.

    CPU tensors take :func:`tile_apply_reference`; CUDA tensors launch K7
    (counted as ``K7`` and ``K7 <direction>`` in
    :mod:`grl_torch.ops.launches`) or raise.
    """
    keep_probability(rate)
    rows = {"forward": plan.num_nodes, "projected forward": plan.num_nodes * plan.L,
            "backward": plan.num_nodes, "projected backward": plan.num_nodes}.get(direction, 0)
    if X.shape[0] < rows:
        raise ValueError(f"X has {X.shape[0]} rows; K7 {direction} reads {rows}")
    if X.device.type == "cpu":
        return tile_apply_reference(X, plan, seed, rate, direction)
    if X.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or CPU tensors, not {X.device}")
    out = _launch(X, plan, seed, rate, direction)
    launches.count("K7", f"K7 {direction}")
    return out


# ---------------------------------------------------------------------------
# Differentiable aggregation
# ---------------------------------------------------------------------------
class _Tiles(torch.autograd.Function):
    """``tile_accumulate`` over ``fwd`` whose gradient is K7 over the
    transposed ``bwd``; the seed and the tables get none (``tile.py:509-535``,
    :572-599)."""

    @staticmethod
    def forward(ctx, X: torch.Tensor, fwd: TilePlan, bwd: TilePlan, seed: Seed, rate: float, projected: bool):
        ctx.bwd, ctx.seed, ctx.rate, ctx.projected, ctx.x_rows = bwd, seed, rate, projected, X.shape[0]
        return tile_accumulate(X, fwd, seed, rate, "projected forward" if projected else "forward")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dX = tile_accumulate(g.contiguous(), ctx.bwd, ctx.seed, ctx.rate,
                             "projected backward" if ctx.projected else "backward")
        return _pad_rows(dX, ctx.x_rows), None, None, None, None, None


def tile_aggregate(tables: TileTables, V: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """The tile-covered aggregation (``tile.py:502``): ``(N, L*F)`` from
    ``V (>= N, F)``, each relation rounded to V's dtype; differentiable in V."""
    return _Tiles.apply(V.contiguous(), tables.fwd, tables.bwd, seed, float(rate), False)


def tile_aggregate_projected(tables: TileTables, Vr: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Project-first tile aggregation (``tile.py:565``): ``Vr (>= N*L, C)``,
    row ``n*L + r`` = ``V[n] @ W_r``, to the relation-summed ``(N, C)``;
    differentiable in Vr. The masks are the standard path's."""
    return _Tiles.apply(Vr.contiguous(), tables.fwd, tables.bwd, seed, float(rate), True)


class TileGraphKernel:
    """Tile-dense + ELL hybrid aggregation of one static graph
    (``tile.py:279-479``), planned once on the host, held on ``device``.

    Same ``neighbor_aggregate(V, seed, rate)`` surface as
    :class:`~grl_torch.ops.ell.ELLGraphKernel`, with fused hash DropEdge:
    tile-covered edges draw the pair mask (K7), the residual edges K0's
    mask of their position in the residual's edge arrays (K6).

    Args beyond the shared kernel signature: ``tile_size`` (B),
    ``tile_min_edges`` (default :func:`default_min_edges`), ``reorder``
    (``"lpa"``, ``"rcm"`` or ``"none"``; ``node_perm`` maps an original
    node id to its row), ``tile_dtype`` (the tiles' storage dtype) and
    ``plan_projected``; the rest (``width_quantum``, 2 by default here, and
    ``bucket_growth``) plan the ELL residual. ``plan_seconds`` holds the
    host time of the reorder, the tile tables and the residual.
    """

    def __init__(
        self,
        senders: np.ndarray,
        receivers: np.ndarray,
        relations: np.ndarray,
        weights: np.ndarray,
        num_nodes: int,
        num_relations: int,
        tile_size: int = 256,
        tile_min_edges: Optional[int] = None,
        reorder: str = "lpa",
        feature_dim: int = 128,
        tile_dtype: str = "float32",
        plan_projected: bool = False,
        device=None,
        **ell_kwargs,
    ):
        # Residual rows average a few edges: the narrowest ELL bucket is 2 wide.
        ell_kwargs.setdefault("width_quantum", 2)
        self._plan_projected = bool(plan_projected)
        ell_kwargs.setdefault("plan_projected", self._plan_projected)
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        relations = np.asarray(relations, np.int64)
        weights = np.asarray(weights, np.float32)
        keep = weights != 0.0
        senders, receivers = senders[keep], receivers[keep]
        relations, weights = relations[keep], weights[keep]

        self.num_nodes = int(num_nodes)
        self.L = int(num_relations)
        B = int(tile_size)
        self.tile_size = B
        if tile_min_edges is None:
            tile_min_edges = default_min_edges(B, feature_dim)
        self.tile_min_edges = int(tile_min_edges)
        self.plan_seconds: Dict[str, float] = {}

        start = time.perf_counter()
        self.node_perm: Optional[np.ndarray] = None
        if reorder not in ("none", None) and len(senders):
            from grl_torch.ops import reorder as orders

            if reorder == "lpa":
                perm = orders.lpa_order(senders, receivers, self.num_nodes)
            elif reorder == "rcm":
                perm = orders.rcm_order(senders, receivers, self.num_nodes)
            else:
                raise ValueError(f"unknown reorder {reorder!r}")
            self.node_perm = perm
            senders = perm[senders]
            receivers = perm[receivers]
        self.plan_seconds["reorder"] = time.perf_counter() - start

        start = time.perf_counter()
        nb = -(-self.num_nodes // B)
        self.nb = nb
        fwd_plans: List[Optional[_DirectionPlan]] = []
        bwd_plans: List[Optional[_DirectionPlan]] = []
        covered = np.zeros(len(senders), bool)
        self.tiles_total = 0
        for r in range(self.L):
            rsel = relations == r
            s_r, d_r, w_r = senders[rsel], receivers[rsel], weights[rsel]
            I, J = d_r // B, s_r // B
            key = I * nb + J
            cnt = np.bincount(key, minlength=nb * nb)  # O((N/B)^2), as grl_tpu
            dense_keys = np.nonzero(cnt >= self.tile_min_edges)[0]
            if len(dense_keys) == 0:
                fwd_plans.append(None)
                bwd_plans.append(None)
                continue
            in_tile = cnt[key] >= self.tile_min_edges
            covered[np.nonzero(rsel)[0][in_tile]] = True
            self.tiles_total += len(dense_keys)
            sc, dc, wc = s_r[in_tile], d_r[in_tile], w_r[in_tile]
            fwd_plans.append(_build_tile_tables(dc // B, sc // B, dc % B, sc % B, wc, nb, B, dense_keys))
            # The backward's out block is the SOURCE block, its tiles
            # transposed: the same tile set, keyed (J, I).
            bwd_keys = np.unique((dense_keys % nb) * nb + (dense_keys // nb))
            bwd_plans.append(_build_tile_tables(sc // B, dc // B, sc % B, dc % B, wc, nb, B, bwd_keys))
        self.covered_edges = int(covered.sum())
        fwd = bwd = None
        if self.tiles_total:
            dtype = getattr(torch, tile_dtype)
            fwd = place_plans(fwd_plans, B, nb, self.num_nodes, False, dtype, device)
            bwd = place_plans(bwd_plans, B, nb, self.num_nodes, True, dtype, device)
        self.plan_seconds["tile tables"] = time.perf_counter() - start

        # Residual (below-threshold) edges keep their positions in the
        # residual's edge arrays as their ids on the ELL tables; tile edges
        # use the pair hash: the streams are disjoint by edge.
        start = time.perf_counter()
        self._ell: Optional[ELLGraphKernel] = None
        if (~covered).any() or self.tiles_total == 0:
            self._ell = ELLGraphKernel(
                senders[~covered], receivers[~covered], relations[~covered], weights[~covered],
                num_nodes=self.num_nodes, num_relations=self.L, device=device, **ell_kwargs,
            )
        self.plan_seconds["ell residual"] = time.perf_counter() - start
        self.tables = TileTables(fwd=fwd, bwd=bwd, ell=self._ell.tables if self._ell is not None else None,
                                 proj=() if self._plan_projected else None)

    def pad_features(self, V: torch.Tensor) -> torch.Tensor:
        return V

    def neighbor_aggregate(self, V: torch.Tensor, seed: Seed = 0, rate: float = 0.0) -> torch.Tensor:
        """``(num_nodes, L*F)`` neighbour aggregation of ``V (>= num_nodes,
        F)`` with fused DropEdge (``tile.py:424-448``): the tile part (K7)
        plus the ELL residual (K6), added in V's dtype; pure ELL where no
        tile was planned. Differentiable in V."""
        if self.tiles_total == 0:
            return self._ell.neighbor_aggregate(V, seed, rate)
        out = tile_aggregate(self.tables, V, seed, rate)
        if self._ell is not None:
            out = out + self._ell.neighbor_aggregate(V, seed, rate)
        return out

    def neighbor_aggregate_projected(self, Vr: torch.Tensor, seed: Seed = 0, rate: float = 0.0) -> torch.Tensor:
        """Project-first aggregation (``tile.py:450-478``): ``Vr
        (num_nodes*L, C)`` -> relation-summed ``(num_nodes, C)``. Needs
        ``plan_projected=True``."""
        if self.tables.proj is None:
            raise ValueError("tile kernel planned without plan_projected=True")
        if self.tiles_total == 0:
            return self._ell.neighbor_aggregate_projected(Vr, seed, rate)
        out = tile_aggregate_projected(self.tables, Vr, seed, rate)
        if self._ell is not None:
            out = out + self._ell.neighbor_aggregate_projected(Vr, seed, rate)
        return out
