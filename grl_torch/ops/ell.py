"""K6: relational aggregation over degree-bucketed ELL gather tables, with
DropEdge fused.

Counterpart of ``grl_tpu/ops/ell.py``. A static graph is planned once on
the host as padded neighbour lists (ELL), bucketed by degree, in both
directions of the op:

* **forward**: output row ``r = node*L + rel`` sums
  ``w[r,k] * V[idx[r,k]]`` over its padded list of sender rows;
* **backward**: sender row ``s`` sums ``w'[s,k] * g[idx'[s,k]]`` over its
  list of cotangent rows ``receiver*L + rel``.

With ``plan_projected`` two more tables serve the project-first mode
(``ell_aggregate_projected``): the forward gathers relation-channelled rows
``sender*L + rel`` of a pre-projected ``(N*L, C)`` array into N receiver
rows (the relations sum), the backward gathers the ``(N, C)`` cotangent
into N*L rows. Each table entry carries its edge's position in the graph's
edge arrays (``gid``); the DropEdge mask is K0's hash of it
(:mod:`grl_torch.ops.hashing`), so every walk, and K5 on the same graph,
draws one mask and no mask is stored. Padding entries carry ``w == 0``
and gather row 0.

The host planner (:func:`_build_tables`, ``ell.py:66-151``) gives the
same tables, permutations and edge cells as ``grl_tpu``'s, in numpy.
:class:`GatherTables` holds one planned direction on a device: the bucket
tables raveled and concatenated (``ell.py``'s ``edge_flat`` addressing),
a per-bucket table of (first row, width, first cell), and ``perm``, the
output row of each bucket-concatenated row.

:func:`ell_accumulate` takes the plain version
(:func:`ell_accumulate_reference`: ``_gather_reduce`` per bucket,
``ell.py:154-181``, float32 accumulation, then the inverse-permutation
stitch) for CPU tensors and launches K6 (``grl_torch/csrc/ell.cu``) for
CUDA tensors, or raises. K6 walks every bucket in one launch, in column
slices small enough for the gathered rows to stay in the card's L2
(:func:`~grl_torch.ops.sparse.gather_slices`, shared with K5), and writes
each row straight to its output position through ``perm``: the stitch is
fused into the write. Launches are counted per direction in
``ell_accumulate.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from grl_torch.ops import _build
from grl_torch.ops.hashing import hash_keep, keep_probability
from grl_torch.ops.sparse import gather_slices, l2_bytes, slice_grid

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_MAX_CELLS = 2**31 - 1  # K6 addresses table cells and rows with int32
DIRECTIONS = ("forward", "backward", "projected forward", "projected backward")


class _Bucket(NamedTuple):
    idx: np.ndarray  # (rows, W) int32 — gather rows
    weight: np.ndarray  # (rows, W) float32 — 0 for padding entries
    gid: np.ndarray  # (rows, W) int32 — global edge ids (DropEdge hash)


class TablePlan(NamedTuple):
    """One planned gather direction on the host (see :func:`_build_tables`)."""

    buckets: List[_Bucket]
    inv_perm: np.ndarray  # int32: bucket-concatenated row -> out_row order
    perm: np.ndarray  # out_row ids in bucket-concatenated order
    edge_flat: np.ndarray  # per input edge: its flat cell in the raveled
    #                        concatenation of all bucket tables


def _bucket_widths(max_deg: int, width_quantum: int, bucket_growth: int) -> List[int]:
    """Bucket widths from ``width_quantum`` up to ``max_deg``: geometric
    (``bucket_growth > 1``) or arithmetic (``bucket_growth == 1``: q, 2q, ...)."""
    widths = [width_quantum]
    while widths[-1] < max(max_deg, 1):
        widths.append(
            widths[-1] * bucket_growth if bucket_growth > 1 else widths[-1] + width_quantum
        )
    return widths


def _build_tables(
    out_row: np.ndarray,
    src_row: np.ndarray,
    weights: np.ndarray,
    gids: np.ndarray,
    num_out_rows: int,
    width_quantum: int,
    bucket_growth: int,
) -> TablePlan:
    """Plan one gather direction: per-out-row padded lists, degree-bucketed
    (``ell.py:66-151``, vectorised). Zero-degree rows land in the narrowest
    bucket as all-padding rows."""
    order = np.argsort(out_row, kind="stable")
    out_s, src_s, w_s, g_s = out_row[order], src_row[order], weights[order], gids[order]
    counts = np.bincount(out_s, minlength=num_out_rows)
    starts = np.concatenate([[0], np.cumsum(counts)])

    max_deg = int(counts.max()) if len(counts) else 0
    widths = _bucket_widths(max_deg, width_quantum, bucket_growth)
    bucket_of = np.searchsorted(np.asarray(widths), counts)

    # Every edge lands at table cell (rank of its out-row within its
    # bucket, position within its row).
    slot = np.arange(len(out_s), dtype=np.int64) - starts[out_s]
    rows_by_bucket = np.argsort(bucket_of, kind="stable")  # row ids
    bucket_counts = np.bincount(bucket_of, minlength=len(widths))
    bucket_starts = np.concatenate([[0], np.cumsum(bucket_counts)])
    rank_in_bucket = np.empty(num_out_rows, np.int64)
    rank_in_bucket[rows_by_bucket] = np.arange(num_out_rows) - bucket_starts[bucket_of[rows_by_bucket]]
    edge_bucket = bucket_of[out_s]

    buckets: List[_Bucket] = []
    perm_parts = []
    ravel_offset = np.zeros(len(widths), np.int64)
    off = 0
    for bi, W in enumerate(widths):
        n_rows = int(bucket_counts[bi])
        if n_rows == 0 and bi > 0:
            continue
        ravel_offset[bi] = off
        off += n_rows * W
        idx = np.zeros((n_rows, W), np.int32)
        wgt = np.zeros((n_rows, W), np.float32)
        gid = np.zeros((n_rows, W), np.int32)
        sel = edge_bucket == bi
        jj = rank_in_bucket[out_s[sel]]
        kk = slot[sel]
        idx[jj, kk] = src_s[sel]
        wgt[jj, kk] = w_s[sel]
        gid[jj, kk] = g_s[sel]
        buckets.append(_Bucket(idx, wgt, gid))
        perm_parts.append(rows_by_bucket[bucket_starts[bi]:bucket_starts[bi] + n_rows])
    perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, np.int64)
    inv_perm = np.argsort(perm)
    widths_arr = np.asarray(widths, np.int64)
    flat_sorted = ravel_offset[edge_bucket] + rank_in_bucket[out_s] * widths_arr[edge_bucket] + slot
    edge_flat = np.empty(len(out_s), np.int64)
    edge_flat[order] = flat_sorted
    return TablePlan(buckets, inv_perm.astype(np.int32), perm, edge_flat)


def _trivial_inv(plan: TablePlan) -> bool:
    """True when the bucket-concatenated rows are already in natural order
    (``ell.py:228-233``): the stitch is the identity and is skipped."""
    return bool(np.array_equal(plan.perm, np.arange(len(plan.perm))))


class GatherTables(NamedTuple):
    """One planned gather direction on one device: K6's operand.

    ``idx``/``weight``/``gid`` are the bucket tables raveled and
    concatenated; bucket ``b`` holds rows ``[buckets[b,0], buckets[b+1,0])``
    of width ``buckets[b,1]`` from cell ``buckets[b,2]``. Bucket-concatenated
    row ``j`` is output row ``perm[j]``; ``inv_perm`` is the stitch gather
    of the plain version, None where it is the identity.
    """

    idx: torch.Tensor  # int32 (cells,)
    weight: torch.Tensor  # float32 (cells,)
    gid: torch.Tensor  # int32 (cells,)
    buckets: torch.Tensor  # int32 (num_buckets, 3): first row, width, first cell
    perm: torch.Tensor  # int32 (rows,)
    inv_perm: Optional[torch.Tensor]  # int64 (rows,) or None
    shapes: Tuple[Tuple[int, int], ...]  # (rows, width) of each bucket
    num_src_rows: int
    direction: str

    @property
    def num_rows(self) -> int:
        return int(self.perm.numel())

    @property
    def num_cells(self) -> int:
        return int(self.idx.numel())

    def bucket_views(self) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """``(idx, weight, gid)`` of each bucket as ``(rows, W)`` views."""
        views, cell = [], 0
        for rows, width in self.shapes:
            end = cell + rows * width
            views.append(tuple(t[cell:end].view(rows, width) for t in (self.idx, self.weight, self.gid)))
            cell = end
        return views


def place_tables(plan: TablePlan, num_src_rows: int, direction: str, device=None) -> GatherTables:
    """A host :class:`TablePlan` as :class:`GatherTables` on ``device``."""
    shapes = tuple(b.idx.shape for b in plan.buckets)
    rows = np.array([r for r, _ in shapes], np.int64)
    cells = np.array([r * w for r, w in shapes], np.int64)
    if cells.sum() > _MAX_CELLS or len(plan.perm) > _MAX_CELLS:
        raise ValueError(f"{int(cells.sum())} table cells: K6 addresses cells with int32")
    table = np.stack([np.cumsum(rows) - rows, [w for _, w in shapes], np.cumsum(cells) - cells], 1)

    def put(array, dtype):
        return torch.from_numpy(np.ascontiguousarray(array)).to(dtype=dtype, device=device)

    def flat(name, dtype):
        return put(np.concatenate([getattr(b, name).ravel() for b in plan.buckets]), dtype)

    return GatherTables(
        idx=flat("idx", torch.int32), weight=flat("weight", torch.float32), gid=flat("gid", torch.int32),
        buckets=put(table, torch.int32), perm=put(plan.perm, torch.int32),
        inv_perm=None if _trivial_inv(plan) else put(plan.inv_perm, torch.int64),
        shapes=shapes, num_src_rows=int(num_src_rows), direction=direction,
    )


class ELLProjTables(NamedTuple):
    """Project-first tables (``ell.py:184-194``): ``fwd`` gathers rows
    ``sender*L + rel`` of an ``(N*L, C)`` array into N receiver rows; ``bwd``
    gathers the ``(N, C)`` cotangent into N*L rows."""

    fwd: GatherTables
    bwd: GatherTables


class ELLTables(NamedTuple):
    """The planned directions of one graph (``ell.py:197-213``); each
    carries its own stitch permutation (``fwd_inv``/``bwd_inv`` there)."""

    fwd: GatherTables
    bwd: GatherTables
    proj: Optional[ELLProjTables] = None


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def _gather_reduce(X: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor,
                   seed: int, rate: float) -> torch.Tensor:
    """``(rows, F) = sum_k w[.,k] (*mask) * X[idx[.,k]]``, float32
    (``ell.py:154-181``): W gather-and-add terms, or one einsum for hub
    buckets wider than 32 (the same sum)."""
    w = weight
    if rate > 0.0:
        w = w * hash_keep(gid, seed, rate)
    idx = idx.long()
    W = idx.shape[1]
    if W > 32:
        return torch.einsum("rw,rwf->rf", w, X[idx].float())
    out = None
    for k in range(W):
        term = X[idx[:, k]].float() * w[:, k:k + 1]
        out = term if out is None else out + term
    return out


def ell_accumulate_reference(X: torch.Tensor, tables: GatherTables, seed: int = 0,
                             rate: float = 0.0) -> torch.Tensor:
    """Plain K6: ``(tables.num_rows, F)`` in X's dtype; each bucket's float32
    gather-reduce, concatenated and stitched into output-row order."""
    parts = [_gather_reduce(X, *view, seed, float(rate)) for view in tables.bucket_views()]
    out = torch.cat(parts, dim=0)
    if tables.inv_perm is not None:
        out = out[tables.inv_perm]
    return out.to(X.dtype)


# ---------------------------------------------------------------------------
# Launching the kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built K6 library with its C signature declared (once)."""
    lib = _build.load_library("ell")
    lib.grl_ell_accumulate.argtypes = (
        [ctypes.c_void_p] * 7  # idx, weight, gid, buckets, perm, X, out
        + [ctypes.c_int] * 8  # num_buckets, rows, F, col0, slice_cols, num_slices, dtype, use_hash
        + [ctypes.c_uint32, ctypes.c_float]  # seed, keep
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_ell_accumulate.restype = ctypes.c_int
    return lib


def _enqueue(out: torch.Tensor, X: torch.Tensor, tables: GatherTables, seed: int, rate: float,
             col0: int, slice_cols: int, num_slices: int) -> None:
    """Launch K6 on the current stream over ``num_slices`` slices of
    ``slice_cols`` columns from ``col0`` (the last clipped at F), writing
    those columns of ``out``; no synchronisation."""
    lib = _library()
    err = lib.grl_ell_accumulate(
        tables.idx.data_ptr(), tables.weight.data_ptr(), tables.gid.data_ptr(),
        tables.buckets.data_ptr(), tables.perm.data_ptr(), X.data_ptr(), out.data_ptr(),
        len(tables.shapes), tables.num_rows, X.shape[-1], col0, slice_cols, num_slices,
        _DTYPE_CODES[X.dtype], int(float(rate) > 0.0), int(seed) & 0xFFFFFFFF, keep_probability(rate),
        X.device.index, torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K6")


def _launch(X: torch.Tensor, tables: GatherTables, seed: int, rate: float,
            plan: Optional[List[Tuple[int, int]]] = None) -> torch.Tensor:
    """Launch K6 on the current stream, once, over the column slices of
    ``plan`` (by default :func:`~grl_torch.ops.sparse.gather_slices` for
    this card's L2; the tests and ``chip_smoke.py`` force one or many);
    no synchronisation."""
    if X.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA K6 takes float32 or bfloat16, not {X.dtype}")
    F = X.shape[-1]
    if X.dim() != 2 or not X.is_contiguous() or F % 8 or X.data_ptr() % 16:
        raise ValueError(
            f"CUDA K6 needs a contiguous, 16-byte aligned (rows, F) operand with F a "
            f"multiple of 8; got {tuple(X.shape)}"
        )
    if tables.idx.device != X.device:
        raise ValueError(f"tables on {tables.idx.device} but X on {X.device}")
    if plan is None:
        plan = gather_slices(tables.num_src_rows, F, X.element_size(), l2_bytes(X.device.index))
    slice_cols, num_slices = slice_grid(plan, F, X.element_size())
    out = torch.empty(tables.num_rows, F, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    _enqueue(out, X, tables, seed, rate, 0, slice_cols, num_slices)
    return out


def ell_accumulate(X: torch.Tensor, tables: GatherTables, seed: int = 0,
                   rate: float = 0.0) -> torch.Tensor:
    """``(tables.num_rows, F)`` gather-reduce of ``X`` over ``tables``.

    CPU tensors take :func:`ell_accumulate_reference`; CUDA tensors launch
    K6 (counted in ``ell_accumulate.launches[tables.direction]``) or raise.
    """
    keep_probability(rate)
    if X.shape[0] < tables.num_src_rows:
        raise ValueError(f"X has {X.shape[0]} rows; the tables gather from {tables.num_src_rows}")
    if X.device.type == "cpu":
        return ell_accumulate_reference(X, tables, seed, rate)
    if X.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or CPU tensors, not {X.device}")
    out = _launch(X, tables, seed, rate)
    ell_accumulate.launches[tables.direction] += 1
    return out


ell_accumulate.launches = dict.fromkeys(DIRECTIONS, 0)


# ---------------------------------------------------------------------------
# Differentiable aggregation
# ---------------------------------------------------------------------------
def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0])) if rows > x.shape[0] else x


class _Gather(torch.autograd.Function):
    """``ell_accumulate`` over ``fwd`` whose gradient is K6 over ``bwd``;
    the seed and the tables get none (``ell.py:257-269``)."""

    @staticmethod
    def forward(ctx, X: torch.Tensor, fwd: GatherTables, bwd: GatherTables, seed: int, rate: float):
        ctx.bwd, ctx.seed, ctx.rate, ctx.x_rows = bwd, seed, rate, X.shape[0]
        return ell_accumulate(X, fwd, seed, rate)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dX = ell_accumulate(g.contiguous(), ctx.bwd, ctx.seed, ctx.rate)
        return _pad_rows(dX, ctx.x_rows), None, None, None, None


def ell_aggregate(tables: ELLTables, V: torch.Tensor, seed: int, num_nodes: int, L: int,
                  rate: float) -> torch.Tensor:
    """Dual-ELL neighbour aggregation (``ell.py:244-272``): ``(num_nodes,
    L*F)`` from ``V (>= num_nodes, F)``, differentiable in V."""
    out = _Gather.apply(V.contiguous(), tables.fwd, tables.bwd, int(seed), float(rate))
    return out.view(num_nodes, L * V.shape[-1])


def ell_aggregate_projected(tables: ELLTables, Vr: torch.Tensor, seed: int, num_nodes: int,
                            L: int, rate: float) -> torch.Tensor:
    """Project-first aggregation (``ell.py:283-320``): ``Vr (num_nodes*L,
    C)`` holds ``V @ W_r`` relation-minor (row ``n*L + r``); returns the
    relation-summed ``(num_nodes, C)``, differentiable in Vr. The mask is
    the standard path's for one seed."""
    del num_nodes, L  # the projected tables fix both
    return _Gather.apply(Vr.contiguous(), tables.proj.fwd, tables.proj.bwd, int(seed), float(rate))


class ELLGraphKernel:
    """A static graph planned as dual degree-bucketed ELL gather tables
    (``ell.py:323-471``), held on ``device``.

    Same ``neighbor_aggregate(V, seed, rate)`` surface as
    :class:`~grl_torch.ops.csr_spmm.CSRGraphKernel`, with the same fused
    hash DropEdge. ``reorder="degree"`` relabels the nodes in
    in-degree-bucket order so the forward's rows are already in natural
    order; like ``grl_tpu`` it applies to single-relation graphs only and
    does nothing when L > 1. The caller places features and labels through
    ``node_perm`` (``attach_kernel`` and ``FullGraphProcedure`` do).
    ``plan_seconds`` holds the host time of each planned direction.
    """

    def __init__(
        self,
        senders: np.ndarray,
        receivers: np.ndarray,
        relations: np.ndarray,
        weights: np.ndarray,
        num_nodes: int,
        num_relations: int,
        width_quantum: int = 4,
        bucket_growth: int = 2,
        plan_projected: bool = False,
        reorder: str = "none",
        device=None,
        **_ignored,  # planner kwargs shared with CSRGraphKernel
    ):
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        relations = np.asarray(relations, np.int64)
        weights = np.asarray(weights, np.float32)
        keep = weights != 0.0  # drop padding / masked edges at plan time
        gids = np.arange(len(senders), dtype=np.int64)[keep]
        senders, receivers = senders[keep], receivers[keep]
        relations, weights = relations[keep], weights[keep]

        self.num_nodes = int(num_nodes)
        self.L = int(num_relations)
        R = self.num_nodes * self.L

        self.node_perm = None
        if reorder == "degree" and self.L == 1 and len(senders):
            counts = np.bincount(receivers, minlength=self.num_nodes)
            widths = _bucket_widths(int(counts.max()), width_quantum, bucket_growth)
            bucket_of = np.searchsorted(np.asarray(widths), counts)
            order = np.argsort(bucket_of, kind="stable")
            perm = np.empty(self.num_nodes, np.int64)
            perm[order] = np.arange(self.num_nodes)
            self.node_perm = perm
            senders = perm[senders]
            receivers = perm[receivers]
        elif reorder not in ("none", None, "degree"):
            raise ValueError(f"unknown reorder {reorder!r} for ELL")

        self.plan_seconds: Dict[str, float] = {}

        def plan(direction, out_row, src_row, num_out_rows, num_src_rows):
            start = time.perf_counter()
            host = _build_tables(out_row=out_row, src_row=src_row, weights=weights, gids=gids,
                                 num_out_rows=num_out_rows, width_quantum=width_quantum,
                                 bucket_growth=bucket_growth)
            tables = place_tables(host, num_src_rows, direction, device)
            self.plan_seconds[direction] = time.perf_counter() - start
            return tables

        rel_rows = receivers * self.L + relations
        fwd = plan("forward", rel_rows, senders, R, self.num_nodes)
        bwd = plan("backward", senders, rel_rows, self.num_nodes, R)
        proj = None
        if plan_projected:
            channel = senders * self.L + relations
            proj = ELLProjTables(
                fwd=plan("projected forward", receivers, channel, self.num_nodes, R),
                bwd=plan("projected backward", channel, receivers, R, self.num_nodes),
            )
        self.tables = ELLTables(fwd=fwd, bwd=bwd, proj=proj)

    def pad_features(self, V: torch.Tensor) -> torch.Tensor:
        return V  # padding entries gather row 0 with weight 0: inert

    def neighbor_aggregate(self, V: torch.Tensor, seed: int = 0, rate: float = 0.0) -> torch.Tensor:
        """``(num_nodes, L*F)`` neighbour aggregation of ``V (>= num_nodes,
        F)``, DropEdge'd at ``rate`` with the hash mask keyed on ``seed`` (a
        Python int); differentiable in V through K6 on the transposed tables."""
        return ell_aggregate(self.tables, V, seed, self.num_nodes, self.L, rate)

    def neighbor_aggregate_projected(self, Vr: torch.Tensor, seed: int = 0,
                                     rate: float = 0.0) -> torch.Tensor:
        """Project-first aggregation: ``Vr (num_nodes*L, C)`` (row
        ``n*L + r`` = ``V[n] @ W_r``) -> relation-summed ``(num_nodes, C)``.
        Needs ``plan_projected=True``."""
        if self.tables.proj is None:
            raise ValueError("kernel planned without plan_projected=True; no projected tables available")
        return ell_aggregate_projected(self.tables, Vr, seed, self.num_nodes, self.L, rate)
