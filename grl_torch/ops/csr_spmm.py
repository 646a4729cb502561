"""K5: sparse relational aggregation over a CSR layout, with DropEdge fused.

Counterpart of ``grl_tpu/ops/pallas/csr_spmm.py``: ``CSRGraphKernel``
(:339-456) plans a static graph once on the host and its
``neighbor_aggregate(V, seed, rate)`` returns the relation-major
``(N, L*F)`` neighbor aggregate

    out[n, l*F:(l+1)*F] = sum over edges (s -> n, relation l) of
                          w * hash_keep(gid, seed, rate) * V[s]

differentiable in V. The forward walks the forward layout (output row
``receiver*L + relation``, gathering sender rows); the backward walks the
transposed layout (output row ``sender``, gathering row
``receiver*L + relation`` of the cotangent), as ``csr_spmm.py:397-440``
does. Each edge carries ``gid``, its position in the graph's edge arrays,
so both walks draw one mask (:mod:`grl_torch.ops.hashing`, K0) and no mask
is stored. Zero-weight and masked edges are dropped from both layouts.

The TPU kernel (``csr_accumulate``, :274-336) buckets edges into
(receiver block, sender chunk) cells sized for VMEM and walks each cell on
the scalar core. On the GPU the layout is plain CSR, walked in column
slices small enough for the gathered rows to stay in the card's L2
(:func:`~grl_torch.ops.sparse.gather_slices`): one warp (or a sub-warp
group, for narrow slices) owns one (output row, slice), walks the row's
edge list and gathers that slice of each sender row with 16-byte loads
(``grl_torch/csrc/csr_spmm.cu``). The TPU tiling knobs of the planner
(``block_rows``, ``chunk_cols``, ``edge_quantum``, ``unroll``,
``feature_dim``, ``vmem_budget``) are accepted and have no effect on the
result; ``pad_features`` returns V as it is.

:func:`csr_accumulate` takes the plain version
(:func:`csr_accumulate_reference`) for CPU tensors and launches K5 for
CUDA tensors, or raises; it counts launches per layout direction in
:mod:`grl_torch.ops.launches` (``K5 forward``, ``K5 backward``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from grl_torch.ops import _build, launches
from grl_torch.ops.hashing import Seed, hash_keep, keep_probability, seed_tensor
from grl_torch.ops.sparse import gather_slices, l2_bytes, slice_grid

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_MAX_EDGES = 2**31 - 1  # gid and the row pointers are int32 in the kernel


class CSRLayout(NamedTuple):
    """One gather direction of a planned graph, on one device.

    Output row ``r`` sums ``weights[e] * X[cols[e]]`` over
    ``e in [rowptr[r], rowptr[r+1])``, each edge masked by the hash of
    ``gids[e]``. Within a row, edges are sorted by column for locality.
    """

    rowptr: torch.Tensor  # int32 (num_rows + 1,)
    cols: torch.Tensor  # int32 (nnz,)
    gids: torch.Tensor  # int32 (nnz,)
    weights: torch.Tensor  # float32 (nnz,)
    num_rows: int
    num_src_rows: int
    direction: str  # "forward" or "backward"

    def row_ids(self) -> torch.Tensor:
        """The output row of each edge (int64), for the plain version."""
        counts = self.rowptr[1:] - self.rowptr[:-1]
        rows = torch.arange(self.num_rows, device=self.rowptr.device)
        return torch.repeat_interleave(rows, counts.long())


def build_csr_layout(out_rows: np.ndarray, src_rows: np.ndarray, gids: np.ndarray,
                     weights: np.ndarray, num_out_rows: int, num_src_rows: int,
                     direction: str, device=None) -> CSRLayout:
    """Host planner, vectorised: drop zero weights, sort the edges by
    (output row, source row), count them per row."""
    valid = weights != 0.0
    out_rows, src_rows = out_rows[valid], src_rows[valid]
    gids, weights = gids[valid], weights[valid]
    if len(gids) > _MAX_EDGES:
        raise ValueError(f"{len(gids)} edges: K5 indexes edges with int32")
    order = np.lexsort((src_rows, out_rows))
    counts = np.bincount(out_rows, minlength=num_out_rows)
    rowptr = np.zeros(num_out_rows + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])

    def put(array, dtype):
        return torch.from_numpy(np.ascontiguousarray(array)).to(dtype=dtype, device=device)

    return CSRLayout(
        rowptr=put(rowptr, torch.int32),
        cols=put(src_rows[order], torch.int32),
        gids=put(gids[order], torch.int32),
        weights=put(weights[order], torch.float32),
        num_rows=int(num_out_rows),
        num_src_rows=int(num_src_rows),
        direction=direction,
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def edge_coefficients(layout: CSRLayout, seed: Seed, rate: float) -> torch.Tensor:
    """Each edge's float32 factor: ``hash_keep(gid) * w`` (``w`` at rate 0)."""
    if float(rate) == 0.0:
        return layout.weights
    return hash_keep(layout.gids, seed, rate) * layout.weights


def csr_accumulate_reference(X: torch.Tensor, layout: CSRLayout, seed: Seed = 0,
                             rate: float = 0.0) -> torch.Tensor:
    """Plain K5: ``(num_rows, F)`` in X's dtype, a float32 ``index_add_``
    of the masked, weighted source rows."""
    coef = edge_coefficients(layout, seed, rate)
    messages = X[layout.cols.long()].float() * coef[:, None]
    out = torch.zeros(layout.num_rows, X.shape[-1], dtype=torch.float32, device=X.device)
    out.index_add_(0, layout.row_ids(), messages)
    return out.to(X.dtype)


# ---------------------------------------------------------------------------
# Launching the kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built K5 library with its C signature declared (once)."""
    lib = _build.load_library("csr_spmm")
    lib.grl_csr_accumulate.argtypes = (
        [ctypes.c_void_p] * 6  # rowptr, cols, gids, weights, X, out
        + [ctypes.c_int] * 7  # rows, F, col0, slice_cols, num_slices, dtype, use_hash
        + [ctypes.c_void_p, ctypes.c_float]  # seed (a device pointer), keep
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_csr_accumulate.restype = ctypes.c_int
    return lib


def _enqueue(out: torch.Tensor, X: torch.Tensor, layout: CSRLayout, seed: Seed, rate: float,
             col0: int, slice_cols: int, num_slices: int) -> None:
    """Launch K5 on the current stream over ``num_slices`` slices of
    ``slice_cols`` columns from ``col0`` (the last clipped at F), writing
    those columns of ``out``; no synchronisation. The kernel reads the seed
    from device memory (:func:`~grl_torch.ops.hashing.seed_tensor`)."""
    lib = _library()
    use_hash = float(rate) > 0.0
    seed = seed_tensor(seed, X.device) if use_hash else None
    err = lib.grl_csr_accumulate(
        layout.rowptr.data_ptr(), layout.cols.data_ptr(), layout.gids.data_ptr(),
        layout.weights.data_ptr(), X.data_ptr(), out.data_ptr(),
        layout.num_rows, X.shape[-1], col0, slice_cols, num_slices, _DTYPE_CODES[X.dtype],
        int(use_hash), seed.data_ptr() if use_hash else None, keep_probability(rate),
        X.device.index, torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K5")


def _launch(X: torch.Tensor, layout: CSRLayout, seed: Seed, rate: float,
            plan: Optional[List[Tuple[int, int]]] = None) -> torch.Tensor:
    """Launch K5 on the current stream, once, over the column slices of
    ``plan`` (by default :func:`~grl_torch.ops.sparse.gather_slices` for
    this card's L2; the tests and ``chip_smoke.py`` force one or many);
    no synchronisation."""
    if X.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA K5 takes float32 or bfloat16, not {X.dtype}")
    F = X.shape[-1]
    if X.dim() != 2 or not X.is_contiguous() or F % 8 or X.data_ptr() % 16:
        raise ValueError(
            f"CUDA K5 needs a contiguous, 16-byte aligned (rows, F) operand with F a "
            f"multiple of 8; got {tuple(X.shape)}"
        )
    if layout.rowptr.device != X.device:
        raise ValueError(f"layout on {layout.rowptr.device} but X on {X.device}")
    if plan is None:
        plan = gather_slices(layout.num_src_rows, F, X.element_size(), l2_bytes(X.device.index))
    slice_cols, num_slices = slice_grid(plan, F, X.element_size())
    out = torch.empty(layout.num_rows, F, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    _enqueue(out, X, layout, seed, rate, 0, slice_cols, num_slices)
    return out


def csr_accumulate(X: torch.Tensor, layout: CSRLayout, seed: Seed = 0,
                   rate: float = 0.0) -> torch.Tensor:
    """``(layout.num_rows, F)`` gather-accumulate of ``X`` over ``layout``.

    CPU tensors take :func:`csr_accumulate_reference`; CUDA tensors launch
    K5 (counted as ``K5 <direction>`` in :mod:`grl_torch.ops.launches`) or raise.
    """
    keep_probability(rate)
    if X.shape[0] < layout.num_src_rows:
        raise ValueError(f"X has {X.shape[0]} rows; the layout gathers from {layout.num_src_rows}")
    if X.device.type == "cpu":
        return csr_accumulate_reference(X, layout, seed, rate)
    if X.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {X.device}")
    out = _launch(X, layout, seed, rate)
    launches.count(f"K5 {layout.direction}")
    return out


# ---------------------------------------------------------------------------
# The planned graph
# ---------------------------------------------------------------------------
class _CSRAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, kernel: "CSRGraphKernel", seed: Seed, rate: float):
        ctx.kernel, ctx.seed, ctx.rate, ctx.v_rows = kernel, seed, rate, V.shape[0]
        out = csr_accumulate(V, kernel.forward_layout, seed, rate)  # (N*L, F)
        return out.view(kernel.num_nodes, kernel.L * V.shape[-1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        kernel = ctx.kernel
        g = g.reshape(kernel.num_nodes * kernel.L, -1).contiguous()
        dV = csr_accumulate(g, kernel.backward_layout, ctx.seed, ctx.rate)  # (N, F)
        if ctx.v_rows > kernel.num_nodes:
            dV = torch.nn.functional.pad(dV, (0, 0, 0, ctx.v_rows - kernel.num_nodes))
        # The seed is an integer and the graph is data: no gradients
        # (csr_spmm.py:439-440).
        return dV, None, None, None


class CSRGraphKernel:
    """A static graph planned into forward and transposed CSR layouts
    (``csr_spmm.py:339-456``), held on ``device``."""

    def __init__(
        self,
        senders: np.ndarray,
        receivers: np.ndarray,
        relations: np.ndarray,
        weights: np.ndarray,
        num_nodes: int,
        num_relations: int,
        block_rows: int = 8192,
        chunk_cols: int = 16384,
        edge_quantum: int = 512,
        unroll: int = 8,
        feature_dim: int = 128,
        vmem_budget: int = 12 * 1024 * 1024,
        device=None,
    ):
        # The TPU's VMEM tiling knobs shape grl_tpu's cells; the CSR layout
        # here has none, and the result does not depend on them.
        del block_rows, chunk_cols, edge_quantum, unroll, feature_dim, vmem_budget
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        relations = np.asarray(relations, np.int64)
        weights = np.asarray(weights, np.float32)
        self.num_nodes = int(num_nodes)
        self.L = int(num_relations)
        # The DropEdge hash keys on the edge's position in these arrays,
        # the same in both layouts (csr_spmm.py:409-412).
        gids = np.arange(len(senders), dtype=np.int64)
        gather_rows = receivers * self.L + relations
        self.forward_layout = build_csr_layout(
            gather_rows, senders, gids, weights, self.num_nodes * self.L, self.num_nodes,
            "forward", device,
        )
        self.backward_layout = build_csr_layout(
            senders, gather_rows, gids, weights, self.num_nodes, self.num_nodes * self.L,
            "backward", device,
        )

    @property
    def num_edges(self) -> int:
        return int(self.forward_layout.cols.numel())

    def pad_features(self, V: torch.Tensor) -> torch.Tensor:
        """The TPU kernel pads V to whole chunks; the CSR walk needs no
        padding, so V comes back as it is."""
        return V

    def neighbor_aggregate(self, V: torch.Tensor, seed: Seed = 0, rate: float = 0.0) -> torch.Tensor:
        """``(num_nodes, L*F)`` neighbor aggregate of ``V (>= num_nodes, F)``
        with DropEdge at ``rate`` keyed on ``seed`` (an int or a one-element
        int32 tensor on V's device); differentiable in V, whose gradient is K5 on the transposed layout."""
        keep_probability(rate)
        return _CSRAggregate.apply(V.contiguous(), self, seed, float(rate))
