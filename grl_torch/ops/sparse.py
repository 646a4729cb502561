"""Sparse (COO) multi-relational aggregation.

Counterpart of ``grl_tpu/ops/sparse.py``. A graph is a padded edge list:

  senders   (E,) int32   source node ids
  receivers (E,) int32   destination node ids
  relations (E,) int32   relation ids in [0, L)
  weights   (E,) float32 edge weights (1.0 for normal_binary graphs)
  mask      (E,) bool    False for padding edges

held as tensors on one device beside ``num_nodes``, ``num_relations`` and,
for a batch of documents flattened into one node space, ``batch_shape``.
Aggregation is a gather and a float32 segment sum (``index_add_``); it is
the ``kernel_impl: xla`` path of the sparse model, and the plain reference
of the K5 kernel (:mod:`grl_torch.ops.csr_spmm`).

It also holds the column-slice plan that K5 and K6 share
(:func:`gather_slices`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from grl_torch.ops.segment import segment_sum
from grl_torch.ops.tree import TreeGraph


@dataclasses.dataclass(frozen=True)
class RelationalGraph:
    """Static sparse multi-relational graph (one sample or a flat batch)."""

    senders: torch.Tensor  # (E,) int32
    receivers: torch.Tensor  # (E,) int32
    relations: torch.Tensor  # (E,) int32
    weights: torch.Tensor  # (E,) float32
    mask: torch.Tensor  # (E,) bool
    num_nodes: int
    num_relations: int
    batch_shape: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def num_edges(self) -> int:
        """Unpadded edges (a host read of the mask)."""
        return int(self.mask.sum())


def graph_from_numpy(senders, receivers, relations, weights, mask, num_nodes: int,
                     num_relations: int, batch_shape=None, device=None) -> RelationalGraph:
    """A :class:`RelationalGraph` of numpy arrays, placed on ``device``."""
    def put(array, dtype):
        return torch.tensor(np.asarray(array), dtype=dtype, device=device)

    return RelationalGraph(
        senders=put(senders, torch.int32),
        receivers=put(receivers, torch.int32),
        relations=put(relations, torch.int32),
        weights=put(weights, torch.float32),
        mask=put(mask, torch.bool),
        num_nodes=int(num_nodes),
        num_relations=int(num_relations),
        batch_shape=batch_shape,
    )


def dense_to_relational_coo(
    A: np.ndarray,
    edge_bucket: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A dense ``(N, L, N)`` adjacency as padded COO arrays
    ``(senders, receivers, relations, weights, mask)`` (numpy, host side)."""
    recv, rel, send = np.nonzero(A)
    weights = A[recv, rel, send].astype(np.float32)
    E = len(send)
    cap = E if edge_bucket is None else edge_bucket
    if E > cap:
        raise ValueError(f"edge bucket {cap} too small for {E} edges")
    pad = cap - E

    def _pad(x: np.ndarray, value: int = 0) -> np.ndarray:
        return np.concatenate([x, np.full((pad,), value, dtype=x.dtype)])

    return (
        _pad(send.astype(np.int32)),
        _pad(recv.astype(np.int32)),
        _pad(rel.astype(np.int32)),
        _pad(weights, 0),
        np.concatenate([np.ones(E, bool), np.zeros(pad, bool)]),
    )


def batch_relational_coo(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    relations: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    nodes_per_sample: int,
    num_relations: int,
) -> RelationalGraph:
    """Stacked per-sample COO ``(B, E)`` as one flat graph: node ids are
    offset by ``b * nodes_per_sample`` and ``batch_shape`` is ``(B, N)``."""
    B = senders.shape[0]
    offs = (torch.arange(B, dtype=torch.int32, device=senders.device) * nodes_per_sample)[:, None]
    return RelationalGraph(
        senders=(senders + offs).reshape(-1),
        receivers=(receivers + offs).reshape(-1),
        relations=relations.reshape(-1),
        weights=weights.reshape(-1),
        mask=mask.reshape(-1),
        num_nodes=B * nodes_per_sample,
        num_relations=num_relations,
        batch_shape=(B, nodes_per_sample),
    )


def relational_neighbor_coo(
    V: torch.Tensor,
    graph: RelationalGraph,
    edge_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Neighbor-only aggregation ``(num_nodes, L*F)``, relation-major per
    node (``sparse.py:138-161``). Edge weights and the DropEdge keep-scale
    are cast to V's dtype, the segment sum runs in float32, and the result
    comes back in V's dtype."""
    F = V.shape[-1]
    L = graph.num_relations
    w = (graph.weights * graph.mask.to(graph.weights.dtype)).to(V.dtype)
    if edge_keep is not None:
        w = w * edge_keep.to(V.dtype)
    messages = V[graph.senders.long()] * w[:, None]  # (E, F)
    seg = graph.receivers.long() * L + graph.relations.long()
    agg = segment_sum(messages.float(), seg, graph.num_nodes * L)
    return agg.reshape(graph.num_nodes, L * F).to(V.dtype)


def relational_aggregate_coo(
    V: torch.Tensor,
    graph: RelationalGraph,
    self_scale: Optional[torch.Tensor] = None,
    edge_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(num_nodes, (L+1)*F)`` in the dense path's ``[self | rel_0 | ...]``
    layout (``sparse.py:114-135``)."""
    agg = relational_neighbor_coo(V, graph, edge_keep)
    self_term = V if self_scale is None else V * self_scale[:, None]
    return torch.cat([self_term, agg], dim=-1)


def drop_edge_coo(
    graph: Union[RelationalGraph, TreeGraph],
    rate: float,
    generator: torch.Generator,
    deterministic: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """DropEdge masks of the sparse path (``sparse.py:164-186``): iid keep
    with a ``1/(1-p)`` rescale over the edges and over the self-loops.
    Returns ``(edge_keep, self_scale (num_nodes,))`` in float32, ``edge_keep``
    shaped as the graph's weights (``(E,)``, or a TreeGraph's ``(G, E)``),
    both ``None`` when deterministic or at rate 0. ``generator`` lives on
    the graph's device."""
    if deterministic or rate <= 0.0:
        return None, None
    keep = 1.0 - rate
    device = graph.device
    edge_mask = torch.rand(graph.weights.shape, generator=generator, device=device) < keep
    self_mask = torch.rand((graph.num_nodes,), generator=generator, device=device) < keep
    scale = 1.0 / keep
    return edge_mask.to(torch.float32) * scale, self_mask.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Column slices of a gathered operand (K5, K6 and K4)
# ---------------------------------------------------------------------------
# Share of the card's L2 that the source bytes of one column slice may take.
# Measured on an H100 (PERF.md; python grl_torch/probes/slices.py): at the
# arxiv shape, slices of 256 bytes a row (43 MB of X) beat 128 (22 MB),
# whose extra walks of the rows cost more than their L2 hits save.
L2_SLICE_SHARE = 0.85


@functools.lru_cache(maxsize=None)
def l2_bytes(device_index: int) -> int:
    """The L2 cache size of CUDA device ``device_index``, read once."""
    return int(torch.cuda.get_device_properties(device_index).L2_cache_size)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of CUDA device ``device_index``, read once."""
    return int(torch.cuda.get_device_properties(device_index).multi_processor_count)


def gather_slices(num_src_rows: int, F: int, itemsize: int, l2_bytes: int,
                  resident_bytes: int = 0) -> List[Tuple[int, int]]:
    """The column slices ``[(col0, cols), ...]`` in which K5, K6 and K4 walk
    an ``(num_src_rows, F)`` gathered operand of ``itemsize``-byte elements.

    Each output column depends on the same input column alone, so the
    kernels may sum a slice of columns over every row before the next
    slice: the gathers of a slice then hit the rows of that slice alone.
    ``resident_bytes`` are gathered beside every slice and take their part
    of the budget first (K4: all of g). One slice when all of X fits
    ``L2_SLICE_SHARE * l2_bytes - resident_bytes``; otherwise slices of the
    largest power-of-two number of 16-byte vectors whose source bytes
    (``num_src_rows * cols * itemsize``) fit it, at least one vector, the
    last one narrower where F is not a multiple. A power of two keeps a
    slice row on whole 128-byte L2 lines when a row is a multiple of them.
    """
    per_vec = 16 // itemsize
    if F % per_vec:
        raise ValueError(f"F = {F} is not a whole number of 16-byte vectors of {itemsize}-byte elements")
    vecs = F // per_vec
    column_bytes = 16 * num_src_rows  # the source bytes of one vector column
    budget = L2_SLICE_SHARE * l2_bytes - resident_bytes
    if vecs * column_bytes <= budget:
        return [(0, F)]
    width = 1
    while 2 * width * column_bytes <= budget:
        width *= 2
    return [(v * per_vec, min(width, vecs - v) * per_vec) for v in range(0, vecs, width)]


def slice_grid(plan: List[Tuple[int, int]], F: int, itemsize: int) -> Tuple[int, int]:
    """``(cols, count)`` of a plan of equal slices from column 0 whose last
    may be narrower, as the kernels launch it (one grid row a slice); raises
    ``ValueError`` on any other plan."""
    per_vec = 16 // itemsize
    width = plan[0][1] if plan else 0
    expected = [(c, min(width, F - c)) for c in range(0, F, width)] if width > 0 else []
    if not plan or width % per_vec or list(map(tuple, plan)) != expected:
        raise ValueError(f"{plan} is not equal slices of whole 16-byte vectors covering F = {F}")
    return width, len(plan)
