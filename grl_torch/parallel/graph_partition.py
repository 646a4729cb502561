"""Node-partitioned aggregation over a world of ranks: the ring halo
exchange (the sequence-parallel analog).

Counterpart of ``grl_tpu/parallel/graph_partition.py`` (:36-346). A big
graph's nodes are split over the ranks of a mesh axis; each rank owns the
edges whose receiver is local, and sender features arrive by a ring of
block shifts overlapped with the local gather and sum.

The host plan (:func:`partition_graph`, a numpy copy of ``grl_tpu``'s that
plans the same cells bit for bit) buckets edges by (receiver shard, ring
step): cell ``(d, k)`` holds the edges whose receiver lives on shard ``d``
and whose sender lives on shard ``(d - k) mod D``, the edges consumable at
ring step ``k``, when rank ``d`` holds the block that started on ``(d - k)
mod D``. Per-rank work is ``sum_k |cell(d, k)|``, about E/D. All cells pad
to one length ``Ec``.

Each rank builds its view (:func:`local_shard_graph`, a
:class:`LocalShardGraph`) from its ``(D, Ec)`` rows. :func:`ring_aggregate`
runs the D steps: at step ``k`` the rank starts shifting its block to rank
``d + 1`` (receiving from ``d - 1``), gathers ``block[s % shard_n] * w``
and ``index_add_``s it into a ``(shard_n * L, F)`` accumulator in V's
dtype, then waits for the shift. Its backward runs the transposed ring: a
buffer of sender gradients travels back, one reverse shift a step, each
step adding what the step's edges owe to the block then held. Here
``segment_sum`` is XLA code in ``grl_tpu``, so ``index_add_`` stands for it.
"""
from __future__ import annotations

import heapq
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from grl_torch.parallel import distributed


class PartitionedGraph(NamedTuple):
    """Edge lists bucketed by (receiver shard, ring step), numpy arrays of
    shape ``(D, D, Ec)``:

      axis 0: receiver (owning) shard ``d``
      axis 1: ring step ``k``; senders live on shard ``(d - k) mod D``
      axis 2: padded edge slot within the cell

      senders   global sender ids (padding: first node of the source shard)
      receivers global receiver ids (padding: first node of shard ``d``)
      relations relation ids
      weights   edge weights (padding: 0, contributes nothing)
      mask      validity

    ``node_perm`` (``balance=True``) maps original node id ->
    partition-order id; None for the plain range partition.
    """

    senders: np.ndarray
    receivers: np.ndarray
    relations: np.ndarray
    weights: np.ndarray
    mask: np.ndarray
    num_nodes: int  # padded global node count (divisible by D)
    num_relations: int
    node_perm: Optional[np.ndarray] = None


def _balanced_node_assignment(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                              num_shards: int, shard_n: int) -> np.ndarray:
    """Greedy heaviest-first bin packing of nodes onto shards by total
    degree (in + out). Returns ``perm``: original id -> partition-order id
    (``shard * shard_n + slot``)."""
    wts = np.bincount(senders, minlength=num_nodes) + np.bincount(receivers, minlength=num_nodes)
    order = np.argsort(-wts, kind="stable")
    heap = [(0, d) for d in range(num_shards)]
    counts = np.zeros(num_shards, np.int64)
    perm = np.empty(num_nodes, np.int64)
    for n in order:
        while True:
            load, d = heapq.heappop(heap)
            if counts[d] < shard_n:
                break  # full shards fall out of the heap for good
        perm[n] = d * shard_n + counts[d]
        counts[d] += 1
        heapq.heappush(heap, (load + int(wts[n]), d))
    return perm


def partition_graph(senders: np.ndarray, receivers: np.ndarray, relations: np.ndarray,
                    weights: np.ndarray, num_nodes: int, num_relations: int, num_shards: int,
                    edge_quantum: int = 256, balance: bool = False) -> PartitionedGraph:
    """Bucket edges into (receiver shard, ring step) cells with one common
    padded cell length, a multiple of ``edge_quantum``. ``balance=True``
    first re-assigns nodes to shards by degree
    (:func:`_balanced_node_assignment`) and records the permutation in
    ``node_perm``."""
    D = num_shards
    shard_n = -(-num_nodes // D)
    padded_nodes = shard_n * D
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    node_perm = None
    if balance and D > 1:
        node_perm = _balanced_node_assignment(senders, receivers, num_nodes, D, shard_n)
        senders = node_perm[senders]
        receivers = node_perm[receivers]
    E = len(senders)

    dst = receivers // shard_n
    src = senders // shard_n
    k = (dst - src) % D
    cell = dst * D + k

    counts = np.bincount(cell, minlength=D * D)
    Ec = int(max(1, counts.max()))
    Ec = -(-Ec // edge_quantum) * edge_quantum

    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    starts = np.zeros(D * D, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    flat_pos = cell_sorted * Ec + (np.arange(E) - starts[cell_sorted])

    # Padding: sender = first node of the cell's source shard (the ring
    # step's gather index stays in range), receiver = first node of the
    # destination shard, weight 0.
    d_of_cell = np.arange(D * D) // D
    k_of_cell = np.arange(D * D) % D
    src_of_cell = (d_of_cell - k_of_cell) % D
    out_senders = np.repeat(src_of_cell * shard_n, Ec).astype(np.int32)
    out_receivers = np.repeat(d_of_cell * shard_n, Ec).astype(np.int32)
    out_relations = np.zeros(D * D * Ec, np.int32)
    out_weights = np.zeros(D * D * Ec, np.float32)
    out_mask = np.zeros(D * D * Ec, bool)

    out_senders[flat_pos] = senders[order]
    out_receivers[flat_pos] = receivers[order]
    out_relations[flat_pos] = np.asarray(relations)[order]
    out_weights[flat_pos] = np.asarray(weights)[order]
    out_mask[flat_pos] = True

    shp = (D, D, Ec)
    return PartitionedGraph(
        senders=out_senders.reshape(shp), receivers=out_receivers.reshape(shp),
        relations=out_relations.reshape(shp), weights=out_weights.reshape(shp),
        mask=out_mask.reshape(shp), num_nodes=padded_nodes, num_relations=num_relations,
        node_perm=node_perm,
    )


class LocalShardGraph(NamedTuple):
    """One rank's view of a :class:`PartitionedGraph`: the adjacency the
    model family's ``GraphConv`` takes on the partitioned path. Edge arrays
    are ``(D, Ec)`` tensors on the rank's device, row ``k`` consumed at ring
    step ``k``: ``senders`` global ids, ``receivers_local`` block-local
    rows, ``weights`` masked, and the two index tensors the ring reads,
    ``rows`` (``senders % shard_n``) and ``segments`` (``receivers_local *
    L + relations``). ``group`` is the process group of the ring, ``ranks``
    its members' global ranks in ring order and ``index`` this rank's place
    in it."""

    senders: torch.Tensor
    receivers_local: torch.Tensor
    relations: torch.Tensor
    weights: torch.Tensor
    rows: torch.Tensor
    segments: torch.Tensor
    group: Any
    ranks: List[int]
    index: int
    shard_n: int
    num_relations: int

    @property
    def num_nodes(self) -> int:  # duck-types RelationalGraph for DropEdge
        return self.shard_n

    @property
    def device(self) -> torch.device:
        return self.weights.device


def local_shard_graph(senders: np.ndarray, receivers: np.ndarray, relations: np.ndarray,
                      weights: np.ndarray, mask: np.ndarray, shard_n: int, num_relations: int,
                      mesh: Any, axis: str = "data", device: Any = "cpu") -> LocalShardGraph:
    """This rank's view from its ``(D, Ec)`` rows of the plan (a leading
    axis of size 1, as ``grl_tpu``'s shard_map blocks have, is dropped),
    placed on ``device``."""
    index = mesh.index(axis)
    rows_of = [np.asarray(a) for a in (senders, receivers, relations, weights, mask)]
    s, r, rel, w, m = (a[0] if a.ndim == 3 else a for a in rows_of)
    r_local = r.astype(np.int64) - index * shard_n
    t = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device) for name, a in (
        ("senders", s.astype(np.int32)), ("receivers_local", r_local.astype(np.int32)),
        ("relations", rel.astype(np.int32)), ("weights", (w * m).astype(np.float32)),
        ("rows", s.astype(np.int64) % shard_n), ("segments", r_local * num_relations + rel))}
    return LocalShardGraph(**t, group=mesh.group(axis), ranks=mesh.ranks.get(axis, [mesh.rank]),
                           index=index, shard_n=shard_n, num_relations=num_relations)


def _shard_of(graph: PartitionedGraph, mesh: Any, axis: str, device: Any) -> LocalShardGraph:
    d = mesh.index(axis)
    D = mesh.axis_size(axis)
    return local_shard_graph(graph.senders[d], graph.receivers[d], graph.relations[d], graph.weights[d],
                             graph.mask[d], graph.num_nodes // D, graph.num_relations, mesh, axis, device)


class _RingAggregate(torch.autograd.Function):
    """The ring of :func:`ring_aggregate`, with the transposed ring as its
    backward (the gradient to V's block; the weights are constants)."""

    @staticmethod
    def forward(ctx, V_block, w, graph):
        ctx.graph = graph
        ctx.save_for_backward(w)
        D = len(graph.ranks)
        L, shard_n = graph.num_relations, graph.shard_n
        acc = torch.zeros(shard_n * L, V_block.shape[-1], dtype=V_block.dtype, device=V_block.device)
        block = V_block.contiguous()
        for k in range(D):
            # Issue the next shift first: the exchange runs while this
            # step's edges gather and accumulate.
            pending = distributed.shift(block, graph.group, graph.ranks, graph.index, 1) if k < D - 1 else None
            acc.index_add_(0, graph.segments[k], block[graph.rows[k]] * w[k][:, None])
            if pending is not None:
                block = pending.wait()
        return acc.reshape(shard_n, L * V_block.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        graph = ctx.graph
        (w,) = ctx.saved_tensors
        D = len(graph.ranks)
        F = grad.shape[-1] // graph.num_relations
        g = grad.reshape(graph.shard_n * graph.num_relations, F).contiguous()

        def owed(k):
            out = torch.zeros(graph.shard_n, F, dtype=grad.dtype, device=grad.device)
            return out.index_add_(0, graph.rows[k], g[graph.segments[k]] * w[k][:, None])

        # The buffer rank d holds at step k collects what is owed to the
        # block of shard d - k; a reverse shift hands it to rank d - 1,
        # whose step k - 1 held that same block.
        travel = owed(D - 1)
        for k in range(D - 2, -1, -1):
            pending = distributed.shift(travel, graph.group, graph.ranks, graph.index, -1)
            here = owed(k)
            travel = pending.wait() + here
        return travel, None, None


def ring_aggregate(V_block: torch.Tensor, graph: LocalShardGraph,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(shard_n, L * F)`` relation-major neighbor sums of this rank's
    block (``_ring_aggregate_body``, :224-268); ``weights`` (default the
    graph's) in V's dtype."""
    w = graph.weights if weights is None else weights
    return _RingAggregate.apply(V_block, w.to(V_block.dtype), graph)


def partitioned_relational_aggregate(V: torch.Tensor, graph: PartitionedGraph, mesh: Any,
                                     axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``[self | rel...]``, ``(shard_n, (L+1) F)``, over
    the ring: ``V`` is this rank's block ``(shard_n, F)`` of the node
    features in partition order (:271-311)."""
    local = _shard_of(graph, mesh, axis, V.device)
    return torch.cat([V, ring_aggregate(V, local)], dim=-1)


class _AllGatherAggregate(torch.autograd.Function):
    """One all_gather of V, then the local gather and sum; the backward
    scatters the gradient over the whole V and reduce-scatters it home."""

    @staticmethod
    def forward(ctx, V_block, graph):
        ctx.graph = graph
        V_full = distributed.all_gather(V_block, graph.group) if graph.group is not None else V_block
        w = graph.weights.reshape(-1).to(V_block.dtype)
        senders, segments = graph.senders.reshape(-1).long(), graph.segments.reshape(-1)
        ctx.save_for_backward(w, senders, segments)
        ctx.full_rows = V_full.shape[0]
        acc = torch.zeros(graph.shard_n * graph.num_relations, V_block.shape[-1], dtype=V_block.dtype,
                          device=V_block.device)
        acc.index_add_(0, segments, V_full[senders] * w[:, None])
        return acc.reshape(graph.shard_n, -1)

    @staticmethod
    def backward(ctx, grad):
        graph = ctx.graph
        w, senders, segments = ctx.saved_tensors
        F = grad.shape[-1] // graph.num_relations
        g = grad.reshape(-1, F)
        full = torch.zeros(ctx.full_rows, F, dtype=grad.dtype, device=grad.device)
        full.index_add_(0, senders, g[segments] * w[:, None])
        return (distributed.reduce_scatter(full, graph.group) if graph.group is not None else full), None


def all_gather_relational_aggregate(V: torch.Tensor, graph: PartitionedGraph, mesh: Any,
                                    axis: str = "data") -> torch.Tensor:
    """The baseline halo strategy (:314-346): one all_gather of V, then
    the local gather and sum over the rank's flattened cells. Same output
    as :func:`partitioned_relational_aggregate`."""
    local = _shard_of(graph, mesh, axis, V.device)
    return torch.cat([V, _AllGatherAggregate.apply(V, local)], dim=-1)
