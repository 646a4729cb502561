"""Sparse-kernel selection: plan a static graph onto a kernel.

Counterpart of ``grl_tpu/ops/kernels.py``. ``kernel_impl`` picks how the
sparse model aggregates neighbours:

* ``xla``        — gather + float32 segment sum
  (:func:`grl_torch.ops.sparse.relational_neighbor_coo`), plain PyTorch;
* ``pallas_csr`` — K5, the CSR edge walk with DropEdge fused
  (:class:`grl_torch.ops.csr_spmm.CSRGraphKernel`);
* ``ell`` (the default, and what ``pallas`` means on the sparse path) —
  K6, the dual degree-bucketed ELL gather tables with DropEdge fused
  (:class:`grl_torch.ops.ell.ELLGraphKernel`);
* ``tile`` — K7, the tile-dense hybrid: dense adjacency tiles after an
  LPA node order, plus the ELL residual on K6
  (:class:`grl_torch.ops.tile.TileGraphKernel`).

A kernel that reorders the node space at plan time (ELL's
``reorder: degree``, tile's ``lpa`` and ``rcm``) exposes ``node_perm``: the carried edge arrays are
relabeled into that space, and the caller places features and labels
there (``FullGraphProcedure`` does). ``attention=True`` also plans K4 over
the same edge set, in that space
(:class:`grl_torch.ops.sparse_attention.SparseAttentionKernel`), which
``SparseNodeSelfAtten`` then routes through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from grl_torch.ops.csr_spmm import CSRGraphKernel
from grl_torch.ops.ell import ELLGraphKernel
from grl_torch.ops.sparse import RelationalGraph
from grl_torch.ops.sparse_attention import SparseAttentionKernel
from grl_torch.ops.tile import TileGraphKernel

SPARSE_KERNELS = {"ell": ELLGraphKernel, "pallas": ELLGraphKernel, "pallas_csr": CSRGraphKernel,
                  "tile": TileGraphKernel}


@dataclasses.dataclass(frozen=True)
class KernelAdjacency(RelationalGraph):
    """A :class:`RelationalGraph` with its planned kernels: ``kernel``
    (GraphConv's aggregation) and ``atten_kernel`` (SparseNodeSelfAtten)."""

    kernel: Any = None
    atten_kernel: Any = None


def attach_kernel(
    graph: RelationalGraph,
    impl: str = "ell",
    feature_dim: int = 256,
    attention: bool = False,
    **plan_kwargs: Any,
) -> Union[RelationalGraph, KernelAdjacency]:
    """Plan the kernels of a static graph (host side, once) on the graph's
    device (``kernels.py:50-129``). ``impl="xla"`` without attention
    returns the graph unchanged; ``impl="xla"`` with attention plans K4
    only. Unknown ``plan_kwargs`` raise ``TypeError`` for ``pallas_csr``
    and are ignored by ELL, as in ``grl_tpu``."""
    if impl == "xla" and not attention:
        return graph
    if impl != "xla" and impl not in SPARSE_KERNELS:
        raise ValueError(
            f"Unknown sparse kernel_impl {impl!r}; expected one of: xla, {', '.join(sorted(SPARSE_KERNELS))}"
        )
    mask = graph.mask.cpu().numpy()
    kernel = None
    if impl != "xla":
        weights = (graph.weights * graph.mask.to(graph.weights.dtype)).cpu().numpy()
        kernel = SPARSE_KERNELS[impl](
            graph.senders.cpu().numpy(), graph.receivers.cpu().numpy(),
            graph.relations.cpu().numpy(), weights,
            num_nodes=graph.num_nodes, num_relations=graph.num_relations,
            feature_dim=feature_dim, device=graph.device, **plan_kwargs,
        )
    fields = {f.name: getattr(graph, f.name) for f in dataclasses.fields(RelationalGraph)}
    node_perm = getattr(kernel, "node_perm", None)
    if node_perm is not None:
        # Every consumer of the adjacency (sparse attention, the COO path)
        # lives in the kernel's node space (kernels.py:89-101).
        perm = torch.from_numpy(node_perm).to(graph.device)
        fields["senders"] = perm[graph.senders.long()].to(torch.int32)
        fields["receivers"] = perm[graph.receivers.long()].to(torch.int32)
    atten_kernel = None
    if attention:
        # Planned after the aggregation kernel, in its node space.
        atten_kernel = SparseAttentionKernel(
            fields["senders"].cpu().numpy()[mask], fields["receivers"].cpu().numpy()[mask],
            num_nodes=graph.num_nodes, device=graph.device,
        )
    return KernelAdjacency(**fields, kernel=kernel, atten_kernel=atten_kernel)
