"""Sparse-kernel selection: plan a static graph onto a kernel.

Counterpart of ``grl_tpu/ops/kernels.py``. ``kernel_impl`` picks how the
sparse model aggregates neighbours:

* ``xla``        — gather + float32 segment sum
  (:func:`grl_torch.ops.sparse.relational_neighbor_coo`), plain PyTorch;
* ``pallas_csr`` — K5, the CSR edge walk with DropEdge fused
  (:class:`grl_torch.ops.csr_spmm.CSRGraphKernel`);
* ``ell`` (``grl_tpu``'s default, and what ``pallas`` means on the sparse
  path) and ``tile`` are the kernels K6 and K7, not ported yet: they raise
  ``NotImplementedError`` naming their ROADMAP items.

``attention=True`` also plans K4 over the same edge set
(:class:`grl_torch.ops.sparse_attention.SparseAttentionKernel`), which
``SparseNodeSelfAtten`` then routes through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

from grl_torch.ops.csr_spmm import CSRGraphKernel
from grl_torch.ops.sparse import RelationalGraph
from grl_torch.ops.sparse_attention import SparseAttentionKernel

SPARSE_KERNELS = {"pallas_csr": CSRGraphKernel}
NOT_PORTED = {
    "ell": "K6 (grl_tpu/ops/ell.py, the ELL gather tables), ROADMAP.md Queue 2",
    "pallas": "K6 (grl_tpu/ops/ell.py; 'pallas' on the sparse path is ELL), ROADMAP.md Queue 2",
    "tile": "K7 (grl_tpu/ops/tile.py, the tile-dense hybrid), ROADMAP.md Queue 2",
}


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
    only. Unknown ``plan_kwargs`` raise ``TypeError``, as in ``grl_tpu``."""
    if impl == "xla" and not attention:
        return graph
    if impl in NOT_PORTED:
        raise NotImplementedError(
            f"kernel_impl={impl!r} is {NOT_PORTED[impl]}; not ported yet. "
            "Use kernel_impl='pallas_csr' (K5) or 'xla'."
        )
    if impl != "xla" and impl not in SPARSE_KERNELS:
        raise ValueError(
            f"Unknown sparse kernel_impl {impl!r}; expected one of: xla, "
            f"{', '.join(sorted([*SPARSE_KERNELS, *NOT_PORTED]))}"
        )
    mask = graph.mask.cpu().numpy()
    senders = graph.senders.cpu().numpy()
    receivers = graph.receivers.cpu().numpy()
    kernel = None
    if impl != "xla":
        weights = (graph.weights * graph.mask.to(graph.weights.dtype)).cpu().numpy()
        kernel = SPARSE_KERNELS[impl](
            senders, receivers, graph.relations.cpu().numpy(), weights,
            num_nodes=graph.num_nodes, num_relations=graph.num_relations,
            feature_dim=feature_dim, device=graph.device, **plan_kwargs,
        )
    atten_kernel = None
    if attention:
        atten_kernel = SparseAttentionKernel(
            senders[mask], receivers[mask], num_nodes=graph.num_nodes, device=graph.device
        )
    fields = {f.name: getattr(graph, f.name) for f in dataclasses.fields(RelationalGraph)}
    return KernelAdjacency(**fields, kernel=kernel, atten_kernel=atten_kernel)
