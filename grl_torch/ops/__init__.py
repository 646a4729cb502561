from grl_torch.ops.ell import (
    ELLGraphKernel,
    ell_accumulate,
    ell_accumulate_reference,
    ell_aggregate,
    ell_aggregate_projected,
)
from grl_torch.ops.relagg import (
    dropedge_aggregate,
    dropedge_aggregate_grad,
    dropedge_aggregate_grad_reference,
    dropedge_aggregate_reference,
    dropedge_keep_mask,
    neighbor_aggregate,
    neighbor_aggregate_reference,
)
from grl_torch.ops.relconv import (
    drop_edge,
    preprocess_adjacency,
    relational_aggregate,
    relational_aggregate_dense,
    relational_neighbor_aggregate,
)
from grl_torch.ops.segment import segment_softmax, segment_sum
from grl_torch.ops.sparse import (
    RelationalGraph,
    dense_to_relational_coo,
    relational_aggregate_coo,
    relational_neighbor_coo,
)

__all__ = [
    "ELLGraphKernel",
    "ell_accumulate",
    "ell_accumulate_reference",
    "ell_aggregate",
    "ell_aggregate_projected",
    "dropedge_aggregate",
    "dropedge_aggregate_grad",
    "dropedge_aggregate_grad_reference",
    "dropedge_aggregate_reference",
    "dropedge_keep_mask",
    "neighbor_aggregate",
    "neighbor_aggregate_reference",
    "drop_edge",
    "preprocess_adjacency",
    "relational_aggregate",
    "relational_aggregate_dense",
    "relational_neighbor_aggregate",
    "segment_softmax",
    "segment_sum",
    "RelationalGraph",
    "dense_to_relational_coo",
    "relational_aggregate_coo",
    "relational_neighbor_coo",
]
