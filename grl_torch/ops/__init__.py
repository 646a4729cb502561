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

__all__ = [
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
]
