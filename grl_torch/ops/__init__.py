from grl_torch.ops.relagg import neighbor_aggregate, neighbor_aggregate_reference
from grl_torch.ops.relconv import (
    preprocess_adjacency,
    relational_aggregate,
    relational_aggregate_dense,
    relational_neighbor_aggregate,
)

__all__ = [
    "neighbor_aggregate",
    "neighbor_aggregate_reference",
    "preprocess_adjacency",
    "relational_aggregate",
    "relational_aggregate_dense",
    "relational_neighbor_aggregate",
]
