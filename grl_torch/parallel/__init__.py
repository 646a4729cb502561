"""Multi-device training: one process per device under ``torch.distributed``.

Counterpart of ``grl_tpu/parallel``: the process-group runtime
(:mod:`~grl_torch.parallel.distributed`), the ``data`` x ``model`` mesh and
tensor parallelism (:mod:`~grl_torch.parallel.mesh`), the node-partitioned
graph and its ring halo exchange (:mod:`~grl_torch.parallel.graph_partition`)
and node-partitioned training of the model family
(:mod:`~grl_torch.parallel.sharded_flagship`).
"""
from grl_torch.parallel.distributed import initialize_distributed
from grl_torch.parallel.graph_partition import (
    LocalShardGraph,
    PartitionedGraph,
    all_gather_relational_aggregate,
    local_shard_graph,
    partition_graph,
    partitioned_relational_aggregate,
)
from grl_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
)
from grl_torch.parallel.sharded_flagship import make_partitioned_model_step, pad_node_arrays

__all__ = [
    "initialize_distributed",
    "LocalShardGraph",
    "PartitionedGraph",
    "local_shard_graph",
    "make_partitioned_model_step",
    "pad_node_arrays",
    "all_gather_relational_aggregate",
    "partition_graph",
    "partitioned_relational_aggregate",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_params",
    "DEFAULT_TP_RULES",
]
