from grl_torch.trainer.procedures.base_procedure import BaseProcedure, TrainState
from grl_torch.trainer.procedures.finetune_kv_procedure import (
    FinetuneKVProcedure,
    merge_matching_leaves,
)
from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure
from grl_torch.trainer.procedures.graph_classification_procedure import (
    GraphClassificationProcedure,
)
from grl_torch.trainer.procedures.joint_training_procedure import JointTrainingProcedure
from grl_torch.trainer.procedures.kv_procedure import KVProcedure
from grl_torch.trainer.procedures.sampled_graph_procedure import SampledGraphProcedure
from grl_torch.trainer.procedures.ssl_pretrain_procedure import SSLPretrainProcedure

__all__ = [
    "BaseProcedure",
    "FinetuneKVProcedure",
    "FullGraphProcedure",
    "GraphClassificationProcedure",
    "JointTrainingProcedure",
    "KVProcedure",
    "SampledGraphProcedure",
    "SSLPretrainProcedure",
    "TrainState",
    "merge_matching_leaves",
]
