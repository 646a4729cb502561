from grl_torch.trainer.procedures.base_procedure import BaseProcedure, TrainState
from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure
from grl_torch.trainer.procedures.kv_procedure import KVProcedure

__all__ = ["BaseProcedure", "FullGraphProcedure", "KVProcedure", "TrainState"]
