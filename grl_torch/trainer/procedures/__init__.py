from grl_torch.trainer.procedures.base_procedure import BaseProcedure, TrainState
from grl_torch.trainer.procedures.kv_procedure import KVProcedure

__all__ = ["BaseProcedure", "KVProcedure", "TrainState"]
