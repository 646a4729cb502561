"""Training: losses, metrics, schedules, optimizers and the procedures.

Counterpart of ``grl_tpu/trainer``. The procedure registry holds
``KVProcedure``, ``FullGraphProcedure`` and the self-supervised family
(``SSLPretrainProcedure``, ``FinetuneKVProcedure``,
``JointTrainingProcedure``, ``GraphClassificationProcedure``); the sampled
procedure arrives with a later slice of ROADMAP.md.
"""
from grl_torch.trainer import losses, lr_schedulers, metrics, optimizers, procedures
from grl_torch.trainer.procedures import (
    BaseProcedure,
    FullGraphProcedure,
    KVProcedure,
    TrainState,
)

__all__ = [
    "losses",
    "lr_schedulers",
    "metrics",
    "optimizers",
    "procedures",
    "BaseProcedure",
    "FullGraphProcedure",
    "KVProcedure",
    "TrainState",
]
