"""Training: losses, metrics, schedules, optimizers and the procedures.

Counterpart of ``grl_tpu/trainer``. The procedure registry holds
``KVProcedure``, ``FullGraphProcedure``, ``SampledGraphProcedure`` and the
self-supervised family (``SSLPretrainProcedure``, ``FinetuneKVProcedure``,
``JointTrainingProcedure``, ``GraphClassificationProcedure``).
"""
from grl_torch.trainer import losses, lr_schedulers, metrics, optimizers, procedures
from grl_torch.trainer.procedures import (
    BaseProcedure,
    FullGraphProcedure,
    KVProcedure,
    SampledGraphProcedure,
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
    "SampledGraphProcedure",
    "TrainState",
]
