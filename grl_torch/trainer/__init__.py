"""Training: losses, metrics, schedules, optimizers and the procedures.

Counterpart of ``grl_tpu/trainer``. The procedure registry holds
``KVProcedure`` and ``FullGraphProcedure``; the other procedures of
``grl_tpu`` (fine-tuning, self-supervised, joint, graph classification,
sampled) arrive with later slices of ROADMAP.md.
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
