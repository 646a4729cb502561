"""Learning-rate schedules + the RanPAC cosine lambda schedule.

A copy of ``grl_tpu/trainer/lr_schedulers.py`` (pure Python). Same
schedule surface as the reference (reference: gnn/trainer/
lr_schedulers/decay_lr.py:6-26, multi_step_lr.py:7-26, warmup_lr.py:4-27)
as pure ``(epoch, step) -> lr`` callables — applied by writing each
parameter group's ``lr`` once per epoch, as the reference's manual
``group["lr"]`` writes *after* each epoch's steps
(reference: base_procedure.py:172-185, kv_procedure.py:354).

``cosine_schedule_lambda`` reproduces the per-step RanPAC lambda schedule
(reference: kv_procedure.py:254-281).
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Any, Dict, List


class BaseLearningRate:
    lr: float

    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseLearningRate":
        return cls(**dict(config or {}))

    def _step_lr(self, epoch: int, step: int | None = None) -> float:
        raise NotImplementedError

    __call__ = _step_lr


class ConstantLearningRate(BaseLearningRate):
    def __init__(self, lr: float = 1e-3):
        self.lr = lr

    def _step_lr(self, epoch: int, step: int | None = None) -> float:
        return self.lr

    __call__ = _step_lr


class DecayLearningRate(BaseLearningRate):
    """Polynomial decay (reference: decay_lr.py:22-26)."""

    def __init__(self, lr: float = 0.002, factor: float = 0.9, num_epochs: int = 100):
        self.lr = self.initial_lr = lr
        self.factor = factor
        self.epochs = num_epochs

    def _step_lr(self, epoch: int, step: int | None = None) -> float:
        rate = (1.0 - epoch / float(self.epochs + 1)) ** self.factor
        self.lr = self.initial_lr * rate
        return self.lr

    __call__ = _step_lr


class MultiStepLearningRate(BaseLearningRate):
    """Gamma decay at milestones (reference: multi_step_lr.py:23-26)."""

    def __init__(self, lr: float = 0.001, gamma: float = 0.1, milestones: List[int] = ()):
        self.lr = self.initial_lr = lr
        self.gamma = gamma
        self.milestones = sorted(milestones)

    def _step_lr(self, epoch: int, step: int | None = None) -> float:
        self.lr = self.initial_lr * self.gamma ** bisect_right(self.milestones, epoch)
        return self.lr

    __call__ = _step_lr


class WarmupLearningRate(BaseLearningRate):
    """Low LR for the first ``steps`` of epoch 0 (reference: warmup_lr.py:21-27)."""

    def __init__(self, lr: float = 0.001, warmup_lr: float = 1e-5, steps: int = 4000):
        self.lr = self.initial_lr = lr
        self.steps = steps
        self.warmup_learning_rate = warmup_lr

    def _step_lr(self, epoch: int, step: int | None = None) -> float:
        if epoch == 0 and (step or 0) < self.steps:
            self.lr = self.warmup_learning_rate
        else:
            self.lr = self.initial_lr
        return self.lr

    __call__ = _step_lr


def cosine_schedule_lambda(
    step: int,
    total_steps: int,
    base_value: float = 1e-4,
    max_value: float = 1.0,
    warmup_steps: int = 0,
) -> float:
    """Linear warmup then cosine annealing (reference: kv_procedure.py:254-281)."""
    step = max(0, min(step, total_steps))
    warmup_steps = min(warmup_steps, total_steps)
    if step < warmup_steps:
        return base_value + (max_value - base_value) * (step / warmup_steps)
    progress = float(step - warmup_steps) / float(max(1, total_steps - warmup_steps))
    return base_value + 0.5 * (max_value - base_value) * (1 + math.cos(math.pi * progress))


def poly_schedule_lambda(
    init_value: float, epoch: int, num_epochs: int, factor: float = 0.9
) -> float:
    """(reference: kv_procedure.py:246-252)."""
    rate = (1.0 - epoch / float(num_epochs + 1)) ** factor
    return init_value * rate
