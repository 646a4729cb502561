"""Loss functions with ignore-index masking.

Counterparts of ``grl_tpu/trainer/losses.py`` (:20-129), written with
torch tensor ops. Masking semantics are the same: ``ignore_index=-100``
for CE/focal, ``target != -100`` masks for BCE/MSE, and every mean
divides by the summed weights of the kept targets (at least 1).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def _weights(targets: torch.Tensor, safe_targets: torch.Tensor, mask: torch.Tensor,
             weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return mask
    return weight.to(mask.device)[safe_targets] * mask


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Mean CE over non-ignored targets (torch CrossEntropyLoss semantics).

    logits ``(..., C)``, integer targets ``(...)``.
    """
    keep = targets != ignore_index
    mask = keep.to(logits.dtype)
    safe_targets = torch.where(keep, targets, 0).long()
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, safe_targets[..., None])[..., 0]
    w = _weights(targets, safe_targets, mask, weight)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def binary_cross_entropy_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-100-masked mean BCE-with-logits (``losses.py:41-56``)."""
    logits = logits.reshape(targets.shape)
    mask = (targets != IGNORE_INDEX).to(logits.dtype)
    safe = torch.where(mask > 0, targets.to(logits.dtype), 0.0)
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is not None:
        per = -(pos_weight.to(logits.device) * safe * log_p + (1.0 - safe) * log_not_p)
    else:
        per = -(safe * log_p + (1.0 - safe) * log_not_p)
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Multi-class focal loss (``losses.py:59-78``): NLL of
    ``(1 - p)^gamma * log p``."""
    keep = targets != ignore_index
    mask = keep.to(logits.dtype)
    safe_targets = torch.where(keep, targets, 0).long()
    logpt = F.log_softmax(logits, dim=-1)
    pt = torch.exp(logpt)
    focal = (1.0 - pt) ** gamma * logpt
    nll = -torch.gather(focal, -1, safe_targets[..., None])[..., 0]
    w = _weights(targets, safe_targets, mask, weight)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def masked_mse(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-100-masked MSE (``losses.py:81-85``)."""
    logits = logits.reshape(targets.shape)
    mask = (targets != IGNORE_INDEX).to(logits.dtype)
    diff = (logits - targets.to(logits.dtype)) * mask
    return torch.sum(diff**2) / torch.clamp(torch.sum(mask), min=1.0)


def _tensor(values: Optional[List[float]]) -> Optional[torch.Tensor]:
    return None if values is None else torch.as_tensor(values, dtype=torch.float32)


class BaseLoss:
    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseLoss":
        return cls(**dict(config or {}))

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class CrossEntropyLoss(BaseLoss):
    def __init__(self, weight: Optional[List[float]] = None):
        self.weight = _tensor(weight)

    def __call__(self, logits, targets):
        return cross_entropy(logits, targets, self.weight)


class BinaryCrossEntropyLoss(BaseLoss):
    def __init__(self, pos_weight: Optional[List[float]] = None):
        self.pos_weight = _tensor(pos_weight)

    def __call__(self, logits, targets):
        return binary_cross_entropy_with_logits(logits, targets, self.pos_weight)


class FocalLoss(BaseLoss):
    def __init__(self, gamma: float = 2.0, weight: Optional[List[float]] = None):
        self.gamma = gamma
        self.weight = _tensor(weight)

    def __call__(self, logits, targets):
        return focal_loss(logits, targets, self.gamma, self.weight)


class MSELoss(BaseLoss):
    def __call__(self, logits, targets):
        return masked_mse(logits, targets)


def denominator(criterion: "BaseLoss", targets: torch.Tensor) -> torch.Tensor:
    """What ``criterion``'s mean over ``targets`` divides by before its
    clamp at 1: the summed class weights of the kept targets for the
    weighted losses, their count otherwise. ``criterion * max(denominator,
    1)`` is then its sum, which data-parallel ranks add up
    (:class:`grl_torch.trainer.procedures.base_procedure.BaseProcedure`)."""
    keep = targets != IGNORE_INDEX
    weight = getattr(criterion, "weight", None)
    if weight is None:
        return keep.sum().to(torch.float32)
    safe = torch.where(keep, targets, 0).long()
    return (weight.to(targets.device)[safe] * keep).sum().to(torch.float32)
