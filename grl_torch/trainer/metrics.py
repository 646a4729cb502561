"""Classification metrics: device-side confusion matrix + host macro scores.

Counterpart of ``grl_tpu/trainer/metrics.py`` (:23-86). Each step only
accumulates a ``C x C`` confusion matrix on the device (one scatter-add,
no host sync); macro precision/recall/F1 are computed from it on the host
with sklearn-identical semantics:

* entries whose target is the padding value or the configured "other"
  class are dropped;
* the macro average runs over the union of classes present in targets or
  predictions, ``zero_division=0``.

:func:`macro_scores` and :func:`per_class_report` are numpy copies.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def confusion_matrix(
    preds: torch.Tensor,
    targets: torch.Tensor,
    num_classes: int,
    ignore_values: Iterable[int] = (-100,),
) -> torch.Tensor:
    """Masked ``(C, C)`` float32 confusion counts ``cm[target, pred]``, on
    the tensors' device."""
    mask = torch.ones(targets.shape, dtype=torch.bool, device=targets.device)
    for value in ignore_values:
        if value is None:
            continue
        mask &= targets != value
    flat_t = torch.where(mask, targets, 0).reshape(-1).long()
    flat_p = preds.reshape(-1).long()
    cm = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=targets.device)
    cm.index_put_((flat_t * num_classes + flat_p,), mask.reshape(-1).float(), accumulate=True)
    return cm.reshape(num_classes, num_classes)


def macro_scores(cm: np.ndarray) -> Dict[str, float]:
    """sklearn ``classification_report``-style macro avg from a confusion
    matrix (zero_division=0, averaged over present classes)."""
    cm = np.asarray(cm, dtype=np.float64)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    present = np.nonzero((support > 0) | (predicted > 0))[0]
    if len(present) == 0:
        return {"precision": 0.0, "recall": 0.0, "f1-score": 0.0, "support": 0.0}
    tp = np.diag(cm)[present]
    precision = np.where(predicted[present] > 0, tp / np.maximum(predicted[present], 1e-12), 0.0)
    recall = np.where(support[present] > 0, tp / np.maximum(support[present], 1e-12), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    return {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": float(support[present].sum()),
    }


def per_class_report(
    cm: np.ndarray, class_names: Optional[Tuple[str, ...]] = None
) -> str:
    """Readable per-class P/R/F1 table (the epoch-level classification
    report)."""
    cm = np.asarray(cm, dtype=np.float64)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    present = np.nonzero((support > 0) | (predicted > 0))[0]
    lines = [f"{'class':<32}{'precision':>10}{'recall':>10}{'f1':>10}{'support':>10}"]
    for c in present:
        tp = cm[c, c]
        p = tp / predicted[c] if predicted[c] > 0 else 0.0
        r = tp / support[c] if support[c] > 0 else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        name = class_names[c] if class_names and c < len(class_names) else str(c)
        lines.append(f"{name:<32}{p:>10.4f}{r:>10.4f}{f1:>10.4f}{int(support[c]):>10}")
    macro = macro_scores(cm)
    lines.append(
        f"{'macro avg':<32}{macro['precision']:>10.4f}{macro['recall']:>10.4f}"
        f"{macro['f1-score']:>10.4f}{int(macro['support']):>10}"
    )
    return "\n".join(lines)
